from .dataset import Dataset
from .feature import Feature
from .feature_cache import (
    FeatureCacheState,
    cache_gather,
    cache_init,
    cache_insert,
    cache_lookup,
    cache_stats,
)
from .graph import Graph
from .reorder import sort_by_in_degree
from .shared import DatasetHandle, SharedArray, attach_dataset, share_dataset
from .topology import CSRTopo

__all__ = ["CSRTopo", "Dataset", "DatasetHandle", "Feature",
           "FeatureCacheState", "Graph", "SharedArray", "attach_dataset",
           "cache_gather", "cache_init", "cache_insert", "cache_lookup",
           "cache_stats", "share_dataset", "sort_by_in_degree"]
