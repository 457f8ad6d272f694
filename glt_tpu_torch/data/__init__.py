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
from .topology import CSRTopo

__all__ = ["CSRTopo", "Dataset", "Feature", "FeatureCacheState", "Graph",
           "cache_gather", "cache_init", "cache_insert", "cache_lookup",
           "cache_stats", "sort_by_in_degree"]
