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
from .table_dataset import TableDataset
from .topology import CSRTopo
from .vineyard import (
    ArrowFragmentAdapter,
    MockFragment,
    connect_fragment,
    fragment_to_dataset,
    load_edge_features,
    load_vertex_features,
    to_csr,
)

__all__ = ["ArrowFragmentAdapter", "CSRTopo", "Dataset", "DatasetHandle",
           "Feature", "FeatureCacheState", "Graph", "MockFragment",
           "SharedArray", "TableDataset", "attach_dataset", "cache_gather",
           "cache_init", "cache_insert", "cache_lookup", "cache_stats",
           "connect_fragment", "fragment_to_dataset", "load_edge_features",
           "load_vertex_features", "share_dataset", "sort_by_in_degree",
           "to_csr"]
