from .hetero_link_loader import HeteroLinkNeighborLoader
from .hetero_neighbor_loader import HeteroNeighborLoader
from .link_loader import LinkLoader, LinkNeighborLoader
from .node_loader import NeighborLoader, NodeLoader
from .subgraph_loader import SubGraphLoader
from .transform import (
    Batch,
    HeteroBatch,
    as_pyg_v1_adjs,
    to_batch,
    to_hetero_batch,
)

__all__ = ["Batch", "HeteroBatch", "HeteroLinkNeighborLoader",
           "HeteroNeighborLoader", "LinkLoader", "LinkNeighborLoader",
           "NeighborLoader", "NodeLoader", "SubGraphLoader",
           "as_pyg_v1_adjs", "to_batch", "to_hetero_batch"]
