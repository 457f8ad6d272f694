from .link_loader import LinkLoader, LinkNeighborLoader
from .node_loader import NeighborLoader, NodeLoader
from .subgraph_loader import SubGraphLoader
from .transform import Batch, as_pyg_v1_adjs, to_batch

__all__ = ["Batch", "LinkLoader", "LinkNeighborLoader", "NeighborLoader",
           "NodeLoader", "SubGraphLoader", "as_pyg_v1_adjs", "to_batch"]
