from .node_loader import NeighborLoader, NodeLoader
from .transform import Batch, to_batch

__all__ = ["Batch", "NeighborLoader", "NodeLoader", "to_batch"]
