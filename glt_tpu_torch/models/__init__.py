from .conv import SAGEConv, scatter_mean, scatter_sum
from .convert import params_from_flax
from .sage import GraphSAGE

__all__ = ["GraphSAGE", "SAGEConv", "params_from_flax", "scatter_mean",
           "scatter_sum"]
