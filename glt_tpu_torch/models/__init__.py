from .conv import GATConv, SAGEConv, scatter_mean, scatter_sum, segment_softmax
from .convert import params_from_flax
from .gat import GAT
from .hgt import HGT, HGTConv
from .rgat import RGAT, HeteroConv
from .sage import GraphSAGE
from .train import (
    TrainState,
    adam,
    create_train_state,
    hetero_init_shapes,
    init_hetero_state,
    link_seed_blocks,
    make_cached_gather_xy,
    make_eval_step,
    make_gather_xy,
    make_scanned_hetero_train_step,
    make_scanned_link_train_step,
    make_scanned_node_train_step,
    make_scanned_subgraph_train_step,
    make_train_step,
    node_seed_blocks,
    run_scanned_epoch,
    seed_cross_entropy,
)

__all__ = ["GAT", "GATConv", "GraphSAGE", "HGT", "HGTConv", "HeteroConv",
           "RGAT", "SAGEConv", "TrainState", "adam", "create_train_state",
           "hetero_init_shapes", "init_hetero_state", "link_seed_blocks",
           "make_cached_gather_xy", "make_eval_step", "make_gather_xy",
           "make_scanned_hetero_train_step", "make_scanned_link_train_step",
           "make_scanned_node_train_step",
           "make_scanned_subgraph_train_step", "make_train_step",
           "node_seed_blocks", "params_from_flax", "run_scanned_epoch",
           "scatter_mean", "scatter_sum", "seed_cross_entropy",
           "segment_softmax"]
