"""The distributed data plane over a mesh of shards (cf.
``glt_tpu/parallel``): sharded graph and features, the all-to-all
sampler, the feature exchange and the distributed train step, with the
shards of one :class:`~glt_tpu_torch.parallel.multihost.Mesh` in this
process (see :mod:`.multihost` for what waits for a machine with more
than one card)."""
from . import multihost
from .dist_feature import exchange_gather, exchange_gather_xy
from .dist_sampler import (
    DistNeighborSampler,
    Routing,
    bounded_remote_cap,
    build_routing,
    dist_sample_multi_hop,
    exchange_byte_model,
    exchange_one_hop,
)
from .dist_train import (
    dist_seed_blocks,
    dist_step_byte_model,
    init_dist_state,
    make_dist_train_step,
    make_scanned_dist_train_step,
    run_scanned_dist_epoch,
)
from .multihost import Mesh, mesh_axis_sizes, resolve_mesh_axes
from .sharding import (
    ShardedFeature,
    ShardedGraph,
    put_sharded,
    shard_bounds,
    shard_feature,
    shard_graph,
    shard_graph_blocks,
)

__all__ = [
    "DistNeighborSampler",
    "Mesh",
    "Routing",
    "ShardedFeature",
    "ShardedGraph",
    "bounded_remote_cap",
    "build_routing",
    "dist_sample_multi_hop",
    "dist_seed_blocks",
    "dist_step_byte_model",
    "exchange_byte_model",
    "exchange_gather",
    "exchange_gather_xy",
    "exchange_one_hop",
    "init_dist_state",
    "make_dist_train_step",
    "make_scanned_dist_train_step",
    "mesh_axis_sizes",
    "multihost",
    "put_sharded",
    "resolve_mesh_axes",
    "run_scanned_dist_epoch",
    "shard_bounds",
    "shard_feature",
    "shard_graph",
    "shard_graph_blocks",
]
