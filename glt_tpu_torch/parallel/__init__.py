"""The distributed data plane over a mesh of shards (cf.
``glt_tpu/parallel``): sharded graph and features, the all-to-all
sampler (nodes, seed edges, induced subgraphs), the feature exchange
and its host tier, and the distributed train steps, over the shards
of a :class:`~glt_tpu_torch.parallel.multihost.Mesh`, a 1-D mesh or a
2-D ``(host, chip)`` one with the hierarchical route; heterogeneous
graphs across shards
(:class:`DistHeteroNeighborSampler`, the hetero distributed and tiered
steps).  A mesh may span processes (:mod:`.multihost`: ``initialize``,
``global_mesh``, ``global_mesh_2d`` and the per-process feeding
helpers), every exchange then crossing them over gloo."""
from . import multihost
from .dist_feature import (
    HostColdStore,
    TieredShardedFeature,
    cold_gather_host,
    cold_mask,
    compact_cold_requests,
    exchange_gather,
    exchange_gather_hot,
    exchange_gather_xy,
    merge_cold,
    route_cold_requests,
    shard_feature_tiered,
    shard_feature_tiered_from_store,
)
from .dist_hetero_sampler import DistHeteroNeighborSampler, shard_hetero_graph
from .dist_sampler import (
    DistNeighborSampler,
    HierarchicalRouting,
    Routing,
    bounded_remote_cap,
    build_hier_routing,
    build_routing,
    build_sorted_edge_view,
    dist_edge_exists,
    dist_node_subgraph,
    dist_sample_multi_hop,
    exchange_byte_model,
    exchange_one_hop,
    exchange_one_hop_ring,
    hier_request_cap,
)
from .dist_train import (
    HeteroTieredTrainPipeline,
    TieredTrainPipeline,
    dist_seed_blocks,
    dist_step_byte_model,
    init_dist_state,
    init_hetero_dist_state,
    make_dist_train_step,
    make_hetero_dist_train_step,
    make_hetero_tiered_train_step,
    make_scanned_dist_train_step,
    make_tiered_train_step,
    run_scanned_dist_epoch,
)
from .multihost import (Mesh, global_mesh, global_mesh_2d, mesh_axis_sizes,
                        resolve_mesh_axes)
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
    "DistHeteroNeighborSampler",
    "DistNeighborSampler",
    "HeteroTieredTrainPipeline",
    "HierarchicalRouting",
    "HostColdStore",
    "Mesh",
    "Routing",
    "ShardedFeature",
    "ShardedGraph",
    "TieredShardedFeature",
    "TieredTrainPipeline",
    "bounded_remote_cap",
    "build_hier_routing",
    "build_routing",
    "build_sorted_edge_view",
    "cold_gather_host",
    "cold_mask",
    "compact_cold_requests",
    "dist_edge_exists",
    "dist_node_subgraph",
    "dist_sample_multi_hop",
    "dist_seed_blocks",
    "dist_step_byte_model",
    "exchange_byte_model",
    "exchange_gather",
    "exchange_gather_hot",
    "exchange_gather_xy",
    "exchange_one_hop",
    "exchange_one_hop_ring",
    "global_mesh",
    "global_mesh_2d",
    "hier_request_cap",
    "init_dist_state",
    "init_hetero_dist_state",
    "make_dist_train_step",
    "make_hetero_dist_train_step",
    "make_hetero_tiered_train_step",
    "make_scanned_dist_train_step",
    "make_tiered_train_step",
    "merge_cold",
    "route_cold_requests",
    "mesh_axis_sizes",
    "multihost",
    "put_sharded",
    "resolve_mesh_axes",
    "run_scanned_dist_epoch",
    "shard_bounds",
    "shard_feature",
    "shard_feature_tiered",
    "shard_feature_tiered_from_store",
    "shard_graph",
    "shard_graph_blocks",
    "shard_hetero_graph",
]
