from .base import (
    BaseSampler,
    EdgeSamplerInput,
    HeteroSamplerOutput,
    NegativeSampling,
    NodeSamplerInput,
    SamplerOutput,
    SamplingConfig,
)
from .hetero_neighbor_sampler import (
    HeteroNeighborSampler,
    calibrate_frontier_widths,
    hetero_hop_widths,
    measure_levels,
)
from .neighbor_sampler import (
    NeighborSampler,
    HopPrefixes,
    calibrate_node_capacity,
    hop_prefixes,
    hop_widths,
    max_sampled_nodes,
    measure_occupancy,
)

__all__ = ["BaseSampler", "EdgeSamplerInput", "HeteroNeighborSampler",
           "HeteroSamplerOutput", "HopPrefixes", "NegativeSampling",
           "NeighborSampler", "NodeSamplerInput", "SamplerOutput",
           "SamplingConfig", "calibrate_frontier_widths",
           "calibrate_node_capacity", "hetero_hop_widths", "hop_prefixes",
           "hop_widths", "max_sampled_nodes", "measure_levels",
           "measure_occupancy"]
