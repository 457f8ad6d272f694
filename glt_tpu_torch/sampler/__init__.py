from .base import (
    EdgeSamplerInput,
    HeteroSamplerOutput,
    NegativeSampling,
    NodeSamplerInput,
    SamplerOutput,
)
from .hetero_neighbor_sampler import HeteroNeighborSampler, hetero_hop_widths
from .neighbor_sampler import (
    NeighborSampler,
    calibrate_node_capacity,
    hop_widths,
    max_sampled_nodes,
    measure_occupancy,
)

__all__ = ["EdgeSamplerInput", "HeteroNeighborSampler", "HeteroSamplerOutput",
           "NegativeSampling", "NeighborSampler", "NodeSamplerInput",
           "SamplerOutput", "calibrate_node_capacity", "hetero_hop_widths",
           "hop_widths", "max_sampled_nodes", "measure_occupancy"]
