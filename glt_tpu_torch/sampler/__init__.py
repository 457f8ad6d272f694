from .base import (
    EdgeSamplerInput,
    NegativeSampling,
    NodeSamplerInput,
    SamplerOutput,
)
from .neighbor_sampler import (
    NeighborSampler,
    calibrate_node_capacity,
    hop_widths,
    max_sampled_nodes,
    measure_occupancy,
)

__all__ = ["EdgeSamplerInput", "NegativeSampling", "NeighborSampler",
           "NodeSamplerInput", "SamplerOutput", "calibrate_node_capacity",
           "hop_widths", "max_sampled_nodes", "measure_occupancy"]
