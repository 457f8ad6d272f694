from .base import NodeSamplerInput, SamplerOutput
from .neighbor_sampler import (
    NeighborSampler,
    calibrate_node_capacity,
    hop_widths,
    max_sampled_nodes,
    measure_occupancy,
)

__all__ = ["NeighborSampler", "NodeSamplerInput", "SamplerOutput",
           "calibrate_node_capacity", "hop_widths", "max_sampled_nodes",
           "measure_occupancy"]
