from .base import NodeSamplerInput, SamplerOutput
from .neighbor_sampler import NeighborSampler, hop_widths, max_sampled_nodes

__all__ = ["NeighborSampler", "NodeSamplerInput", "SamplerOutput",
           "hop_widths", "max_sampled_nodes"]
