"""Random node partitioner (cf. ``glt_tpu/partition/random_partitioner.py``)."""
from __future__ import annotations

import numpy as np

from .base import PartitionerBase


class RandomPartitioner(PartitionerBase):
    """Uniform random balanced assignment: shuffled ids round-robin."""

    def __init__(self, *args, seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.seed = seed

    def _partition_node(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(self.num_nodes)
        node_pb = np.empty(self.num_nodes, np.int32)
        node_pb[perm] = np.arange(self.num_nodes) % self.num_parts
        return node_pb
