"""SubGraphLoader — induced-subgraph batches (cf.
``glt_tpu/loader/subgraph_loader.py``).

Drives :meth:`~glt_tpu_torch.sampler.NeighborSampler.subgraph`: hop
expansion to collect a node set, then the subgraph it induces, with
``metadata["mapping"]`` locating the seeds in the batch.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

from ..data.dataset import Dataset
from ..sampler.base import NodeSamplerInput
from ..sampler.neighbor_sampler import NeighborSampler
from .node_loader import NodeLoader
from .transform import Batch


class SubGraphLoader(NodeLoader):
    """Iterate seed-node batches through ``subgraph``; ``prefetch`` is
    accepted for ``glt_tpu``'s signature (batches are sampled one at a
    time, in order)."""

    def __init__(self, data: Dataset, num_neighbors: Sequence[int],
                 input_nodes, batch_size: int = 64, max_degree: int = 64,
                 shuffle: bool = False, drop_last: bool = False,
                 prefetch: int = 2, seed: int = 0,
                 sampler: Optional[NeighborSampler] = None):
        if sampler is None:
            sampler = NeighborSampler(
                data.get_graph(), num_neighbors, batch_size=batch_size,
                seed=seed)
        super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                         shuffle=shuffle, drop_last=drop_last, seed=seed)
        self.max_degree = int(max_degree)

    def __iter__(self) -> Iterator[Batch]:
        for seeds in self._epoch_seed_batches():
            out = self.sampler.subgraph(NodeSamplerInput(seeds),
                                        max_degree=self.max_degree)
            yield self._collate_fn(out, seeds.shape[0])
