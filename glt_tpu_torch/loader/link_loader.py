"""LinkLoader / LinkNeighborLoader — seed-edge loaders for link
prediction (cf. ``glt_tpu/loader/link_loader.py``).

Seed edges drive ``sample_from_edges`` with optional binary or triplet
negative sampling; each batch carries the sampler's metadata
(``edge_label_index`` / ``edge_label`` or the triplet indices, and
``num_pos``).  Batches are sampled in order, one sample call per batch,
so the keys are drawn in ``glt_tpu``'s order whatever ``prefetch`` is.
There is no overflow re-fetch on this path: the seed union runs at its
own width's full capacity.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from ..data.dataset import Dataset
from ..sampler.base import EdgeSamplerInput, NegativeSampling
from ..sampler.neighbor_sampler import NeighborSampler
from .node_loader import NodeLoader
from .transform import Batch


class LinkLoader(NodeLoader):
    """Iterate seed-edge batches through ``sample_from_edges``.

    Args:
      edge_label_index: ``[2, num_edges]`` seed edges (global ids).
      edge_label: optional labels per seed edge.
      neg_sampling: :class:`~glt_tpu_torch.sampler.NegativeSampling` or
        None.
      prefetch: accepted for ``glt_tpu``'s signature; batches are
        sampled one at a time.
    """

    def __init__(self, data: Dataset, link_sampler, edge_label_index,
                 edge_label=None,
                 neg_sampling: Optional[NegativeSampling] = None,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, prefetch: int = 2, seed: int = 0):
        eli = np.asarray(edge_label_index)
        super().__init__(data, link_sampler, np.arange(eli.shape[1]),
                         batch_size=batch_size, shuffle=shuffle,
                         drop_last=drop_last, seed=seed)
        self.edge_label_index = eli
        self.edge_label = (None if edge_label is None
                           else np.asarray(edge_label))
        self.neg_sampling = neg_sampling

    def __iter__(self) -> Iterator[Batch]:
        for pos in self._epoch_seed_batches():     # edge positions
            inp = EdgeSamplerInput(
                row=self.edge_label_index[0, pos],
                col=self.edge_label_index[1, pos],
                label=None if self.edge_label is None
                else self.edge_label[pos],
                neg_sampling=self.neg_sampling)
            out = self.sampler.sample_from_edges(inp)
            yield self._collate_fn(out, pos.shape[0])


class LinkNeighborLoader(LinkLoader):
    """Link loader that builds its own
    :class:`~glt_tpu_torch.sampler.NeighborSampler` from
    ``num_neighbors``."""

    def __init__(self, data: Dataset, num_neighbors: Sequence[int],
                 edge_label_index, edge_label=None,
                 neg_sampling: Optional[NegativeSampling] = None,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False,
                 frontier_cap: Optional[int] = None, prefetch: int = 2,
                 seed: int = 0):
        sampler = NeighborSampler(
            data.get_graph(), num_neighbors, batch_size=batch_size,
            frontier_cap=frontier_cap, seed=seed)
        super().__init__(data, sampler, edge_label_index,
                         edge_label=edge_label, neg_sampling=neg_sampling,
                         batch_size=batch_size, shuffle=shuffle,
                         drop_last=drop_last, prefetch=prefetch, seed=seed)
        self.num_neighbors = list(num_neighbors)
