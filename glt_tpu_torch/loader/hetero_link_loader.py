"""HeteroLinkNeighborLoader — seed edges of one edge type through
:meth:`~glt_tpu_torch.sampler.HeteroNeighborSampler.sample_from_edges`
(cf. ``glt_tpu/loader/hetero_link_loader.py``).

Each batch carries the sampler's metadata: the local
``edge_label_index`` and ``edge_label``, or the triplet indices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.dataset import Dataset
from ..sampler.base import EdgeSamplerInput, NegativeSampling
from ..sampler.hetero_neighbor_sampler import HeteroNeighborSampler
from ..typing import EdgeType
from .hetero_neighbor_loader import HeteroNeighborLoader


class HeteroLinkNeighborLoader(HeteroNeighborLoader):
    """``edge_label_index = (edge_type, [2, E] ids)``; batches of seed
    edges (their positions shuffled with ``shuffle``) and their
    negatives per ``neg_sampling``."""

    def __init__(self, data: Dataset, num_neighbors, edge_label_index,
                 edge_label: Optional[np.ndarray] = None,
                 neg_sampling: Optional[NegativeSampling] = None,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, frontier_cap: Optional[int] = None,
                 prefetch: int = 2, seed: int = 0):
        edge_type, eli = edge_label_index
        eli = np.asarray(eli)
        sampler = HeteroNeighborSampler(
            data.graph, num_neighbors, edge_type[0],
            batch_size=batch_size, frontier_cap=frontier_cap, seed=seed)
        super().__init__(data, num_neighbors,
                         (edge_type[0], np.arange(eli.shape[1])),
                         batch_size=batch_size, shuffle=shuffle,
                         drop_last=drop_last, prefetch=prefetch, seed=seed,
                         sampler=sampler)
        self.edge_type: EdgeType = edge_type
        self.edge_label_index = eli
        self.edge_label = (None if edge_label is None
                           else np.asarray(edge_label))
        self.neg_sampling = neg_sampling

    def _sample(self, pos):
        """``pos``: a batch of seed-edge positions."""
        return self.sampler.sample_from_edges(EdgeSamplerInput(
            row=self.edge_label_index[0, pos],
            col=self.edge_label_index[1, pos],
            label=None if self.edge_label is None else self.edge_label[pos],
            input_type=self.edge_type, neg_sampling=self.neg_sampling))
