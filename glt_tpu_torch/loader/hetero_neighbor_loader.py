"""HeteroNeighborLoader — the heterogeneous neighbor-sampling loader (cf.
``glt_tpu/loader/hetero_neighbor_loader.py``).

A numpy batcher over ``(node_type, ids)`` seeds; each batch is sampled
by a :class:`~glt_tpu_torch.sampler.HeteroNeighborSampler`, each node
type's rows gathered by its ``Feature`` (kernel B2 on the card) and its
labels looked up, into a
:class:`~glt_tpu_torch.loader.transform.HeteroBatch`.  Up to
``prefetch`` samples are dispatched ahead of the batch being consumed,
in ``glt_tpu``'s order, so the sampler's keys advance the same way.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from ..data.dataset import Dataset
from ..sampler.base import NodeSamplerInput
from ..sampler.hetero_neighbor_sampler import HeteroNeighborSampler
from ..typing import NodeType, PADDING_ID
from .transform import HeteroBatch, to_hetero_batch


class HeteroNeighborLoader:
    """Iterate ``input_nodes = (node_type, ids)`` in batches through a
    hetero sampler (built from ``num_neighbors`` unless one is given).

    Args:
      data: a heterogeneous :class:`~glt_tpu_torch.data.Dataset`.
      batch_size: static seed width; the trailing partial batch is
        padded unless ``drop_last``.
      shuffle: reshuffle the seeds each epoch (numpy generator from
        ``seed``).
      prefetch: sampled batches kept in flight (at least 1).
    """

    def __init__(self, data: Dataset, num_neighbors, input_nodes,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, frontier_cap: Optional[int] = None,
                 prefetch: int = 2, seed: int = 0,
                 sampler: Optional[HeteroNeighborSampler] = None,
                 last_hop_dedup: bool = True):
        if not isinstance(input_nodes, tuple):
            raise ValueError(
                "input_nodes must be (node_type, ids) for hetero loading")
        input_type, seeds = input_nodes
        self.data = data
        self.input_type: NodeType = input_type
        self.input_nodes = np.asarray(seeds).astype(np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        self._rng = np.random.default_rng(seed)
        self._labels_dev = {}
        if sampler is None:
            sampler = HeteroNeighborSampler(
                data.graph, num_neighbors, input_type,
                batch_size=batch_size, frontier_cap=frontier_cap,
                seed=seed, last_hop_dedup=last_hop_dedup)
        self.sampler = sampler

    def __len__(self) -> int:
        n = self.input_nodes.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_seed_batches(self):
        ids = self.input_nodes
        if self.shuffle:
            ids = ids[self._rng.permutation(ids.shape[0])]
        n = ids.shape[0]
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for lo in range(0, end, self.batch_size):
            yield ids[lo: lo + self.batch_size]

    def _sample(self, seeds):
        return self.sampler.sample_from_nodes(
            NodeSamplerInput(seeds, self.input_type))

    def __iter__(self) -> Iterator[HeteroBatch]:
        pending = deque()
        batches = self._epoch_seed_batches()
        while True:
            while len(pending) < self.prefetch:
                seeds = next(batches, None)
                if seeds is None:
                    break
                pending.append((self._sample(seeds), seeds.shape[0]))
            if not pending:
                return
            out, nseeds = pending.popleft()
            yield self._collate_fn(out, nseeds)

    def _collate_fn(self, out, num_seeds: int) -> HeteroBatch:
        x = {}
        for t, node in out.node.items():
            feat = self.data.get_node_feature(t)
            if feat is not None:
                x[t] = feat.gather(node)
        y = None
        labels = self.data.node_labels
        if isinstance(labels, dict):
            y = {}
            for t, lab in labels.items():
                if t not in out.node:
                    continue
                node = out.node[t]
                if t not in self._labels_dev:
                    self._labels_dev[t] = torch.from_numpy(
                        np.asarray(lab).astype(np.int32)).to(node.device)
                table = self._labels_dev[t]
                safe = node.clamp(0, table.shape[0] - 1).long()
                y[t] = torch.where(node >= 0, table[safe], PADDING_ID)
        return to_hetero_batch(out, x=x, y=y, batch_size=num_seeds)
