"""NodeLoader / NeighborLoader — seed iteration and batch assembly (cf.
``glt_tpu/loader/node_loader.py``).

A numpy batcher over the seed ids; each batch is sampled, its features
and labels gathered on the graph's device, and assembled into a
:class:`~glt_tpu_torch.loader.transform.Batch`.  Batches are sampled one
at a time in order: ``glt_tpu``'s prefetch depth and its
construction-time autotune sweeps are not ported yet.

Occupancy-capped samplers flag the rare batch whose unique nodes exceed
the static buffer; with ``overflow_fallback`` (the default) such a batch
is re-sampled through the sampler's full-capacity twin, which costs one
device->host read of the flag per batch.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import Dataset
from ..sampler.base import NodeSamplerInput
from ..sampler.neighbor_sampler import NeighborSampler
from ..typing import PADDING_ID
from .transform import Batch, to_batch


class NodeLoader:
    """Iterate seed-node batches through a sampler into :class:`Batch` es.

    Args:
      data: the :class:`~glt_tpu_torch.data.dataset.Dataset`.
      node_sampler: a sampler exposing ``sample_from_nodes``.
      input_nodes: ``[num_seeds]`` global seed ids (host).
      batch_size: static batch width; the trailing partial batch is
        padded (never dropped) unless ``drop_last``.
      shuffle: reshuffle seeds each epoch (numpy generator from
        ``seed``).
      overflow_fallback: re-sample overflow-flagged batches at full
        capacity (counted in ``overflow_batches``).
    """

    def __init__(self, data: Dataset, node_sampler, input_nodes,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 overflow_fallback: bool = True):
        self.data = data
        self.sampler = node_sampler
        self.input_nodes = np.asarray(input_nodes).astype(np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._labels_dev: Optional[torch.Tensor] = None
        self.overflow_fallback = bool(overflow_fallback)
        self.overflow_batches = 0

    def __len__(self) -> int:
        n = self.input_nodes.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_seed_batches(self) -> Iterator[np.ndarray]:
        ids = self.input_nodes
        if self.shuffle:
            ids = ids[self._rng.permutation(ids.shape[0])]
        n = ids.shape[0]
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for lo in range(0, end, self.batch_size):
            yield ids[lo: lo + self.batch_size]

    def __iter__(self) -> Iterator[Batch]:
        for seeds in self._epoch_seed_batches():
            out = self.sampler.sample_from_nodes(NodeSamplerInput(seeds))
            out = self._maybe_refetch_overflow(out)
            yield self._collate_fn(out, seeds.shape[0])

    def _maybe_refetch_overflow(self, out):
        """Re-sample a flagged batch through the full-capacity twin.  Only
        the seeds carry over: the twin draws with its own key counter,
        so the batch is a new exact draw, not a replay."""
        if (not self.overflow_fallback
                or not getattr(self.sampler, "capped", False)
                or not out.metadata
                or not bool(out.metadata["overflow"])):
            return out
        self.overflow_batches += 1
        return self.sampler.full_capacity_sibling().sample_from_nodes(
            NodeSamplerInput(out.batch))

    def _collate_fn(self, out, num_seeds: int) -> Batch:
        x = None
        feat = self.data.get_node_feature()
        if feat is not None:
            x = feat.gather(out.node)
        y = None
        labels = self.data.get_node_label()
        if labels is not None:
            if self._labels_dev is None:
                self._labels_dev = torch.from_numpy(
                    np.asarray(labels).astype(np.int32)).to(out.node.device)
            safe = out.node.clamp(0, self._labels_dev.shape[0] - 1).long()
            y = torch.where(out.node >= 0, self._labels_dev[safe],
                            PADDING_ID)
        return to_batch(out, x=x, y=y, batch_size=num_seeds)


class NeighborLoader(NodeLoader):
    """Neighbor-sampling loader: builds its own
    :class:`~glt_tpu_torch.sampler.NeighborSampler` from
    ``num_neighbors`` unless one is supplied."""

    def __init__(self, data: Dataset, num_neighbors: Sequence[int],
                 input_nodes, batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False,
                 frontier_cap: Optional[int] = None, with_edge: bool = True,
                 seed: int = 0, sampler: Optional[NeighborSampler] = None,
                 last_hop_dedup: bool = True,
                 node_capacity: Optional[int] = None,
                 overflow_fallback: bool = True):
        if sampler is None:
            sampler = NeighborSampler(
                data.get_graph(), num_neighbors, batch_size=batch_size,
                frontier_cap=frontier_cap, with_edge=with_edge, seed=seed,
                last_hop_dedup=last_hop_dedup, node_capacity=node_capacity)
        super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                         shuffle=shuffle, drop_last=drop_last, seed=seed,
                         overflow_fallback=overflow_fallback)
