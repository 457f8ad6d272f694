"""NodeLoader / NeighborLoader — seed iteration and batch assembly (cf.
``glt_tpu/loader/node_loader.py``).

A numpy batcher over the seed ids; each batch is sampled, its features
and labels gathered on the graph's device, and assembled into a
:class:`~glt_tpu_torch.loader.transform.Batch`.  Up to ``prefetch``
samples are dispatched ahead of the batch being consumed, in
``glt_tpu``'s order (so the sampler's key counter advances the same
way at every depth): the card queues them without the host waiting.
``glt_tpu``'s construction-time autotune sweeps are not ported yet.

Occupancy-capped samplers flag the rare batch whose unique nodes exceed
the static buffer; with ``overflow_fallback`` (the default) such a batch
is re-sampled through the sampler's full-capacity twin.  The flag's
device->host copy starts when the batch is dispatched (into pinned
memory, behind an event) and is read when the batch is popped, so the
check does not stall the queue.

``state_dict``/``load_state_dict`` carry the epoch cursor and the
shuffle stream (``glt_tpu``'s dict, key for key).
"""
from __future__ import annotations

from collections import deque
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..ckpt.state import capture_rng, load_rng
from ..data.dataset import Dataset
from ..sampler.base import NodeSamplerInput
from ..sampler.neighbor_sampler import NeighborSampler
from ..typing import PADDING_ID
from .transform import Batch, as_pyg_v1_adjs, to_batch


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
      prefetch: how many sampled batches to keep in flight (at least 1).
      overflow_fallback: re-sample overflow-flagged batches at full
        capacity (counted in ``overflow_batches``).
    """

    def __init__(self, data: Dataset, node_sampler, input_nodes,
                 batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False, prefetch: int = 2, seed: int = 0,
                 overflow_fallback: bool = True):
        self.data = data
        self.sampler = node_sampler
        self.input_nodes = np.asarray(input_nodes).astype(np.int64)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(1, int(prefetch))
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self._labels_dev: Optional[torch.Tensor] = None
        self.overflow_fallback = bool(overflow_fallback)
        self.overflow_batches = 0

    def __len__(self) -> int:
        n = self.input_nodes.shape[0]
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- cursor: the epoch count and the shuffle stream ---------------------
    def state_dict(self) -> dict:
        """Epoch cursor and shuffle-rng state.  Loaded into a loader
        built alike (same seeds, same config), it makes that loader's
        NEXT epoch draw the same shuffle order as this one's would."""
        return {
            "epoch": int(self._epoch),
            "rng": capture_rng(self._rng),
            "overflow_batches": int(self.overflow_batches),
        }

    def load_state_dict(self, state: dict) -> None:
        load_rng(self._rng, state["rng"])
        self._epoch = int(state["epoch"])
        self.overflow_batches = int(state.get("overflow_batches", 0))

    def _epoch_seed_batches(self) -> Iterator[np.ndarray]:
        ids = self.input_nodes
        if self.shuffle:
            ids = ids[self._rng.permutation(ids.shape[0])]
        n = ids.shape[0]
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for lo in range(0, end, self.batch_size):
            yield ids[lo: lo + self.batch_size]

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        pending = deque()
        batches = self._epoch_seed_batches()
        feat = self.data.get_node_feature()
        while True:
            while len(pending) < self.prefetch:
                seeds = next(batches, None)
                if seeds is None:
                    break
                if feat is not None:
                    # A hint to a store-backed feature's DRAM stager; a
                    # no-op for resident features.
                    feat.stage_ahead(seeds)
                out = self.sampler.sample_from_nodes(NodeSamplerInput(seeds))
                pending.append((out, self._prime_overflow_flag(out),
                                seeds.shape[0]))
            if not pending:
                return
            out, flag, num_seeds = pending.popleft()
            out = self._maybe_refetch_overflow(out, flag)
            yield self._collate_fn(out, num_seeds)

    def _prime_overflow_flag(self, out):
        """Start the overflow flag's copy to the host: ``(host flag,
        event)`` (no event for a CPU flag), or ``None`` when the
        fallback is off or the sampler is uncapped."""
        if (not self.overflow_fallback
                or not getattr(self.sampler, "capped", False)
                or not out.metadata):
            return None
        flag = out.metadata["overflow"]
        if not flag.is_cuda:
            return flag, None
        host = flag.to("cpu", non_blocking=True)   # pinned
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(flag.device))
        return host, done

    def _maybe_refetch_overflow(self, out, primed):
        """Re-sample a flagged batch through the full-capacity twin.  Only
        the seeds carry over: the twin draws with its own key counter,
        so the batch is a new exact draw, not a replay."""
        if primed is None:
            return out
        flag, done = primed
        if done is not None:
            done.synchronize()
        if not bool(flag):
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
    ``num_neighbors`` unless one is supplied.  With ``as_pyg_v1`` it
    yields PyG v1's layered ``(batch_size, n_id, adjs)`` triples
    (:func:`~glt_tpu_torch.loader.transform.as_pyg_v1_adjs`)."""

    def __init__(self, data: Dataset, num_neighbors: Sequence[int],
                 input_nodes, batch_size: int = 512, shuffle: bool = False,
                 drop_last: bool = False,
                 frontier_cap: Optional[int] = None, with_edge: bool = True,
                 prefetch: int = 2, seed: int = 0,
                 sampler: Optional[NeighborSampler] = None,
                 as_pyg_v1: bool = False, last_hop_dedup: bool = True,
                 node_capacity: Optional[int] = None,
                 overflow_fallback: bool = True):
        if sampler is None:
            sampler = NeighborSampler(
                data.get_graph(), num_neighbors, batch_size=batch_size,
                frontier_cap=frontier_cap, with_edge=with_edge, seed=seed,
                last_hop_dedup=last_hop_dedup, node_capacity=node_capacity)
        super().__init__(data, sampler, input_nodes, batch_size=batch_size,
                         shuffle=shuffle, drop_last=drop_last,
                         prefetch=prefetch, seed=seed,
                         overflow_fallback=overflow_fallback)
        self.num_neighbors = list(num_neighbors)
        self.frontier_cap = frontier_cap
        self.as_pyg_v1 = bool(as_pyg_v1)

    def __iter__(self):
        if not self.as_pyg_v1:
            yield from super().__iter__()
            return
        for batch in super().__iter__():
            # The hop widths follow the loader's static batch width, not
            # the (possibly smaller) trailing batch's seed count.
            yield as_pyg_v1_adjs(batch, self.batch_size, self.num_neighbors,
                                 self.frontier_cap)
