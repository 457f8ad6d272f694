"""Hotness-aware frequency partitioner (cf.
``glt_tpu/partition/frequency_partitioner.py``).

Each training rank supplies a per-node access-probability vector (from
:meth:`~glt_tpu_torch.sampler.NeighborSampler.sample_prob` over its
seeds); node chunks go greedily to the partition where they are hottest
relative to the others, under a balance cap; each partition then
hot-caches its most frequently accessed *remote* nodes under a cache
budget.  Host numpy: the ``np.argsort`` calls here are not stable, so
the two packages take one path only by running the same numpy code.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .base import PartitionerBase


def residency_scores(probs: Sequence[np.ndarray],
                     normalize: bool = True) -> np.ndarray:
    """Collapse per-partition access-probability vectors into one global
    ``[num_nodes]`` float64 hotness score: a node's access probability
    summed over every rank that touches it, scaled to a max of 1.0 with
    ``normalize``."""
    if not probs:
        raise ValueError("residency_scores: need at least one "
                         "probability vector")
    score = np.zeros_like(np.asarray(probs[0], np.float64))
    for p in probs:
        p = np.asarray(p, np.float64)
        if p.shape != score.shape:
            raise ValueError(
                f"residency_scores: shape mismatch {p.shape} vs "
                f"{score.shape}")
        score += p
    if normalize:
        peak = score.max()
        if peak > 0:
            score /= peak
    return score


class FrequencyPartitioner(PartitionerBase):
    """Args beyond :class:`PartitionerBase`:

    probs: per-partition ``[num_nodes]`` access-probability vectors (one
      per training rank, ``len(probs) == num_parts``).
    cache_ratio: fraction of nodes each partition may hot-cache.
    balance_cap: max fraction above perfect balance a partition may own.
    """

    def __init__(self, *args, probs: Sequence[np.ndarray],
                 cache_ratio: float = 0.0, balance_cap: float = 1.05,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if len(probs) != self.num_parts:
            raise ValueError(f"need one probability vector per partition: "
                             f"{len(probs)} for {self.num_parts}")
        self.probs = [np.asarray(p, np.float64) for p in probs]
        self.cache_ratio = float(cache_ratio)
        self.balance_cap = float(balance_cap)

    def _partition_node(self) -> np.ndarray:
        n, k = self.num_nodes, self.num_parts
        cap = int(np.ceil(n / k * self.balance_cap))
        node_pb = np.full(n, -1, np.int32)
        counts = np.zeros(k, np.int64)

        for lo in range(0, n, self.chunk_size):
            hi = min(lo + self.chunk_size, n)
            # score[p] = own hotness * k - everyone's hotness
            chunk_probs = np.stack([p[lo:hi].sum() for p in self.probs])
            score = chunk_probs * k - chunk_probs.sum()
            order = np.argsort(-score)
            for p in order:
                if counts[p] + (hi - lo) <= cap:
                    node_pb[lo:hi] = p
                    counts[p] += hi - lo
                    break
            else:  # all at cap: least-loaded
                p = int(np.argmin(counts))
                node_pb[lo:hi] = p
                counts[p] += hi - lo
        return node_pb

    def _cache_node(self, node_pb: np.ndarray) -> List[np.ndarray]:
        budget = int(self.num_nodes * self.cache_ratio)
        out = []
        for p in range(self.num_parts):
            if budget == 0:
                out.append(np.empty(0, np.int64))
                continue
            prob = self.probs[p].copy()
            prob[node_pb == p] = -1.0  # only remote nodes are worth caching
            hot = np.argsort(-prob)[:budget]
            out.append(hot[prob[hot] > 0].astype(np.int64))
        return out
