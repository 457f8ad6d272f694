"""Hotness reordering for the tiered feature store (cf.
``glt_tpu/data/reorder.py``).

Feature rows are reordered hottest-first (hotness = in-degree, i.e. how
often a node appears as a sampled neighbor) so that a ``split_ratio``
prefix is the device-resident hot tier.  Returns the ``id2index``
indirection that the feature store applies on every lookup.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .topology import CSRTopo


def sort_by_in_degree(
    feature: np.ndarray,
    split_ratio: float,
    topo: CSRTopo,
    shuffle_ratio: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reorder ``feature`` rows by descending in-degree.

    Args:
      feature: ``[N, d]`` row-per-node features.
      split_ratio: fraction of rows that will live in the device (hot) tier —
        only used to scope the optional shuffle.
      topo: topology whose in-degrees define hotness.
      shuffle_ratio: optionally shuffle this fraction of the hot prefix to
        de-bias benchmarks.

    Returns:
      ``(reordered_feature, id2index)`` where ``id2index[global_id]`` is the
      row of that node in the reordered matrix.
    """
    n = feature.shape[0]
    deg = topo.in_degrees()
    if deg.shape[0] < n:
        deg = np.pad(deg, (0, n - deg.shape[0]))
    order = np.argsort(-deg[:n], kind="stable")  # hottest first
    if shuffle_ratio > 0:
        rng = rng or np.random.default_rng(0)
        limit = int(n * min(split_ratio + shuffle_ratio, 1.0))
        head = order[:limit].copy()
        rng.shuffle(head)
        order = np.concatenate([head, order[limit:]])
    id2index = np.empty(n, np.int32)
    id2index[order] = np.arange(n, dtype=np.int32)
    return np.ascontiguousarray(feature[order]), id2index
