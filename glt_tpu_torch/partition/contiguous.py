"""Arbitrary partition books -> contiguous arithmetic sharding (cf.
``glt_tpu/partition/contiguous.py``).

Runtime routing stays **arithmetic** (``owner = id // nodes_per_shard``,
:mod:`glt_tpu_torch.parallel.sharding`) because ids are relabelled
offline so that each partition owns one contiguous, equal-width id
range: partition ``p``'s nodes become ``[p * c, p * c + |p|)`` with
``c`` the largest partition's size (tail slots unused).  The maps
translate seeds, labels and features; ``shard_graph``/``shard_feature``
then give blocks whose shard ``s`` is exactly partition ``s``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from ..data.topology import CSRTopo


class ContiguousRelabel(NamedTuple):
    old2new: np.ndarray       # [N_old] -> new id
    new2old: np.ndarray       # [num_parts * c] -> old id (-1 for unused)
    nodes_per_shard: int
    num_parts: int


def contiguous_relabel(node_pb: np.ndarray,
                       hotness: Optional[np.ndarray] = None,
                       num_parts: Optional[int] = None
                       ) -> ContiguousRelabel:
    """The relabelling of a dense node partition book.

    ``hotness`` (optional, ``[N]``) orders each partition's nodes
    hottest-first within its range (a stable sort, so ties keep id
    order), which puts the most-accessed rows in a shard's prefix.
    """
    node_pb = np.asarray(node_pb)
    n = node_pb.shape[0]
    if num_parts is None:
        # Derived from the book when not given; pass it explicitly when
        # trailing partitions may be empty.
        num_parts = int(node_pb.max()) + 1
    counts = np.bincount(node_pb, minlength=num_parts)
    c = int(counts.max())

    old2new = np.empty(n, np.int64)
    new2old = np.full(num_parts * c, -1, np.int64)
    for p in range(num_parts):
        own = np.where(node_pb == p)[0]
        if hotness is not None:
            own = own[np.argsort(-np.asarray(hotness)[own],
                                 kind="stable")]
        old2new[own] = p * c + np.arange(own.shape[0])
        new2old[p * c: p * c + own.shape[0]] = own
    return ContiguousRelabel(old2new, new2old, c, num_parts)


def relabel_topology(topo: CSRTopo, rel: ContiguousRelabel) -> CSRTopo:
    """Relabel a topology's node ids; edge ids are kept."""
    src, dst = topo.to_coo()
    new_n = rel.num_parts * rel.nodes_per_shard
    return CSRTopo(
        np.stack([rel.old2new[src], rel.old2new[dst]]),
        edge_ids=topo.edge_ids, num_nodes=new_n)


def relabel_rows(rows: np.ndarray, rel: ContiguousRelabel,
                 fill=0) -> np.ndarray:
    """Reorder a per-old-node row array into new-id order (``fill`` in
    the unused slots)."""
    rows = np.asarray(rows)
    out_shape = (rel.num_parts * rel.nodes_per_shard,) + rows.shape[1:]
    out = np.full(out_shape, fill, rows.dtype)
    valid = rel.new2old >= 0
    out[valid] = rows[rel.new2old[valid]]
    return out
