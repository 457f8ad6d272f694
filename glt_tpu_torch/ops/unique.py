"""Static-shape, first-occurrence-order unique + dense induce (cf.
``glt_tpu/ops/unique.py``).

Unique ids come out in **first occurrence order**, so seeds placed at the
front of the input lead the output node list
(``node[:batch_size] == seeds``).  Negative ids are padding: they map to
inverse -1 and never appear among the uniques.

Scatter discipline: a CUDA scatter whose duplicate indices carry
*different* values is nondeterministic.  Every scatter here either
reduces with min/max (order-free), writes one value per index, writes
the same value to every duplicate, or writes into a dump slot whose
content is garbage by contract — the discipline of ``glt_tpu``'s
version, which makes the CPU and CUDA runs agree bit for bit.

The dense inducer updates its state tensors in place (``seen`` and
``node_buf`` are per-batch scratch) and returns the same state object's
tensors, where ``glt_tpu`` returns fresh arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device

_INT32_MAX = 2**31 - 1


class UniqueResult(NamedTuple):
    uniques: torch.Tensor  # [M] ids in first-occurrence order, -1 padded
    inverse: torch.Tensor  # [M] position of each id in `uniques` (-1 padding)
    count: torch.Tensor    # [] int32 number of valid uniques


def _i32(x: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=like.device)


def unique_first_occurrence(ids: torch.Tensor) -> UniqueResult:
    """Deduplicate ``ids`` ``[M]`` preserving first-occurrence order."""
    ids = ids.to(torch.int32)
    m = ids.shape[0]
    dev = ids.device
    if m == 0:
        return UniqueResult(ids.clone(), ids.clone(), _i32(0, ids))
    valid = ids >= 0
    keys = torch.where(valid, ids, _INT32_MAX)
    sorted_keys, perm = torch.sort(keys, stable=True)

    prev = torch.cat([torch.full((1,), -1, dtype=torch.int32, device=dev),
                      sorted_keys[:-1]])
    heads = (sorted_keys != prev) & (sorted_keys != _INT32_MAX)
    run_of_sorted = torch.cumsum(heads, 0, dtype=torch.int32) - 1
    count = heads.sum(dtype=torch.int32)

    # Head slots scatter their run's first position / id; everything
    # else lands in the dump slot m (min/max: order-free).
    scatter_idx = torch.where(heads, run_of_sorted, m).long()
    first_pos = torch.full((m + 1,), _INT32_MAX, dtype=torch.int32,
                           device=dev).scatter_reduce_(
        0, scatter_idx, perm.to(torch.int32), "amin")[:m]
    run_ids = torch.full((m + 1,), -1, dtype=torch.int32,
                         device=dev).scatter_reduce_(
        0, scatter_idx, sorted_keys, "amax")[:m]
    run_ids = torch.where(run_ids == _INT32_MAX, -1, run_ids)

    order = torch.sort(first_pos, stable=True).indices
    uniques = run_ids[order]
    arange = torch.arange(m, dtype=torch.int32, device=dev)
    # `order` and `perm` are permutations: one write per index.
    rank = torch.zeros(m, dtype=torch.int32, device=dev).scatter_(
        0, order, arange)
    inv_sorted = rank[run_of_sorted.clamp(0, m - 1).long()]
    inverse = torch.zeros(m, dtype=torch.int32, device=dev).scatter_(
        0, perm, inv_sorted)
    inverse = torch.where(valid, inverse, -1)
    return UniqueResult(uniques, inverse, count)


class DenseInduceState(NamedTuple):
    """Carry of the dense (scatter-based) incremental inducer.

    ``seen`` is a ``[num_nodes + 2]`` int32 map: 0 = unseen, else the
    committed encoding ``_LOCAL_BASE - local_id``.  Slot ``N`` absorbs
    padding reads; slot ``N + 1`` absorbs dump writes.  ``node_buf`` is
    the cumulative ``[capacity + 1]`` unique-node list (-1 padded; the
    last slot is the write dump), ``count`` the number of valid uniques.
    """
    seen: torch.Tensor
    node_buf: torch.Tensor
    count: torch.Tensor


def dense_map_fits(num_nodes: int, budget_bytes: int = 1 << 30) -> bool:
    """Whether a dense id->local map for ``num_nodes`` fits the budget."""
    return num_nodes * 4 <= budget_bytes


def dense_induce_init(num_nodes: int, capacity: int,
                      device: DeviceLike = None) -> DenseInduceState:
    """Fresh per-batch state on ``device`` (default ``"cuda"``; pass the
    graph's device)."""
    dev = resolve_device(device)
    return DenseInduceState(
        seen=torch.zeros(num_nodes + 2, dtype=torch.int32, device=dev),
        node_buf=torch.full((capacity + 1,), -1, dtype=torch.int32,
                            device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


# Encoded `seen` values: 0 = unseen; provisional in-batch markers live
# in (0, _PROV_BASE]; committed local ids in [_LOCAL_BASE - count,
# _LOCAL_BASE].  The committed band sits above the provisional band, so
# one scatter-MAX both detects first occurrences and keeps existing
# assignments.
_PROV_BASE = 1 << 25
_LOCAL_BASE = 1 << 30


def _provisional(state: DenseInduceState, cand: torch.Tensor):
    """Ops 1-2 shared by both inducers: scatter-max a provisional marker
    per candidate, read back the winner, number the first occurrences."""
    seen, node_buf, count = state
    n = seen.shape[0] - 2
    m = cand.shape[0]
    if m >= _PROV_BASE:
        raise ValueError(f"candidate width {m} exceeds the {_PROV_BASE} "
                         f"encoding band")
    cand = cand.to(torch.int32)
    valid = cand >= 0
    safe = torch.where(valid, cand, n).long()
    pos = torch.arange(m, dtype=torch.int32, device=cand.device)
    marker = torch.where(valid, _PROV_BASE - pos, 0)
    # Op 1 (scatter-max): order-free.
    seen.scatter_reduce_(0, torch.where(valid, safe, n + 1), marker, "amax")
    # Op 2 (gather): who won each id?
    won = seen[safe]
    is_first = valid & (won == marker)
    local_new = count + torch.cumsum(is_first, 0, dtype=torch.int32) - 1
    return cand, valid, safe, won, is_first, local_new


def _append(state: DenseInduceState, cand, is_first, local_new
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new ids into ``node_buf`` (non-first slots write -1 into
    the dump slot) and advance the count."""
    node_buf = state.node_buf
    dump = node_buf.shape[0] - 1
    slot = torch.where(is_first, local_new, dump).clamp(max=dump)
    node_buf.scatter_(0, slot.long(), torch.where(is_first, cand, -1))
    return node_buf, state.count + is_first.sum(dtype=torch.int32)


def dense_induce(state: DenseInduceState, cand: torch.Tensor
                 ) -> Tuple[DenseInduceState, torch.Tensor]:
    """Insert ``cand`` (negative = padding) into the cumulative unique
    list; return ``(state, local)`` with ``local[i]`` the compact index
    of ``cand[i]`` (-1 for padding).  New nodes receive consecutive
    local ids in first-occurrence order."""
    seen = state.seen
    n = seen.shape[0] - 2
    cand, valid, safe, _, is_first, local_new = _provisional(state, cand)
    # Op 3 (scatter): commit the new ids; ids are unique among is_first
    # slots and every other slot writes 0 into dump slot n + 1.
    seen.scatter_(0, torch.where(is_first, safe, n + 1),
                  torch.where(is_first, _LOCAL_BASE - local_new, 0))
    # Op 4 (gather): resolve every candidate through the committed map.
    local = torch.where(valid, _LOCAL_BASE - seen[safe], -1)
    node_buf, count = _append(state, cand, is_first, local_new)
    return DenseInduceState(seen, node_buf, count), local


def dense_induce_final(state: DenseInduceState, cand: torch.Tensor
                       ) -> Tuple[DenseInduceState, torch.Tensor]:
    """Last-hop :func:`dense_induce` without the commit scatter: losers
    of the provisional scatter-max resolve through the winner's fresh
    local id.  The returned ``state.seen`` still holds provisional
    markers and must not feed another induce call."""
    m = cand.shape[0]
    cand, valid, _, won, is_first, local_new = _provisional(state, cand)
    winner_pos = (_PROV_BASE - won).clamp(0, max(m - 1, 0)).long()
    local = torch.where(won > _PROV_BASE, _LOCAL_BASE - won,
                        local_new[winner_pos] if m else won)
    local = torch.where(valid, local, -1)
    node_buf, count = _append(state, cand, is_first, local_new)
    return DenseInduceState(state.seen, node_buf, count), local


def relabel_by_reference(reference_ids: torch.Tensor,
                         query_ids: torch.Tensor) -> torch.Tensor:
    """Map each ``query_id`` to its position in ``reference_ids``.

    ``reference_ids`` is a -1-padded first-occurrence-unique list (as
    :func:`unique_first_occurrence` gives); a valid query id that is not
    in it, and a padding query, map to -1.  A sort and a binary search,
    as ``glt_tpu``'s version.
    """
    m = reference_ids.shape[0]
    ref = reference_ids.to(torch.int32)
    q_ids = query_ids.to(torch.int32)
    if m == 0:
        return torch.full_like(q_ids, -1)
    ref_keys = torch.where(ref >= 0, ref, _INT32_MAX)
    sorted_ref, order = torch.sort(ref_keys, stable=True)
    q = torch.where(q_ids >= 0, q_ids, _INT32_MAX - 1)
    pos = torch.searchsorted(sorted_ref, q).clamp(0, m - 1)
    hit = sorted_ref[pos] == q
    local = torch.where(hit, order[pos].to(torch.int32), -1)
    return torch.where(q_ids >= 0, local, -1).to(torch.int32)
