"""Distributed feature lookup: the all-to-all row exchange over a mesh
of shards (cf. ``glt_tpu/parallel/dist_feature.py``, without the host
tiers).

A lookup is one collective round trip: bucket the ids by owner shard (a
:func:`~glt_tpu_torch.parallel.dist_sampler.build_routing` plan,
reusable across exchanges), send the id buckets to their owners, let
every shard gather the rows requested from it, send the row blocks back
and read each id's row out of its slot.  :func:`exchange_gather_xy`
carries the feature AND label lookup of a frontier in one such round
trip: the int32 label column is reinterpreted (``Tensor.view``, not a
cast) as one more f32 payload column, so every label value comes back
bit for bit.

Like :mod:`.dist_sampler`, the functions take per-shard sequences and
run each stage for every shard in turn.  With ``fused_frontier`` a
shard serves the requests that landed on it through kernel B3 on the
card (:func:`~glt_tpu_torch.ops.fused_frontier.fused_frontier`): the
request list repeats hub rows across the requesting shards, and B3
reads each distinct row once.  Without it the serve is a plain masked
index.

The tiered feature (``TieredShardedFeature``, the cold stage,
``exchange_gather_hot``) is left for a later slice (ROADMAP queue A
item 7).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..ops.fused_frontier import fused_frontier as _fused_frontier
from ..ops.unique import unique_first_occurrence
from .dist_sampler import (Routing, _all_to_all, _shards, _use_fused,
                           build_routing)


def _dedup_scatter_back(urows: torch.Tensor, inv: torch.Tensor
                        ) -> torch.Tensor:
    """Expand unique-id rows back to every original position (zeros at
    padding)."""
    out = urows[inv.clamp(0, inv.shape[0] - 1).long()]
    return torch.where((inv >= 0)[:, None], out, 0)


def _dedup_scatter_back_1d(uvals: torch.Tensor, inv: torch.Tensor
                           ) -> torch.Tensor:
    """1-D form of :func:`_dedup_scatter_back` (label columns)."""
    out = uvals[inv.clamp(0, inv.shape[0] - 1).long()]
    return torch.where(inv >= 0, out, 0)


def _request_rows(rows: torch.Tensor, local: torch.Tensor, ok: torch.Tensor,
                  fused_frontier: bool) -> torch.Tensor:
    """The serving side of every exchange: one shard's rows for the id
    requests that landed on it (zeros where ``ok`` is False).

    ``fused_frontier`` serves them through the dedup+gather of
    :func:`~glt_tpu_torch.ops.fused_frontier.fused_frontier` (kernel B3
    on a CUDA table), equal to the masked index bit for bit: a valid
    ``local`` needs no clamp, and the invalid positions go in as -1,
    which the kernel zeroes.
    """
    if fused_frontier:
        return _fused_frontier(rows, torch.where(ok, local, -1)).features
    idx = torch.where(ok, local, 0).clamp(0, rows.shape[0] - 1).long()
    return torch.where(ok[:, None], rows[idx], 0)


def _exchange_ids(routing: Sequence[Routing]) -> List[torch.Tensor]:
    """The id request all-to-all of every exchange: row q of shard s's
    result holds the ids shard q wants from s."""
    return _all_to_all([r.buckets for r in routing])


def _resolve_plan(ids, nodes_per_shard: int, num_shards: int, routing,
                  route: str):
    """Shared prologue of every feature exchange: each shard's routing
    plan (built here unless the caller passes shared ones) and the
    id-request leg.  Returns ``(routing, requests)``, per shard."""
    if routing is None:
        routing = [build_routing(i, nodes_per_shard, num_shards,
                                 route=route) for i in ids]
    return routing, _exchange_ids(routing)


def _return_payload(payload: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Response leg of every feature exchange: each request slot's
    ``[w]`` payload back to its requester, in flat bucket order."""
    return _all_to_all(payload)


def _served_ids(requests: torch.Tensor, shard: int, nodes_per_shard: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local row, ok)`` of the requests that landed on ``shard``."""
    local = requests - shard * nodes_per_shard
    ok = (local >= 0) & (local < nodes_per_shard) & (requests >= 0)
    return local, ok


def _read_slots(resp: torch.Tensor, plan: Routing, b: int,
                num_shards: int) -> torch.Tensor:
    """Each input id's row out of its response slot (zeros where the
    plan marks it invalid)."""
    slot = plan.slot.clamp(0, num_shards * b - 1).long()
    valid = plan.valid if resp.dim() == 1 else plan.valid[:, None]
    return torch.where(valid, resp[slot], 0)


def exchange_gather(
    ids: Sequence[torch.Tensor],
    rows: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    dedup: bool = False,
    routing: Optional[Sequence[Routing]] = None,
    route: str = "auto",
    fused_frontier: bool = False,
) -> List[torch.Tensor]:
    """Feature rows for every shard's global ``ids``, across shards.

    Args:
      ids: per shard, ``[B]`` global node ids (-1 padded -> zero rows).
      rows: per shard, its ``[nodes_per_shard, d]`` feature block (the
        rows of a :class:`~glt_tpu_torch.parallel.sharding.ShardedFeature`).
      dedup: route each shard's UNIQUE ids through the exchange and
        expand the rows back to every position; the result is the
        same bit for bit.
      routing: per shard, a pre-built plan for ``ids`` (ignored under
        ``dedup``, whose plan is over the unique list).
      fused_frontier: serve through kernel B3 (see :func:`_request_rows`).

    Returns, per shard, ``[B, d]`` rows in input order.
    """
    S, c = num_shards, nodes_per_shard
    ids, rows = _shards(ids, S), _shards(rows, S)
    if dedup:
        un = [unique_first_occurrence(i) for i in ids]
        urows = exchange_gather([u.uniques for u in un], rows, c, S,
                                route=route, fused_frontier=fused_frontier)
        return [_dedup_scatter_back(r, u.inverse)
                for r, u in zip(urows, un)]
    b = ids[0].shape[0]
    routing, requests = _resolve_plan(ids, c, S, routing, route)
    got = []
    for s in range(S):
        local, ok = _served_ids(requests[s], s, c)
        got.append(_request_rows(rows[s], local, ok, fused_frontier))
    resp = _return_payload(got)
    return [_read_slots(resp[s], routing[s], b, S) for s in range(S)]


def exchange_gather_xy(
    ids: Sequence[torch.Tensor],
    rows: Sequence[torch.Tensor],
    labels_col: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    dedup: bool = False,
    routing: Optional[Sequence[Routing]] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    fused_frontier: bool = False,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Feature AND label gather of every shard's frontier in one
    exchange: one routing plan, one id all-to-all and one payload
    all-to-all.  The serving shard's int32 label column is reinterpreted
    as an f32 payload column beside the feature rows and reinterpreted
    back on the requester, so the round trip is exact for every label.

    Args:
      ids: per shard, ``[B]`` global node ids (-1 padded -> zero rows
        and labels).
      rows: per shard, its ``[nodes_per_shard, d]`` feature block.
      labels_col: per shard, its ``[nodes_per_shard]`` label column.
      dedup: unique ids ride the exchange once (see :func:`exchange_gather`).
      fused: one payload collective for rows and labels (default); off,
        the labels ride a second one.  The single payload also needs an
        f32 feature block (the bitcast target); other dtypes take two.
      fused_frontier: serve the feature rows through kernel B3.

    Returns, per shard, ``(x [B, d], y [B] int32)`` in input order (zeros
    at invalid slots).
    """
    S, c = num_shards, nodes_per_shard
    ids, rows = _shards(ids, S), _shards(rows, S)
    labels_col = _shards(labels_col, S)
    if dedup:
        un = [unique_first_occurrence(i) for i in ids]
        uxy = exchange_gather_xy([u.uniques for u in un], rows, labels_col,
                                 c, S, route=route, fused=fused,
                                 fused_frontier=fused_frontier)
        return [(_dedup_scatter_back(ux, u.inverse),
                 _dedup_scatter_back_1d(uy, u.inverse))
                for (ux, uy), u in zip(uxy, un)]

    b = ids[0].shape[0]
    d = rows[0].shape[-1]
    routing, requests = _resolve_plan(ids, c, S, routing, route)
    gotx, goty = [], []
    for s in range(S):
        local, ok = _served_ids(requests[s], s, c)
        gotx.append(_request_rows(rows[s], local, ok, fused_frontier))
        lab = labels_col[s].to(torch.int32)
        idx = torch.where(ok, local, 0).clamp(0, lab.shape[0] - 1).long()
        goty.append(torch.where(ok, lab[idx], 0))

    if _use_fused(fused) and rows[0].dtype == torch.float32:
        resp = _return_payload([
            torch.cat([x, y.view(torch.float32)[:, None]], -1)
            for x, y in zip(gotx, goty)])
        respx = [r[:, :d] for r in resp]
        respy = [r[:, d].view(torch.int32) for r in resp]
    else:
        respx = _return_payload(gotx)
        respy = [r[:, 0] for r in _return_payload([y[:, None]
                                                   for y in goty])]
    return [(_read_slots(respx[s], routing[s], b, S),
             _read_slots(respy[s], routing[s], b, S)) for s in range(S)]
