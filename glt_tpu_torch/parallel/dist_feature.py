"""Distributed feature lookup: the all-to-all row exchange over a mesh
of shards, and its host tier (cf. ``glt_tpu/parallel/dist_feature.py``).

A lookup is one collective round trip: bucket the ids by owner shard (a
:func:`~glt_tpu_torch.parallel.dist_sampler.build_routing` plan,
reusable across exchanges), send the id buckets to their owners, let
every shard gather the rows requested from it, send the row blocks back
and read each id's row out of its slot.  :func:`exchange_gather_xy`
carries the feature AND label lookup of a frontier in one such round
trip: the int32 label column is reinterpreted (``Tensor.view``, not a
cast) as one more f32 payload column, so every label value comes back
bit for bit.

Like :mod:`.dist_sampler`, the functions take per-shard sequences (on
a mesh that spans processes, this process's shards) and run each stage
for every shard in turn.  With ``fused_frontier`` a
shard serves the requests that landed on it through kernel B3 on the
card (:func:`~glt_tpu_torch.ops.fused_frontier.fused_frontier`): the
request list repeats hub rows across the requesting shards, and B3
reads each distinct row once.  Without it the serve is a plain masked
index.  On a 2-D mesh every exchange here takes the hierarchical route
of :mod:`.dist_sampler` when ``route`` resolves 'hier' (``mesh_shape=``):
only the host-deduped ids cross hosts, and the rows come back in the
flat slot order, the same rows as the flat route's.

**Host tiering** (:class:`TieredShardedFeature`): when the feature
matrix outgrows the card, each shard keeps a hotness-ordered prefix of
its rows on the device and the rest in host memory.  The cold rows are
a host-side pipeline stage: :func:`route_cold_requests` and
:func:`compact_cold_requests` name, per serving shard, the cold rows its
incoming requests need; a :class:`HostColdStore` (or
:class:`~glt_tpu_torch.store.stager.DiskColdStore`) gathers them on the
host; the train step scatters them into the response leg of the hot
exchange (:func:`exchange_gather_hot`, :func:`exchange_gather_xy` with
``hot_per_shard``).  :class:`~glt_tpu_torch.parallel.dist_train.
TieredTrainPipeline` overlaps that host gather with the previous
batch's training.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.fused_frontier import fused_frontier as _fused_frontier
from ..ops.unique import unique_first_occurrence
from ..utils.device import DeviceLike, resolve_device
from .dist_sampler import (HierarchicalRouting, Routing, _all_to_all, _axes,
                           _ids, _shards, _topology_choice, _use_fused,
                           build_hier_routing, build_routing, hier_requests,
                           hier_response)
from .sharding import torch_dtype


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


def _resolve_plan(ids, nodes_per_shard: int, num_shards: int, routing,
                  route: str, mesh_shape=None, hier_load_factor=None):
    """Shared prologue of every feature exchange: each shard's routing
    plan (built here unless the caller passes shared ones: a flat
    :class:`Routing`, or a :class:`HierarchicalRouting` on a 2-D mesh
    when the topology resolves 'hier') and the id-request leg(s).

    Returns ``(routing, flat_plans, requests)``, per shard: ``requests``
    are the ids the shard serves (``[S * b]`` flat, ``[H * hier_cap]``
    hier, where only the host-deduped ids cross hosts), and the flat
    plans read the answers back (the hier response retraces its legs
    into the flat bucket order)."""
    if routing is None:
        if _topology_choice(route, _axes(None, mesh_shape),
                            mesh_shape) == "hier":
            routing = build_hier_routing(
                ids, nodes_per_shard, mesh_shape[0], mesh_shape[1],
                hier_load_factor=hier_load_factor, route=route)
        else:
            routing = [build_routing(i, nodes_per_shard, num_shards,
                                     route=route) for i in ids]
    if isinstance(routing[0], HierarchicalRouting):
        return routing, [r.base for r in routing], hier_requests(routing)
    return routing, routing, _all_to_all([r.buckets for r in routing],
                                         num_shards)


def _return_payload(routing, payload: Sequence[torch.Tensor],
                    num_shards: int) -> List[torch.Tensor]:
    """Response leg of every feature exchange: each request slot's
    ``[w]`` payload back to its requester, in flat bucket order (the
    hier legs in reverse; dropped and padding slots come back as zero
    rows, as the flat route's masked serve gives)."""
    if isinstance(routing[0], HierarchicalRouting):
        return hier_response(routing, payload, 0)
    return _all_to_all(payload, num_shards)


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
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
) -> List[torch.Tensor]:
    """Feature rows for every shard's global ``ids``, across shards.

    Args:
      ids: per shard, ``[B]`` global node ids (-1 padded -> zero rows).
      rows: per shard, its ``[nodes_per_shard, d]`` feature block (the
        rows of a :class:`~glt_tpu_torch.parallel.sharding.ShardedFeature`).
      dedup: route each shard's UNIQUE ids through the exchange and
        expand the rows back to every position; the result is the
        same bit for bit.
      routing: per shard, a pre-built plan for ``ids`` (flat or
        hierarchical; ignored under ``dedup``, whose plan is over the
        unique list).
      fused_frontier: serve through kernel B3 (see :func:`_request_rows`).
      mesh_shape: ``(H, C)`` of a 2-D mesh: the hierarchical route when
        ``route`` resolves 'hier' (see
        :func:`~glt_tpu_torch.parallel.dist_sampler._topology_choice`);
        the rows are the same.  ``hier_load_factor``: its cross-host
        bound (:func:`~glt_tpu_torch.parallel.dist_sampler.hier_request_cap`).

    Returns, per shard, ``[B, d]`` rows in input order.
    """
    S, c = num_shards, nodes_per_shard
    ids, rows = _shards(ids, S), _shards(rows, S)
    if dedup:
        un = [unique_first_occurrence(i) for i in ids]
        urows = exchange_gather([u.uniques for u in un], rows, c, S,
                                route=route, fused_frontier=fused_frontier,
                                mesh_shape=mesh_shape,
                                hier_load_factor=hier_load_factor)
        return [_dedup_scatter_back(r, u.inverse)
                for r, u in zip(urows, un)]
    b = ids[0].shape[0]
    routing, flat, requests = _resolve_plan(ids, c, S, routing, route,
                                            mesh_shape, hier_load_factor)
    got = []
    for j, s in enumerate(_ids(S, ids)):
        local, ok = _served_ids(requests[j], s, c)
        got.append(_request_rows(rows[j], local, ok, fused_frontier))
    resp = _return_payload(routing, got, S)
    return [_read_slots(r, p, b, S) for r, p in zip(resp, flat)]


class TieredShardedFeature(NamedTuple):
    """Per-shard features split between the device and host memory.

    ``hot``: ``[S, hot_per_shard, d]`` on the mesh's device; ``cold``:
    ``[S, c - hot_per_shard, d]`` host numpy.  Row ``r`` of shard ``s``
    holds global (relabelled) id ``s * c + r``; a hotness-ordered
    relabel (:func:`~glt_tpu_torch.partition.contiguous.contiguous_relabel`)
    makes the prefix the hot set.
    """
    hot: torch.Tensor
    cold: np.ndarray
    nodes_per_shard: int
    hot_per_shard: int
    num_shards: int

    @property
    def dim(self) -> int:
        return self.hot.shape[-1]


def _hot_rows(c: int, hot_ratio: float) -> int:
    """Hot rows a shard: at least one (the steps take the hot tier's
    shape and dtype), at most all ``c``."""
    return min(c, max(1, int(round(c * float(hot_ratio)))))


def _hot_tensor(hot: np.ndarray, dtype, dev: torch.device) -> torch.Tensor:
    arr = torch.from_numpy(hot)
    if dtype is not None:
        arr = arr.to(torch_dtype(dtype))
    return arr.to(dev)


def shard_feature_tiered(feature: np.ndarray, num_shards: int,
                         hot_ratio: float, dtype=None,
                         device: DeviceLike = None) -> TieredShardedFeature:
    """Split ``[N, d]`` rows into each shard's prefix on ``device``
    (default ``"cuda"``, cast to ``dtype`` if given) and its host
    remainder."""
    dev = resolve_device(device)
    feature = np.asarray(feature)
    n, d = feature.shape
    c = -(-n // num_shards)
    h = _hot_rows(c, hot_ratio)
    hot = np.zeros((num_shards, h, d), feature.dtype)
    cold = np.zeros((num_shards, c - h, d), feature.dtype)
    for s in range(num_shards):
        lo, hi = min(s * c, n), min((s + 1) * c, n)
        blk = feature[lo:hi]
        hot[s, : min(h, hi - lo)] = blk[:h]
        if hi - lo > h:
            cold[s, : hi - lo - h] = blk[h:]
    return TieredShardedFeature(hot=_hot_tensor(hot, dtype, dev), cold=cold,
                                nodes_per_shard=c, hot_per_shard=h,
                                num_shards=num_shards)


def shard_feature_tiered_from_store(store, num_shards: int,
                                    hot_ratio: float, dtype=None,
                                    device: DeviceLike = None
                                    ) -> TieredShardedFeature:
    """The hot prefixes read off a shard-major
    :class:`~glt_tpu_torch.store.disk.DiskFeatureStore`; the cold rows
    stay on disk.

    The store holds the whole ``[S * c, d]`` matrix in the tiered id
    layout (shard ``s`` row ``r`` at row ``s * c + r``), so one file
    backs the hot loads and a
    :class:`~glt_tpu_torch.store.stager.DiskColdStore`, which the
    pipeline must get as ``cold_store=``: ``cold`` here is a zero-row
    placeholder, and :class:`~glt_tpu_torch.parallel.dist_train.
    TieredTrainPipeline` refuses to default it to a
    :class:`HostColdStore`.
    """
    if store.num_rows % num_shards:
        raise ValueError(
            f"store rows {store.num_rows} not divisible by {num_shards} "
            f"shards — pad the matrix to the shard grid before writing")
    dev = resolve_device(device)
    c = store.num_rows // num_shards
    h = _hot_rows(c, hot_ratio)
    hot = np.empty((num_shards, h, store.dim), store.dtype)
    for s in range(num_shards):
        hot[s] = store.read_rows(np.arange(s * c, s * c + h, dtype=np.int64))
    cold = np.zeros((num_shards, 0, store.dim), store.dtype)
    return TieredShardedFeature(hot=_hot_tensor(hot, dtype, dev), cold=cold,
                                nodes_per_shard=c, hot_per_shard=h,
                                num_shards=num_shards)


def _scatter_staged(got: torch.Tensor, rows: torch.Tensor,
                    slots: torch.Tensor) -> torch.Tensor:
    """``got`` with ``rows[i]`` written at request slot ``slots[i]``;
    a -1 slot writes nothing (``glt_tpu``'s ``.at[].set(mode="drop")``):
    it lands in a trash row past the end, which is cut off."""
    n = got.shape[0]
    buf = torch.cat([got, got.new_zeros((1,) + tuple(got.shape[1:]))])
    idx = torch.where(slots >= 0, slots, n).long()
    buf[idx] = rows.to(got.dtype)
    return buf[:n]


def exchange_gather_hot(
    ids: Sequence[torch.Tensor],
    hot_rows: Sequence[torch.Tensor],
    nodes_per_shard: int,
    hot_per_shard: int,
    num_shards: int,
    staged_resp: Optional[Sequence[torch.Tensor]] = None,
    staged_rows: Optional[Sequence[torch.Tensor]] = None,
    staged_slots: Optional[Sequence[torch.Tensor]] = None,
    dedup: bool = False,
    routing: Optional[Sequence[Routing]] = None,
    route: str = "auto",
    fused_frontier: bool = False,
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
) -> List[torch.Tensor]:
    """The tiered gather: :func:`exchange_gather`'s round trip, where
    the serving shard answers hot requests (``local < hot_per_shard``)
    from its device prefix and cold ones from host-staged rows.

    Two staged forms, per shard:
      * compact: ``staged_rows [cold_cap, d]`` and ``staged_slots
        [cold_cap]`` (request slots, -1 padded) from
        :func:`compact_cold_requests`, scattered into the response;
      * dense: ``staged_resp [S * b, d]``, one row per request slot.
    Without either, cold rows come back as zeros (:func:`merge_cold`
    fills them).  ``dedup`` routes unique ids only; the staged rows
    must then come from a :func:`route_cold_requests` made with the
    same flag, and on a 2-D mesh with the same ``route``, ``mesh_shape``
    and ``hier_load_factor`` (the slots index the request layout, which
    follows the topology).  ``fused_frontier`` serves the hot rows
    through kernel B3 (bit for bit the masked index).  Returns, per
    shard, ``[B, d]`` rows in input order.
    """
    S, c, h = num_shards, nodes_per_shard, int(hot_per_shard)
    ids, hot_rows = _shards(ids, S), _shards(hot_rows, S)
    if dedup:
        un = [unique_first_occurrence(i) for i in ids]
        urows = exchange_gather_hot(
            [u.uniques for u in un], hot_rows, c, h, S,
            staged_resp=staged_resp, staged_rows=staged_rows,
            staged_slots=staged_slots, route=route,
            fused_frontier=fused_frontier, mesh_shape=mesh_shape,
            hier_load_factor=hier_load_factor)
        return [_dedup_scatter_back(r, u.inverse) for r, u in zip(urows, un)]
    b = ids[0].shape[0]
    routing, flat, requests = _resolve_plan(ids, c, S, routing, route,
                                            mesh_shape, hier_load_factor)
    got = []
    for j, s in enumerate(_ids(S, ids)):
        local, ok = _served_ids(requests[j], s, c)
        ok = ok & (local < h)
        g = _request_rows(hot_rows[j], local, ok, fused_frontier)
        if staged_rows is not None:
            g = _scatter_staged(g, staged_rows[j], staged_slots[j])
        elif staged_resp is not None:
            g = torch.where(ok[:, None], g, staged_resp[j].to(g.dtype))
        got.append(g)
    resp = _return_payload(routing, got, S)
    return [_read_slots(r, p, b, S) for r, p in zip(resp, flat)]


def exchange_gather_xy(
    ids: Sequence[torch.Tensor],
    rows: Sequence[torch.Tensor],
    labels_col: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    hot_per_shard: Optional[int] = None,
    staged_rows: Optional[Sequence[torch.Tensor]] = None,
    staged_slots: Optional[Sequence[torch.Tensor]] = None,
    dedup: bool = False,
    routing: Optional[Sequence[Routing]] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    fused_frontier: bool = False,
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Feature AND label gather of every shard's frontier in one
    exchange: one routing plan, one id all-to-all and one payload
    all-to-all.  The serving shard's int32 label column is reinterpreted
    as an f32 payload column beside the feature rows and reinterpreted
    back on the requester, so the round trip is exact for every label.

    Args:
      ids: per shard, ``[B]`` global node ids (-1 padded -> zero rows
        and labels).
      rows: per shard, its ``[nodes_per_shard, d]`` feature block, or
        its hot prefix with ``hot_per_shard``.
      labels_col: per shard, its ``[nodes_per_shard]`` label column.
      hot_per_shard: the tiered bound: requests past it take the staged
        cold rows (``staged_rows``/``staged_slots``, the compact form of
        :func:`exchange_gather_hot`); None serves every row from
        ``rows``.
      dedup: unique ids ride the exchange once (see :func:`exchange_gather`).
      fused: one payload collective for rows and labels (default); off,
        the labels ride a second one.  The single payload also needs an
        f32 feature block (the bitcast target); other dtypes take two.
      fused_frontier: serve the feature rows through kernel B3.
      mesh_shape / hier_load_factor: the 2-D mesh's hierarchical route
        (see :func:`exchange_gather`); the rows and labels ride its legs
        as one payload.

    Returns, per shard, ``(x [B, d], y [B] int32)`` in input order (zeros
    at invalid slots).
    """
    S, c = num_shards, nodes_per_shard
    ids, rows = _shards(ids, S), _shards(rows, S)
    labels_col = _shards(labels_col, S)
    if dedup:
        un = [unique_first_occurrence(i) for i in ids]
        uxy = exchange_gather_xy([u.uniques for u in un], rows, labels_col,
                                 c, S, hot_per_shard=hot_per_shard,
                                 staged_rows=staged_rows,
                                 staged_slots=staged_slots, route=route,
                                 fused=fused, fused_frontier=fused_frontier,
                                 mesh_shape=mesh_shape,
                                 hier_load_factor=hier_load_factor)
        return [(_dedup_scatter_back(ux, u.inverse),
                 _dedup_scatter_back_1d(uy, u.inverse))
                for (ux, uy), u in zip(uxy, un)]

    b = ids[0].shape[0]
    d = rows[0].shape[-1]
    h = c if hot_per_shard is None else int(hot_per_shard)
    routing, flat, requests = _resolve_plan(ids, c, S, routing, route,
                                            mesh_shape, hier_load_factor)
    gotx, goty = [], []
    for j, s in enumerate(_ids(S, ids)):
        local, ok = _served_ids(requests[j], s, c)
        x = _request_rows(rows[j], local, ok & (local < h), fused_frontier)
        if staged_rows is not None:
            x = _scatter_staged(x, staged_rows[j], staged_slots[j])
        gotx.append(x)
        lab = labels_col[j].to(torch.int32)
        idx = torch.where(ok, local, 0).clamp(0, lab.shape[0] - 1).long()
        goty.append(torch.where(ok, lab[idx], 0))

    if _use_fused(fused) and rows[0].dtype == torch.float32:
        resp = _return_payload(routing, [
            torch.cat([x, y.view(torch.float32)[:, None]], -1)
            for x, y in zip(gotx, goty)], S)
        respx = [r[:, :d] for r in resp]
        respy = [r[:, d].view(torch.int32) for r in resp]
    else:
        respx = _return_payload(routing, gotx, S)
        respy = [r[:, 0] for r in _return_payload(
            routing, [y[:, None] for y in goty], S)]
    return [(_read_slots(rx, p, b, S), _read_slots(ry, p, b, S))
            for rx, ry, p in zip(respx, respy, flat)]


def compact_cold_requests(cold_req: torch.Tensor, cold_cap: int):
    """One serving shard's cold-request vector compressed to
    ``cold_cap`` slots.

    ``cold_req``: ``[R]`` local cold row ids from
    :func:`route_cold_requests` (-1 = not cold).  Returns ``(slots, ids,
    dropped)``: the request slots and local cold ids of the first
    ``cold_cap`` cold requests in slot order (``[cold_cap]``, -1
    padded), and the int32 count of cold requests past the cap (they
    are served as zero rows).  The host gathers ``ids`` only, so the
    host->device bytes scale with ``cold_cap``, not ``R``.
    """
    is_cold = cold_req >= 0
    # A stable sort of the int32 key ~is_cold: cold slots first, each
    # group in slot order (glt_tpu's stable argsort of the bool).
    order = torch.sort((~is_cold).to(torch.int32), stable=True).indices
    slots = order[:cold_cap].to(torch.int32)
    ids = cold_req[slots.long()]
    slots = torch.where(ids >= 0, slots, -1)
    dropped = (is_cold.sum(dtype=torch.int32) - cold_cap).clamp(min=0)
    return slots, ids, dropped


def route_cold_requests(
    ids: Sequence[torch.Tensor],
    nodes_per_shard: int,
    hot_per_shard: int,
    num_shards: int,
    dedup: bool = False,
    routing: Optional[Sequence[Routing]] = None,
    route: str = "auto",
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
) -> List[torch.Tensor]:
    """Every serving shard's cold request slots: the same bucketing and
    id exchange as :func:`exchange_gather_hot`, and for shard ``s`` the
    local cold row (``0 .. c - h``) of each incoming request slot, or
    -1 for hot, foreign and padding slots: ``[S * b]`` on the flat
    route, ``[H * hier_cap]`` on the hierarchical one.  Pass the same
    ``dedup`` (and on a 2-D mesh ``route``, ``mesh_shape`` and
    ``hier_load_factor``) as the paired gather, so both see one request
    layout."""
    S, c, h = num_shards, nodes_per_shard, int(hot_per_shard)
    ids = _shards(ids, S)
    if dedup:
        ids = [unique_first_occurrence(i).uniques for i in ids]
        routing = None   # a shared plan is over the un-deduped list
    _, _, requests = _resolve_plan(ids, c, S, routing, route, mesh_shape,
                                   hier_load_factor)
    out = []
    for j, s in enumerate(_ids(S, ids)):
        req = requests[j]
        local = req - s * c
        is_cold = (req >= 0) & (local >= h) & (local < c)
        out.append(torch.where(is_cold, local - h, -1))
    return out


class HostColdStore:
    """Cold rows of the shards one process owns (all shards by default).

    A process of a spanning mesh builds ``HostColdStore(f,
    shard_ids=<its shards>)`` and serves only those; a shard's staged
    rows depend on its own block alone.  ``f.cold`` holds every shard's
    block, or only those of ``shard_ids`` in order (a spanning load).
    """

    def __init__(self, f: TieredShardedFeature, shard_ids=None):
        self.shard_ids = (tuple(range(f.num_shards)) if shard_ids is None
                          else tuple(shard_ids))
        held = f.cold.shape[0] != f.num_shards
        self._blocks = {s: np.asarray(f.cold[j if held else s])
                        for j, s in enumerate(self.shard_ids)}
        self.dim = f.cold.shape[-1]
        self.dtype = f.cold.dtype

    def serve(self, shard: int, cold_req: np.ndarray) -> np.ndarray:
        """Rows for one shard's request slots: ``cold_req [R]`` local
        cold row ids (-1 = none); ``[R, d]`` with zeros at -1 slots."""
        cold_req = np.asarray(cold_req)
        out = np.zeros((cold_req.shape[0], self.dim), self.dtype)
        self.serve_into(out, shard, cold_req)
        return out

    def serve_into(self, out: np.ndarray, shard: int, cold_req: np.ndarray,
                   pool=None, row_chunk: int = 16384) -> list:
        """Gather one shard's cold rows into ``out`` (``[R, d]``; rows at
        -1 slots are left as they are).

        With ``pool`` (a ThreadPoolExecutor) the gather splits into
        ``row_chunk``-row work items and returns their futures (the
        caller awaits them); numpy fancy indexing releases the GIL, so
        the chunks run in parallel.  Without a pool the gather runs
        inline and returns ``[]``.
        """
        if shard not in self._blocks:
            raise KeyError(
                f"shard {shard} is not local to this host "
                f"(local: {self.shard_ids})")
        blk = self._blocks[shard]
        cold_req = np.asarray(cold_req)
        sel = np.where(cold_req >= 0)[0]
        if blk.shape[0] == 0 or sel.size == 0:
            return []

        def work(lo, hi):
            idx = sel[lo:hi]
            out[idx] = blk[cold_req[idx]]

        if pool is None:
            work(0, sel.size)
            return []
        return [pool.submit(work, lo, min(lo + row_chunk, sel.size))
                for lo in range(0, sel.size, row_chunk)]


def cold_mask(ids: torch.Tensor, nodes_per_shard: int,
              hot_per_shard: int) -> torch.Tensor:
    """True where ``ids`` resolve to the host tier."""
    return (ids >= 0) & (ids % nodes_per_shard >= hot_per_shard)


def merge_cold(hot_x: torch.Tensor, staged_cold: torch.Tensor,
               ids: torch.Tensor, nodes_per_shard: int,
               hot_per_shard: int) -> torch.Tensor:
    """Staged cold rows laid over the hot-tier gather's result."""
    m = cold_mask(ids, nodes_per_shard, hot_per_shard)
    return torch.where(m[:, None], staged_cold.to(hot_x.dtype), hot_x)


def cold_gather_host(f: TieredShardedFeature,
                     nodes: np.ndarray) -> np.ndarray:
    """Host gather of the cold rows of per-shard node lists: ``nodes
    [S, cap]`` global ids (-1 padded) -> ``[S, cap, d]`` with zeros at
    hot and padding slots."""
    nodes = np.asarray(nodes)
    s_axis, cap = nodes.shape
    c, h = f.nodes_per_shard, f.hot_per_shard
    d = f.cold.shape[-1]
    out = np.zeros((s_axis, cap, d), f.cold.dtype)
    if f.cold.shape[1] == 0:
        return out
    flat = nodes.reshape(-1)
    is_cold = (flat >= 0) & (flat % c >= h)
    cold_flat = flat[is_cold]
    out.reshape(-1, d)[is_cold] = f.cold[cold_flat // c, cold_flat % c - h]
    return out
