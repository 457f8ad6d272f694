"""Distributed neighbor sampling over a mesh of shards: the all-to-all
id exchange (cf. ``glt_tpu/parallel/dist_sampler.py``, the flat 1-D
route).

Per hop, every shard:

  1. buckets its frontier ids by owner shard (static capacity);
  2. sends the buckets to their owners (one all-to-all);
  3. samples the requests that landed on it from its local CSR block;
  4. sends the neighbor and edge-id blocks back (one all-to-all);
  5. reads each id's answer out of the returned buckets (the stitch).

The multi-hop loop and the inducer are those of the single-device
sampler.  ``glt_tpu`` runs the shard bodies under ``shard_map`` in one
XLA program.  Here the functions take per-shard sequences (one tensor
per shard) and run each stage for every shard in turn; the collectives
sit between the stages in :func:`_all_to_all`, the one place a mesh of
several GPUs will swap in ``torch.distributed.all_to_all_single``.  On
the card each hop is one launch of kernel B1 per shard for the served
requests (two with ``exchange_load_factor``, which samples the
locally owned ids apart), and every key derivation one launch of the
hash kernel.  No stage reads a device value on the host.

Seed edges (:meth:`DistNeighborSampler.sample_from_edges`) sample the
endpoints and the negatives, the strict ones checked against the CSR of
the shard that owns their source (:func:`dist_edge_exists`, one round
trip a trial); :meth:`DistNeighborSampler.subgraph` fetches each node's
row from its owner and keeps the edges inside the node set
(:func:`dist_node_subgraph`).

On a 2-D ``(host, chip)`` mesh (:func:`~glt_tpu_torch.parallel.
multihost.global_mesh_2d`) draws are keyed per (key, id), so a route
that serves a duplicated id once gives the same neighbors as one that
serves every copy, and the hierarchical route
(:func:`build_hier_routing`) can dedup within a host before the
cross-host leg: each chip's buckets go to the chip of its host that
shares the owner's chip index (the per-host leg, a transposition along
``chip``), that chip keeps each host's ids once per owner host, the
unique ids cross hosts (a transposition along ``host``), and the answers
retrace both legs into the flat bucket order.  ``collective="ring"``
(:func:`exchange_one_hop_ring`) passes the request matrices around the
shards in S - 1 rotations of a list, each shard serving its row of the
matrix it holds, as ``glt_tpu``'s ``ppermute`` ring does.  The routing
autotuner is ROADMAP queue A item 4.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from ..ops.neighbor_sample import _row_offsets_and_degrees, sample_neighbors
from ..ops.unique import (
    dense_induce,
    dense_induce_final,
    dense_induce_init,
    dense_map_fits,
    relabel_by_reference,
    unique_first_occurrence,
)
from ..sampler.base import NegativeSampling, SamplerOutput
from ..sampler.neighbor_sampler import hop_widths, max_sampled_nodes
from ..typing import PADDING_ID
from .multihost import Mesh, mesh_axis_sizes, resolve_mesh_axes
from .sharding import check_on_mesh

__all__ = [
    "DistNeighborSampler", "HierGeom", "HierarchicalRouting", "Routing",
    "bounded_remote_cap", "build_hier_routing", "build_routing",
    "build_sorted_edge_view", "dist_edge_exists", "dist_node_subgraph",
    "dist_sample_multi_hop", "exchange_byte_model", "exchange_one_hop",
    "exchange_one_hop_ring", "hier_request_cap", "hier_requests",
    "hier_response", "mesh_axis_sizes", "resolve_mesh_axes",
]

# Host-boundary instrumentation: the per-shard stages stay span-free.
_M_DIST_BATCHES = _metrics.counter(
    "glt.dist.sample_batches", "distributed sample programs dispatched")
_M_DIST_SAMPLE_MS = _metrics.histogram(
    "glt.dist.sample_dispatch_ms",
    "dist sampler dispatch wall per batch")


def bounded_remote_cap(width: int, load_factor: float,
                       num_shards: int) -> int:
    """Per-owner request-bucket capacity for the bounded exchange:
    ``ceil(load_factor * width / num_shards)``, clamped to ``[1, width]``."""
    return min(width,
               max(1, -(-int(round(load_factor * width)) // num_shards)))


class Routing(NamedTuple):
    """Owner-bucketed routing plan for one shard's frontier (see
    :func:`build_routing`): everything an exchange needs to scatter ids
    into per-owner request buckets and to read the responses back.
    Built once per hop frontier and shared by every exchange over it."""
    buckets: torch.Tensor   # [S * cap] ids grouped by owner, -1 padded
    slot: torch.Tensor      # [B] bucket slot each input id landed in
    valid: torch.Tensor     # [B] input validity (overflowed ids excluded)
    dropped: torch.Tensor   # [] int32: ids beyond an owner's cap


# route='auto' takes the one-pass rank up to this many shards: its
# [B, S] rank matrix is O(B*S) elementwise work against the sort's
# O(B log B).
_ONEPASS_MAX_SHARDS = 16


_ROUTES = ("auto", "sort", "onepass", "flat", "hier")


def _route_choice(b: int, num_shards: int, cap: int, route: str) -> str:
    """The bucketing implementation: an explicit ``route`` ('sort' |
    'onepass'), else the shard-count heuristic (the autotuner is ROADMAP
    queue A item 4).  The topology tokens 'flat' and 'hier' pick no
    bucketing (:func:`_topology_choice` reads them)."""
    del b, cap
    if route not in _ROUTES:
        raise ValueError(f"route must be one of {'|'.join(_ROUTES)}, got "
                         f"{route!r}")
    if route in ("sort", "onepass"):
        return route
    return "onepass" if num_shards <= _ONEPASS_MAX_SHARDS else "sort"


def _topology_choice(route: str, axis_name, mesh_shape=None) -> str:
    """The routing topology, 'flat' or 'hier': a 1-D mesh (a str axis)
    is always flat; else an explicit 'flat' | 'hier' ``route``; else,
    with the ``(H, C)`` shape known, 'hier' when both axes exceed 1
    (``glt_tpu``'s rules without its env override and autotuned
    table)."""
    if isinstance(axis_name, str) or len(tuple(axis_name)) < 2:
        return "flat"
    if route in ("flat", "hier"):
        return route
    if mesh_shape is None:
        return "flat"
    h, c = int(mesh_shape[0]), int(mesh_shape[1])
    return "hier" if h > 1 and c > 1 else "flat"


def _axes(axis_name, mesh_shape):
    """The mesh axes an exchange runs over: ``axis_name`` when given,
    else the 2-D ``("host", "chip")`` pair when ``mesh_shape`` is, else
    the 1-D ``"shard"``."""
    if axis_name is not None:
        return axis_name
    return ("host", "chip") if mesh_shape is not None else "shard"


def _key_by(axes) -> str:
    """How the served draws are keyed: per (key, slot) on a 1-D mesh,
    per (key, id) on a 2-D one, where the flat and hierarchical routes
    must draw alike."""
    return "slot" if isinstance(axes, str) else "id"


def _use_fused(fused: Optional[bool]) -> bool:
    """Whether neighbors and edge ids (or rows and labels) ride one
    payload collective (the default) or two."""
    return True if fused is None else bool(fused)


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _bucket_by_owner_sort(ids: torch.Tensor, owner: torch.Tensor,
                          num_shards: int, cap: int) -> Routing:
    """Sort-based bucketing: a stable sort by owner, the segment starts
    by a search over the sorted owner keys."""
    b = ids.shape[0]
    dev = ids.device
    ids = _i32(ids)
    valid = ids >= 0
    owner_key = _i32(torch.where(valid, owner, num_shards))  # padding last
    order = torch.sort(owner_key, stable=True).indices
    sorted_ids = ids[order]
    sorted_owner = owner_key[order]

    starts = _i32(torch.searchsorted(
        sorted_owner, torch.arange(num_shards + 1, dtype=torch.int32,
                                   device=dev)))
    rank = torch.arange(b, dtype=torch.int32, device=dev) \
        - starts[sorted_owner.long()]
    fits = rank < cap
    live = sorted_owner < num_shards
    sorted_slot = _i32(torch.where(
        live & fits, sorted_owner * cap + rank.clamp(max=cap - 1),
        num_shards * cap))

    # Every overflowing id lands in the dump slot, cut off after.
    buckets = torch.full((num_shards * cap + 1,), PADDING_ID,
                         dtype=torch.int32, device=dev).scatter_(
        0, sorted_slot.long(), sorted_ids)[:-1]
    # `order` is a permutation: one write per index.
    slot = torch.zeros(b, dtype=torch.int32, device=dev).scatter_(
        0, order, sorted_slot)
    slot_valid = torch.zeros(b, dtype=torch.bool, device=dev).scatter_(
        0, order, fits & live)
    dropped = (live & ~fits).sum(dtype=torch.int32)
    return Routing(buckets=buckets,
                   slot=slot.clamp(max=num_shards * cap - 1),
                   valid=valid & slot_valid, dropped=dropped)


def _bucket_by_owner_onepass(ids: torch.Tensor, owner: torch.Tensor,
                             num_shards: int, cap: int) -> Routing:
    """Sort-free bucketing: each id's rank within its owner from a
    cumulative sum over an ``[S, B]`` one-hot; every field equals
    :func:`_bucket_by_owner_sort`'s.  The one-hot lies owner-major, so
    the sum runs along the contiguous axis (on the card a scan down
    the B rows of a ``[B, S]`` one-hot is ~100x slower)."""
    dev = ids.device
    ids = _i32(ids)
    valid = ids >= 0
    owner_key = _i32(torch.where(valid, owner, num_shards))
    onehot = torch.arange(num_shards, dtype=torch.int32,
                          device=dev)[:, None] == owner_key[None, :]
    rank_m = torch.cumsum(onehot, 1, dtype=torch.int32) - 1
    rank = torch.where(onehot, rank_m, 0).sum(0, dtype=torch.int32)
    in_range = owner_key < num_shards
    fits = rank < cap
    slot = _i32(torch.where(in_range & fits,
                            owner_key * cap + rank.clamp(max=cap - 1),
                            num_shards * cap))
    buckets = torch.full((num_shards * cap + 1,), PADDING_ID,
                         dtype=torch.int32, device=dev).scatter_(
        0, slot.long(), ids)[:-1]
    dropped = (in_range & ~fits).sum(dtype=torch.int32)
    return Routing(buckets=buckets,
                   slot=slot.clamp(max=num_shards * cap - 1),
                   valid=valid & in_range & fits, dropped=dropped)


def _bucket_by_owner(ids: torch.Tensor, owner: torch.Tensor,
                     num_shards: int, cap: int,
                     route: str = "auto") -> Routing:
    """Group ids into per-owner rows of a static ``[S, cap]`` buffer.

    Input order is kept within each owner, so a valid id gets slot
    ``owner * cap + rank-within-owner``.  With ``cap = len(ids)`` no id
    can overflow; with a smaller cap the ids past an owner's cap are
    marked invalid and counted in ``dropped``.  ``route`` picks the rank
    computation ('onepass' or 'sort'; equal outputs).
    """
    if _route_choice(ids.shape[0], num_shards, cap, route) == "onepass":
        return _bucket_by_owner_onepass(ids, owner, num_shards, cap)
    return _bucket_by_owner_sort(ids, owner, num_shards, cap)


def _owner(ids: torch.Tensor, nodes_per_shard: int) -> torch.Tensor:
    # Floor division of a padding id is masked to -1.
    return torch.where(ids >= 0, ids // nodes_per_shard, -1)


def build_routing(ids: torch.Tensor, nodes_per_shard: int, num_shards: int,
                  cap: Optional[int] = None,
                  route: str = "auto") -> Routing:
    """The owner-bucketed routing plan for one shard's frontier of global
    ids (``[B]``, -1 padded); ``cap`` per owner, ``None`` -> ``B``
    (no overflow)."""
    return _bucket_by_owner(ids, _owner(ids, nodes_per_shard), num_shards,
                            ids.shape[0] if cap is None else int(cap),
                            route=route)


def _bucket_payload(routing: Routing, payload: torch.Tensor,
                    num_shards: int, cap: int) -> torch.Tensor:
    """Scatter a payload into the same bucket slots as its ids."""
    buckets = torch.full((num_shards * cap + 1,), PADDING_ID,
                         dtype=torch.int32, device=payload.device)
    slot = torch.where(routing.valid, routing.slot, num_shards * cap)
    return buckets.scatter_(0, slot.long(), _i32(payload))[:-1]


def exchange_byte_model(topology: str, num_hosts: int, chips_per_host: int,
                        cap: int, payload_elems: int,
                        hier_cap: Optional[int] = None,
                        elem_bytes: int = 4):
    """Per-device ``(ici_bytes, dcn_bytes)`` of one request+response round
    trip, from static plan shapes.  Flat on ``[H, C]``: each device sends
    ``cap`` ids (and ``payload_elems`` response elements per slot) to
    every peer, ``C - 1`` of them within a host (ICI) and ``(H - 1) * C``
    across hosts (DCN).  Hier: the per-host legs move the whole ``[H, C,
    cap]`` bucket block but the own column; only ``(H - 1) * hier_cap``
    slots cross hosts."""
    h, c = int(num_hosts), int(chips_per_host)
    per_slot = (1 + int(payload_elems)) * int(elem_bytes)
    if topology == "flat":
        ici = (c - 1) * cap * per_slot
        dcn = (h - 1) * c * cap * per_slot
    elif topology == "hier":
        hc = c * cap if hier_cap is None else int(hier_cap)
        ici = (c - 1) * h * cap * per_slot
        dcn = (h - 1) * hc * per_slot
    else:
        raise ValueError(f"topology must be 'flat' or 'hier', "
                         f"got {topology!r}")
    return int(ici), int(dcn)


def _all_to_all(blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mesh's all-to-all: shard ``r`` sends row ``q`` of its ``[S *
    c, ...]`` block to shard ``q``, where it lands as row ``r``
    (``lax.all_to_all(x.reshape(S, c), axis, 0, 0)``).  With every
    shard on one device this is one ``[S_src, S_dst, c] -> [S_dst,
    S_src, c]`` transpose."""
    s = len(blocks)
    rest = tuple(blocks[0].shape[1:])
    c = blocks[0].shape[0] // s
    moved = torch.stack([b.reshape((s, c) + rest) for b in blocks]
                        ).transpose(0, 1).contiguous()
    return [moved[q].reshape((s * c,) + rest) for q in range(s)]


def _shards(x, num_shards: int) -> list:
    """A per-shard sequence from a list or an ``[S, ...]`` tensor."""
    out = list(x)
    if len(out) != num_shards:
        raise ValueError(f"{len(out)} shard blocks for {num_shards} shards")
    return out


# -- hierarchical (per-host, then cross-host) routing ----------------------
#
# On a (host, chip) mesh of shape (H, C), shard s = h * C + c:
#
#   per-chip owner buckets [S*cap] viewed [H, C, cap]
#     -> per-host leg (along chip): chip c of host h gets, from every chip
#        q of its host, the buckets for the owners (oh, c)  [H, C*cap]
#     -> each row oh deduped: host h's unique wants from owner (oh, c)
#     -> cross-host leg (along host) of the unique ids alone [H*hier_cap]
#     -> the owner serves each unique id once
#     -> back across hosts, expanded through ``inv`` (which never moved),
#        back along chip, landing in the flat bucket order [S*cap]
#
# so the flat epilogue reads the answers.  With every shard in one
# process a leg is one transposition of the stacked blocks.

class HierGeom(NamedTuple):
    """Static geometry of a hierarchical plan."""
    num_hosts: int
    chips_per_host: int
    host_axis: str
    chip_axis: str
    cap: int        # per-owner bucket capacity of the flat base plan
    hier_cap: int   # per-dest-host unique-request capacity (cross-host leg)


class HierarchicalRouting(NamedTuple):
    """One shard's two-level plan for a frontier on a 2-D mesh (see
    :func:`build_hier_routing`): the flat :class:`Routing` (whose
    ``slot``/``valid`` read the answers back) and the per-host dedup the
    cross-host legs ride on.  Built once per hop frontier and shared by
    every exchange over it."""
    base: Routing
    uniq: torch.Tensor          # [H, hier_cap] host-unique ids, -1 padded
    inv: torch.Tensor           # [H, C*cap] index into uniq's row, -1 = none
    hier_dropped: torch.Tensor  # [] int32: unique ids beyond hier_cap
    geom: HierGeom


def hier_request_cap(cap: int, chips_per_host: int, nodes_per_shard: int,
                     hier_load_factor: Optional[float] = None) -> int:
    """Width of the cross-host leg a destination host: the unique ids one
    device forwards to each host.  Lossless: ``min(C * cap,
    nodes_per_shard)`` (a row's uniques all live on one shard); with
    ``hier_load_factor`` (α) at most ``ceil(α * C * cap)``, the overflow
    dropped and counted."""
    lossless = min(int(chips_per_host) * int(cap),
                   max(1, int(nodes_per_shard)))
    if hier_load_factor is None:
        return lossless
    bounded = max(1, int(np.ceil(float(hier_load_factor)
                                 * chips_per_host * cap)))
    return min(lossless, bounded)


def _grid_all_to_all(blocks: Sequence[torch.Tensor], grid, axis: str
                     ) -> List[torch.Tensor]:
    """An all-to-all along one axis of the ``(H, C)`` grid, every shard's
    block at once.  ``axis="chip"`` (``lax.all_to_all(x, chip, 1, 1)``
    of ``[H, C, ...]`` blocks): shard ``(h, c)`` gets ``[:, q]`` = shard
    ``(h, q)``'s ``[:, c]``.  ``axis="host"`` (``lax.all_to_all(x, host,
    0, 0)`` of ``[H, ...]`` blocks): shard ``(h, c)`` gets ``[qh]`` =
    shard ``(qh, c)``'s ``[h]``."""
    h, c = int(grid[0]), int(grid[1])
    shape = tuple(blocks[0].shape)
    x = torch.stack(list(blocks)).reshape((h, c) + shape)
    if axis == "chip":
        y = x.permute(0, 3, 2, 1, *range(4, x.dim()))
    elif axis == "host":
        y = x.permute(2, 1, 0, *range(3, x.dim()))
    else:
        raise ValueError(f"axis must be 'host' or 'chip', got {axis!r}")
    return list(y.contiguous().reshape((h * c,) + shape).unbind(0))


def build_hier_routing(
    ids: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_hosts: int,
    chips_per_host: int,
    host_axis: str = "host",
    chip_axis: str = "chip",
    cap: Optional[int] = None,
    hier_load_factor: Optional[float] = None,
    route: str = "auto",
    base: Optional[Sequence[Routing]] = None,
) -> List[HierarchicalRouting]:
    """Every shard's two-level plan for its frontier ``ids`` (``[B]``
    global ids, -1 padded, shard ``s = h * C + c``).  Runs the per-host
    request leg and the dedup (part of the plan, shared by every exchange
    over the frontier); the cross-host legs run per exchange.

    ``cap``: per-owner bucket capacity, ``None`` -> ``B``;
    ``hier_load_factor``: the cross-host bound (:func:`hier_request_cap`);
    ``base``: pre-built flat plans over ``ids`` with this ``cap``.
    """
    h, c = int(num_hosts), int(chips_per_host)
    S = h * c
    ids = _shards(ids, S)
    cap = ids[0].shape[0] if cap is None else int(cap)
    if base is None:
        base = [_bucket_by_owner(i, _owner(i, nodes_per_shard), S, cap,
                                 route) for i in ids]
    slabs = _grid_all_to_all([p.buckets.reshape(h, c, cap) for p in base],
                             (h, c), "chip")
    hc = hier_request_cap(cap, c, nodes_per_shard, hier_load_factor)
    geom = HierGeom(num_hosts=h, chips_per_host=c, host_axis=host_axis,
                    chip_axis=chip_axis, cap=cap, hier_cap=hc)
    out = []
    for plan, slab in zip(base, slabs):
        rows = [unique_first_occurrence(r) for r in slab.reshape(h, c * cap)]
        inv = torch.stack([u.inverse for u in rows])
        over = torch.stack([u.count for u in rows]) - hc
        out.append(HierarchicalRouting(
            base=plan, uniq=torch.stack([u.uniques[:hc] for u in rows]),
            inv=torch.where((inv >= 0) & (inv < hc), inv, -1),
            hier_dropped=over.clamp(min=0).sum(dtype=torch.int32),
            geom=geom))
    return out


def hier_requests(hr: Sequence[HierarchicalRouting]) -> List[torch.Tensor]:
    """The cross-host request leg: per shard, the ``[H * hier_cap]``
    host-unique ids addressed to it (row ``qh`` from host ``qh``'s chip
    of its own chip index)."""
    g = hr[0].geom
    moved = _grid_all_to_all([p.uniq for p in hr],
                             (g.num_hosts, g.chips_per_host), "host")
    return [m.reshape(g.num_hosts * g.hier_cap) for m in moved]


def hier_response(hr: Sequence[HierarchicalRouting],
                  payload: Sequence[torch.Tensor], fill
                  ) -> List[torch.Tensor]:
    """The request legs retraced: per shard, its ``[H * hier_cap, W]``
    answers to the requests that landed on it -> ``[S * cap, W]`` in the
    flat bucket order of each requester.  Back across hosts, each row
    expanded through ``inv`` (duplicates copy the one answer, dropped and
    padding slots get ``fill``), back along the chips."""
    g = hr[0].geom
    grid = (g.num_hosts, g.chips_per_host)
    w = payload[0].shape[-1]
    resp = _grid_all_to_all([p.reshape(g.num_hosts, g.hier_cap, w)
                             for p in payload], grid, "host")
    rows = torch.arange(g.num_hosts, device=resp[0].device)[:, None]
    full = []
    for p, r in zip(hr, resp):
        got = r[rows, p.inv.clamp(0, g.hier_cap - 1).long()]
        got = torch.where((p.inv >= 0)[..., None], got,
                          torch.full((), fill, dtype=got.dtype,
                                     device=got.device))
        full.append(got.reshape(g.num_hosts, g.chips_per_host, g.cap, w))
    back = _grid_all_to_all(full, grid, "chip")
    return [x.reshape(g.num_hosts * g.chips_per_host * g.cap, w)
            for x in back]


def _served_local(req: torch.Tensor, shard: int, nodes_per_shard: int
                  ) -> torch.Tensor:
    """The local rows of the requests that landed on ``shard`` (-1 for
    padding and foreign ids)."""
    lid = torch.where(req >= 0, req - shard * nodes_per_shard, -1)
    return torch.where((lid >= 0) & (lid < nodes_per_shard), lid, -1)


def _hier_geometry(mesh_shape, axes):
    if mesh_shape is None:
        raise ValueError("the hierarchical route needs the mesh's (H, C) "
                         "shape (mesh_shape=)")
    return int(mesh_shape[0]), int(mesh_shape[1]), axes[0], axes[1]


def exchange_one_hop(
    seeds: Sequence[torch.Tensor],
    indptr: Sequence[torch.Tensor],
    indices: Sequence[torch.Tensor],
    edge_ids: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    fanout: int,
    keys: Sequence[torch.Tensor],
    remote_cap: Optional[int] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    routing: Optional[Sequence] = None,
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
    axis_name=None,
):
    """One distributed sampling hop over every shard.

    Args:
      seeds: per shard, ``[B]`` global seed ids (-1 padded).
      indptr/indices/edge_ids: per shard, its local CSR block (the rows
        of a :class:`~glt_tpu_torch.parallel.sharding.ShardedGraph`).
      keys: per shard, its key (``glt_tpu`` folds the shard index in).
      remote_cap: bounded exchange.  ``None`` reserves the whole frontier
        width for every owner.  With a cap, locally owned seeds never
        enter the exchange (they are sampled straight from the local
        block) and only remote ids ride per-owner buckets of
        ``remote_cap`` slots; ids past an owner's cap are dropped
        (padding) and counted.
      route / fused: the bucketing implementation and whether neighbors
        and edge ids ride one response collective; ``route`` also takes
        the topology tokens 'flat' and 'hier' (see :func:`_topology_choice`).
      routing: per shard, a pre-built plan for ``seeds``
        (:class:`Routing`, or :class:`HierarchicalRouting`, which takes
        the hierarchical route whatever ``route`` says); honoured only
        when ``remote_cap`` is None (the capped path buckets the remote
        subset, another plan).
      mesh_shape: ``(H, C)`` of a 2-D mesh; the hierarchical route needs
        it.  ``hier_load_factor``: the cross-host bound (see
        :func:`hier_request_cap`), None = lossless.
      axis_name: the mesh's axes, a str (1-D) or the 2-D pair; None
        derives them from ``mesh_shape``.  On a 2-D mesh the draws are
        keyed per (key, id), on a 1-D one per (key, slot).

    Returns, per shard, ``(nbrs, eids, mask, dropped)``: the first three
    ``[B, fanout]`` in seed order, ``dropped`` an int32 scalar (0 when
    ``remote_cap`` is None and the cross-host leg is lossless).
    """
    S, c = num_shards, nodes_per_shard
    seeds = _shards(seeds, S)
    indptr, indices = _shards(indptr, S), _shards(indices, S)
    edge_ids, keys = _shards(edge_ids, S), _shards(keys, S)
    axes = _axes(axis_name, mesh_shape)
    key_by = _key_by(axes)
    b = seeds[0].shape[0]
    hier = (isinstance(routing[0], HierarchicalRouting)
            if routing is not None
            else _topology_choice(route, axes, mesh_shape) == "hier")
    local = [None] * S
    if remote_cap is None:
        cap = b
        plans = list(routing) if routing is not None else None
        if hier and (plans is None
                     or not isinstance(plans[0], HierarchicalRouting)):
            h, cc, ha, ca = _hier_geometry(mesh_shape, axes)
            plans = build_hier_routing(seeds, c, h, cc, ha, ca, cap=b,
                                       hier_load_factor=hier_load_factor,
                                       route=route, base=plans)
        elif plans is None:
            plans = [_bucket_by_owner(x, _owner(x, c), S, b, route)
                     for x in seeds]
    else:
        cap = int(remote_cap)
        remote = []
        for s in range(S):
            # Locally owned seeds: sampled here, no exchange.
            owner = _owner(seeds[s], c)
            is_local = owner == s
            lout = sample_neighbors(
                indptr[s], indices[s],
                torch.where(is_local, seeds[s] - s * c, -1), fanout,
                keys[s], edge_ids=edge_ids[s], key_by=key_by)
            local[s] = (is_local, lout.nbrs, lout.eids)
            remote.append(torch.where(is_local, PADDING_ID, seeds[s]))
        if hier:
            h, cc, ha, ca = _hier_geometry(mesh_shape, axes)
            plans = build_hier_routing(remote, c, h, cc, ha, ca, cap=cap,
                                       hier_load_factor=hier_load_factor,
                                       route=route)
        else:
            plans = [_bucket_by_owner(r, _owner(r, c), S, cap, route)
                     for r in remote]
    flat = [p.base for p in plans] if hier else plans

    # Request exchange.  Flat: row q of shard s's requests = what shard q
    # wants from s.  Hier: row qh = host qh's unique wants from s.
    requests = (hier_requests(plans) if hier
                else _all_to_all([p.buckets for p in plans]))
    served = [sample_neighbors(
        indptr[s], indices[s], _served_local(requests[s], s, c), fanout,
        trandom.fold_in(keys[s], 1), edge_ids=edge_ids[s], key_by=key_by)
        for s in range(S)]

    # Response exchange, then the stitch: each seed's answer from its slot.
    if hier:
        # The hierarchical legs always carry neighbors and edge ids as
        # one payload; ``fused`` shapes the flat route's collective.
        resp = hier_response(plans, [torch.cat([o.nbrs, o.eids], -1)
                                     for o in served], PADDING_ID)
        resp = [(r[:, :fanout], r[:, fanout:]) for r in resp]
    elif _use_fused(fused):
        resp = _all_to_all([torch.cat([o.nbrs, o.eids], -1)
                            for o in served])
        resp = [(r[:, :fanout], r[:, fanout:]) for r in resp]
    else:
        resp = list(zip(_all_to_all([o.nbrs for o in served]),
                        _all_to_all([o.eids for o in served])))
    out = []
    for s in range(S):
        p = flat[s]
        sel = p.valid[:, None]
        slot = p.slot.long()
        nbrs = torch.where(sel, resp[s][0][slot], PADDING_ID)
        eids = torch.where(sel, resp[s][1][slot], PADDING_ID)
        if local[s] is not None:
            is_local, lnbrs, leids = local[s]
            nbrs = torch.where(is_local[:, None], lnbrs, nbrs)
            eids = torch.where(is_local[:, None], leids, eids)
        dropped = (p.dropped + plans[s].hier_dropped if hier
                   else p.dropped)
        out.append((nbrs, eids, nbrs >= 0, dropped))
    return out


def exchange_one_hop_ring(
    seeds: Sequence[torch.Tensor],
    indptr: Sequence[torch.Tensor],
    indices: Sequence[torch.Tensor],
    edge_ids: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    fanout: int,
    keys: Sequence[torch.Tensor],
    remote_cap: Optional[int] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    routing: Optional[Sequence[Routing]] = None,
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
    axis_name=None,
):
    """:func:`exchange_one_hop` with the request matrices passed around
    a ring (``glt_tpu``'s ``ppermute`` pipeline): after ``k`` rotations
    shard ``i`` holds the ``[S, cap]`` matrix of shard ``i - k`` and
    answers its row ``i`` under ``fold_in(key_i, k)``; one more rotation
    brings every matrix home with every row answered.  Here a rotation
    moves the list of per-shard matrices by one place.  ``remote_cap``
    bounds the matrices as in :func:`exchange_one_hop` (locally owned
    seeds are sampled under ``fold_in(key, S)`` and never travel).  The
    ring is flat by construction: ``mesh_shape`` and
    ``hier_load_factor`` are accepted and unused, ``fused`` changes
    nothing in one process; on a 2-D mesh the ring runs over the flat
    shard order and the draws are keyed per id.  Returns what
    :func:`exchange_one_hop` does.
    """
    del fused, mesh_shape, hier_load_factor
    S, c = num_shards, nodes_per_shard
    seeds = _shards(seeds, S)
    indptr, indices = _shards(indptr, S), _shards(indices, S)
    edge_ids, keys = _shards(edge_ids, S), _shards(keys, S)
    key_by = _key_by(_axes(axis_name, None))
    b = seeds[0].shape[0]

    def serve(s, ids, k):
        return sample_neighbors(indptr[s], indices[s],
                                _served_local(ids, s, c), fanout,
                                trandom.fold_in(keys[s], k),
                                edge_ids=edge_ids[s], key_by=key_by)

    local = [None] * S
    if remote_cap is None:
        cap = b
        plans = (list(routing) if routing is not None else
                 [_bucket_by_owner(x, _owner(x, c), S, b, route)
                  for x in seeds])
    else:
        cap = int(remote_cap)
        plans = []
        for s in range(S):
            is_local = _owner(seeds[s], c) == s
            lout = serve(s, torch.where(is_local, seeds[s], PADDING_ID), S)
            local[s] = (is_local, lout.nbrs, lout.eids)
            remote = torch.where(is_local, PADDING_ID, seeds[s])
            plans.append(_bucket_by_owner(remote, _owner(remote, c), S, cap,
                                          route))

    def rotate(xs):
        # ppermute i -> i + 1: shard j now holds what shard j - 1 held.
        return xs[-1:] + xs[:-1]

    def answer(reqs, ans, k):
        for i in range(S):
            o = serve(i, reqs[i][i], k)
            ans[i][i] = torch.cat([o.nbrs, o.eids], -1)

    reqs = [p.buckets.reshape(S, cap) for p in plans]
    ans = [torch.full((S, cap, 2 * fanout), PADDING_ID, dtype=torch.int32,
                      device=r.device) for r in reqs]
    answer(reqs, ans, 0)
    for k in range(1, S):
        reqs, ans = rotate(reqs), rotate(ans)
        answer(reqs, ans, k)
    if S > 1:
        ans = rotate(ans)
    out = []
    for s in range(S):
        p = plans[s]
        resp = ans[s].reshape(S * cap, 2 * fanout)[p.slot.long()]
        sel = p.valid[:, None]
        nbrs = torch.where(sel, resp[:, :fanout], PADDING_ID)
        eids = torch.where(sel, resp[:, fanout:], PADDING_ID)
        if local[s] is not None:
            is_local, lnbrs, leids = local[s]
            nbrs = torch.where(is_local[:, None], lnbrs, nbrs)
            eids = torch.where(is_local[:, None], leids, eids)
        out.append((nbrs, eids, nbrs >= 0, p.dropped))
    return out


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, torch.full((n,), PADDING_ID, dtype=torch.int32,
                                    device=x.device)])


def build_sorted_edge_view(indptr: torch.Tensor, indices: torch.Tensor):
    """One shard's ``(row, dst)`` pairs sorted lexicographically, for the
    binary search of :func:`_pair_exists`: ``(rows_s, dsts_s)``, int32,
    the padding past the shard's edge count sorted last as
    ``2**31 - 1``."""
    max_e = indices.shape[0]
    c = indptr.shape[0] - 1
    dev = indices.device
    pos = torch.arange(max_e, dtype=torch.int32, device=dev)
    row = _i32(torch.searchsorted(_i32(indptr), pos, right=True)) - 1
    valid = pos < indptr[c].to(torch.int32)
    big = 2**31 - 1
    row = torch.where(valid, row, big)
    dst = torch.where(valid, _i32(indices), big)
    # Two stable passes, minor key first: glt_tpu's lexsort((dst, row)).
    order = torch.sort(dst, stable=True).indices
    order = order[torch.sort(row[order], stable=True).indices]
    return row[order], dst[order]


def _pair_exists(rows_s: torch.Tensor, dsts_s: torch.Tensor,
                 r: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Lexicographic lower bound of ``(r, d)`` over the sorted view, 32
    branchless halvings as ``glt_tpu``'s; True where it hits."""
    e = rows_s.shape[0]
    last = e - 1
    lo = torch.zeros_like(r)
    hi = torch.full_like(r, e)
    for _ in range(32):
        cond = lo < hi
        mid = lo + (hi - lo) // 2
        mc = mid.clamp(0, last).long()
        mr, md = rows_s[mc], dsts_s[mc]
        less = (mr < r) | ((mr == r) & (md < d))
        lo = torch.where(cond & less, mid + 1, lo)
        hi = torch.where(cond & ~less, mid, hi)
    lc = lo.clamp(0, last).long()
    return (lo < e) & (rows_s[lc] == r) & (dsts_s[lc] == d)


def dist_edge_exists(
    rows_s: Sequence[torch.Tensor],
    dsts_s: Sequence[torch.Tensor],
    src: Sequence[torch.Tensor],
    dst: Sequence[torch.Tensor],
    nodes_per_shard: int,
    num_shards: int,
    route: str = "auto",
    fused: Optional[bool] = None,
) -> List[torch.Tensor]:
    """Whether each ``(src, dst)`` pair is an edge, across shards: every
    pair goes to the shard owning ``src`` (ids and dst payload in one
    collective with ``fused``), which looks it up in its sorted view
    (:func:`build_sorted_edge_view`), and the verdicts come back.
    Returns, per shard, ``[B]`` bool (False at padding)."""
    S, c = num_shards, nodes_per_shard
    src, dst = _shards(src, S), _shards(dst, S)
    b = src[0].shape[0]
    plans, dst_b = [], []
    for s in range(S):
        plans.append(_bucket_by_owner(src[s], _owner(src[s], c), S, b, route))
        dst_b.append(_bucket_payload(plans[-1], dst[s], S, b))
    if _use_fused(fused):
        req = _all_to_all([torch.stack([p.buckets, d], -1)
                           for p, d in zip(plans, dst_b)])
        req = [(r[:, 0], r[:, 1]) for r in req]
    else:
        req = list(zip(_all_to_all([p.buckets for p in plans]),
                       _all_to_all(dst_b)))
    verdicts = []
    for s, (req_s, req_d) in enumerate(req):
        local = req_s - s * c
        ok = (req_s >= 0) & (local >= 0) & (local < c)
        ex = _pair_exists(rows_s[s], dsts_s[s],
                          _i32(torch.where(ok, local, 0)),
                          _i32(torch.where(ok, req_d, 0)))
        verdicts.append(_i32(ex & ok))
    resp = _all_to_all(verdicts)
    return [torch.where(p.valid, resp[s][p.slot.long()] > 0, False)
            for s, p in enumerate(plans)]


def dist_node_subgraph(
    indptr: Sequence[torch.Tensor],
    indices: Sequence[torch.Tensor],
    edge_ids: Sequence[torch.Tensor],
    nodes: Sequence[torch.Tensor],
    max_degree: int,
    nodes_per_shard: int,
    num_shards: int,
    route: str = "auto",
    fused: Optional[bool] = None,
):
    """The subgraph induced by every shard's node set, across shards:
    each node's CSR row (capped at ``max_degree``) comes back from its
    owner in one round trip, and the edges whose destination lies in
    the set are kept, relabelled to positions in it.

    Args:
      nodes: per shard, ``[B]`` unique global node ids (-1 padded).

    Returns, per shard, ``(rows, cols, eids, mask)`` of ``[B *
    max_degree]``: local indices into ``nodes``, as
    :class:`~glt_tpu_torch.ops.subgraph.SubGraphOutput`.
    """
    S, c, D = num_shards, nodes_per_shard, int(max_degree)
    indptr, indices = _shards(indptr, S), _shards(indices, S)
    edge_ids, nodes = _shards(edge_ids, S), _shards(nodes, S)
    b = nodes[0].shape[0]
    plans = [build_routing(n, c, S, route=route) for n in nodes]
    requests = _all_to_all([p.buckets for p in plans])
    rows_out = []
    for s in range(S):
        req = requests[s]
        local = torch.where(req >= 0, req - s * c, -1)
        local = _i32(torch.where((local >= 0) & (local < c), local, -1))
        start, deg = _row_offsets_and_degrees(indptr[s], local)
        offs = torch.arange(D, dtype=torch.int32, device=req.device)[None, :]
        in_row = (offs < deg[:, None]) & (local >= 0)[:, None]
        flat = (_i32(start)[:, None] + torch.where(in_row, offs, 0)).long()
        flat = flat.clamp(0, max(indices[s].shape[0] - 1, 0))
        nbrs = torch.where(in_row, _i32(indices[s][flat]), PADDING_ID)
        eids = torch.where(in_row, _i32(edge_ids[s][flat]), PADDING_ID)
        rows_out.append((nbrs, eids))
    if _use_fused(fused):
        resp = _all_to_all([torch.cat([n, e], -1) for n, e in rows_out])
        resp = [(r[:, :D], r[:, D:]) for r in resp]
    else:
        resp = list(zip(_all_to_all([n for n, _ in rows_out]),
                        _all_to_all([e for _, e in rows_out])))
    out = []
    for s, p in enumerate(plans):
        sel = p.valid[:, None]
        slot = p.slot.long()
        nbrs = torch.where(sel, resp[s][0][slot], PADDING_ID)
        eids = torch.where(sel, resp[s][1][slot], PADDING_ID)
        local_dst = relabel_by_reference(nodes[s], nbrs.reshape(-1)
                                         ).reshape(b, D)
        keep = (nbrs >= 0) & (local_dst >= 0)
        local_src = torch.arange(b, dtype=torch.int32,
                                 device=nbrs.device)[:, None].expand(b, D)
        out.append((torch.where(keep, local_src, PADDING_ID).reshape(-1),
                    torch.where(keep, local_dst, PADDING_ID).reshape(-1),
                    torch.where(keep, eids, PADDING_ID).reshape(-1),
                    keep.reshape(-1)))
    return out


class _ShardState:
    """One shard's inducer state across the hops."""

    def __init__(self, seeds, num_global, cap, dense, width0):
        if dense:
            self.state = dense_induce_init(num_global, cap,
                                           device=seeds.device)
            self.state, _ = dense_induce(self.state, seeds)
            self.node_buf, self.count = self.state.node_buf, self.state.count
            self.frontier = self.node_buf[:width0]
        else:
            u0 = unique_first_occurrence(seeds)
            self.node_buf, self.count = u0.uniques, u0.count
            self.frontier = u0.uniques
        self.frontier_start = torch.zeros((), dtype=torch.int32,
                                          device=seeds.device)
        self.counts = [self.count]
        self.rows, self.cols, self.eids, self.emasks = [], [], [], []
        self.edges_per_hop = []
        self.leaf_mask = None


def dist_sample_multi_hop(
    indptr: Sequence[torch.Tensor],
    indices: Sequence[torch.Tensor],
    edge_ids: Sequence[torch.Tensor],
    seeds: Sequence[torch.Tensor],
    keys: Sequence[torch.Tensor],
    num_neighbors: Sequence[int],
    nodes_per_shard: int,
    num_shards: int,
    frontier_cap: Optional[int] = None,
    collective: str = "all_to_all",
    dedup: str = "auto",
    last_hop_dedup: bool = True,
    exchange_load_factor: Optional[float] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    mesh_shape: Optional[tuple] = None,
    hier_load_factor: Optional[float] = None,
    axis_name=None,
) -> List[SamplerOutput]:
    """Multi-hop sampling of every shard's seed batch; returns one
    :class:`SamplerOutput` per shard.

    The structure of the single-device sampler (frontier, cumulative
    first-occurrence dedup, relabelled COO) with :func:`exchange_one_hop`
    (or :func:`exchange_one_hop_ring`, ``collective='ring'``) as the
    one-hop primitive; ``keys`` holds each shard's key, split per hop.
    ``dedup``: 'dense' keeps a per-shard ``[N_global]`` id map, 'sort' a
    growing unique buffer, 'auto' dense up to a ~1 GB map.
    ``exchange_load_factor`` (α) bounds each hop's per-owner buckets at
    ``ceil(α * width / num_shards)`` remote ids (locally owned ids skip
    the exchange); the dropped requests (and, with ``hier_load_factor``,
    the cross-host overflow) are summed per shard in
    ``metadata['exchange_dropped']``.  On the uncapped path each hop's
    plan is built once, by :func:`build_routing` or, when the topology
    resolves 'hier' on a 2-D mesh (``axis_name``/``mesh_shape``; see
    :func:`_topology_choice`), by :func:`build_hier_routing`, and
    threaded in.
    """
    if collective not in ("all_to_all", "ring"):
        raise ValueError(f"collective must be 'all_to_all' or 'ring', got "
                         f"{collective!r}")
    exchange = (exchange_one_hop if collective == "all_to_all"
                else exchange_one_hop_ring)
    axes = _axes(axis_name, mesh_shape)
    topo = ("flat" if collective != "all_to_all"
            else _topology_choice(route, axes, mesh_shape))
    S, c = num_shards, nodes_per_shard
    indptr, indices = _shards(indptr, S), _shards(indices, S)
    edge_ids, seeds = _shards(edge_ids, S), _shards(seeds, S)
    fanouts = list(num_neighbors)
    b = seeds[0].shape[0]
    widths = hop_widths(b, fanouts, frontier_cap)
    cap = max_sampled_nodes(b, fanouts, frontier_cap)
    num_global = c * S
    if dedup == "auto":
        dedup = "dense" if dense_map_fits(num_global) else "sort"
    dense = dedup == "dense"
    st = [_ShardState(_i32(seeds[s]), num_global, cap, dense, widths[0])
          for s in range(S)]
    hop_keys = [trandom.split(k, len(fanouts)) for k in _shards(keys, S)]
    leaf_off = cap - widths[-1] * fanouts[-1]
    dropped_total = [torch.zeros((), dtype=torch.int32,
                                 device=seeds[s].device) for s in range(S)]

    for i, f in enumerate(fanouts):
        w = widths[i]
        last = i + 1 == len(fanouts)
        remote_cap = (None if exchange_load_factor is None
                      else bounded_remote_cap(w, exchange_load_factor, S))
        frontiers = [x.frontier for x in st]
        if remote_cap is not None:
            hop_routing = None
        elif topo == "hier":
            h, cc, ha, ca = _hier_geometry(mesh_shape, axes)
            hop_routing = build_hier_routing(
                frontiers, c, h, cc, ha, ca,
                hier_load_factor=hier_load_factor, route=route)
        else:
            hop_routing = [build_routing(fr, c, S, route=route)
                           for fr in frontiers]
        hop = exchange(frontiers, indptr, indices, edge_ids, c, S, f,
                       [k[i] for k in hop_keys], remote_cap=remote_cap,
                       route=route, fused=fused, routing=hop_routing,
                       mesh_shape=mesh_shape,
                       hier_load_factor=hier_load_factor, axis_name=axes)
        for s, x in enumerate(st):
            nbrs, eids, mask, dropped = hop[s]
            dev = nbrs.device
            dropped_total[s] = dropped_total[s] + dropped
            src_local = x.frontier_start + torch.arange(
                w, dtype=torch.int32, device=dev)
            src_local = torch.where(x.frontier >= 0, src_local, PADDING_ID)
            cand = nbrs.reshape(-1)
            if last and not last_hop_dedup:
                # Leaf block: no inducer at the widest frontier.
                x.leaf_mask = mask.reshape(-1)
                leaf_ids = torch.where(x.leaf_mask, cand, PADDING_ID)
                nbr_local = (leaf_off + torch.arange(
                    w * f, dtype=torch.int32, device=dev)).reshape(w, f)
                if dense:
                    x.node_buf[leaf_off: leaf_off + w * f] = leaf_ids
                else:
                    x.node_buf = torch.cat([x.node_buf, leaf_ids])
                new_count = x.count + x.leaf_mask.sum(dtype=torch.int32)
            elif dense:
                induce = dense_induce_final if last else dense_induce
                x.state, nbr_local = induce(x.state, cand)
                x.node_buf, new_count = x.state.node_buf, x.state.count
                nbr_local = nbr_local.reshape(w, f)
            else:
                buflen = x.node_buf.shape[0]
                merged = unique_first_occurrence(torch.cat([x.node_buf,
                                                            cand]))
                x.node_buf, new_count = merged.uniques, merged.count
                nbr_local = merged.inverse[buflen:].reshape(w, f)
            nbr_local = torch.where(mask, nbr_local, PADDING_ID)

            x.rows.append(nbr_local.reshape(-1))
            x.cols.append(src_local[:, None].expand(w, f).reshape(-1))
            x.eids.append(eids.reshape(-1))
            x.emasks.append(mask.reshape(-1))
            x.edges_per_hop.append(mask.sum(dtype=torch.int32))
            if not last:
                nw = widths[i + 1]
                start = x.count.clamp(0, x.node_buf.shape[0]).long()
                at = start + torch.arange(nw, device=dev)
                x.frontier = _pad(x.node_buf, nw)[at]
                x.frontier_start = x.count
            x.count = new_count
            x.counts.append(x.count)

    outs = []
    for s, x in enumerate(st):
        dev = x.count.device
        node_buf = x.node_buf
        if node_buf.shape[0] < cap:
            node_buf = _pad(node_buf, cap - node_buf.shape[0])
        node_buf = node_buf[:cap]
        count = x.count.clamp(max=cap)
        slots = torch.arange(cap, dtype=torch.int32, device=dev)
        if x.leaf_mask is None:
            node_mask = slots < count
        else:
            interior = (count - x.edges_per_hop[-1]).clamp(max=leaf_off)
            node_mask = (slots < interior) | torch.cat([
                torch.zeros(leaf_off, dtype=torch.bool, device=dev),
                x.leaf_mask])
        n = x.counts
        outs.append(SamplerOutput(
            node=node_buf,
            row=torch.cat(x.rows),
            col=torch.cat(x.cols),
            edge=torch.cat(x.eids),
            batch=seeds[s],
            node_mask=node_mask,
            edge_mask=torch.cat(x.emasks),
            num_sampled_nodes=torch.stack(
                [n[0]] + [n[j + 1] - n[j] for j in range(len(fanouts))]),
            num_sampled_edges=torch.stack(x.edges_per_hop),
            metadata=(None if exchange_load_factor is None
                      and hier_load_factor is None
                      else {"exchange_dropped": dropped_total[s]})))
    return outs


def _stack_outputs(outs: Sequence[SamplerOutput]) -> SamplerOutput:
    """Per-shard outputs as one output whose fields lead with the shard
    axis (``glt_tpu``'s ``shard_map`` result)."""
    def stack(name):
        if getattr(outs[0], name) is None:
            return None
        return torch.stack([getattr(o, name) for o in outs])

    meta = outs[0].metadata
    return SamplerOutput(
        node=stack("node"), row=stack("row"), col=stack("col"),
        edge=stack("edge"), batch=stack("batch"),
        node_mask=stack("node_mask"), edge_mask=stack("edge_mask"),
        num_sampled_nodes=stack("num_sampled_nodes"),
        num_sampled_edges=stack("num_sampled_edges"),
        metadata=(None if meta is None else
                  {k: torch.stack([o.metadata[k] for o in outs])
                   for k in meta}))


def seeds_on_mesh(seeds, mesh: Mesh) -> torch.Tensor:
    """``[S, B]`` host seeds (numpy or a tensor) as an int32 tensor on the
    mesh's device.  A host array goes through pinned memory, so the
    copy does not wait for the device."""
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=mesh.device, dtype=torch.int32)
    host = torch.from_numpy(np.ascontiguousarray(seeds, dtype=np.int32))
    if mesh.device.type == "cuda":
        return host.pin_memory().to(mesh.device, non_blocking=True)
    return host


class DistNeighborSampler:
    """Multi-hop distributed sampler over a :class:`ShardedGraph` on a
    :class:`~glt_tpu_torch.parallel.multihost.Mesh`.

    The multi-hop structure is the single-device
    :class:`~glt_tpu_torch.sampler.NeighborSampler`'s; only the one-hop
    primitive is the all-to-all exchange (``collective='ring'``: the
    ring of :func:`exchange_one_hop_ring`).  On a 2-D mesh
    :meth:`sample_from_nodes` takes the hierarchical route where
    :func:`_topology_choice` resolves it (``route='flat'`` forces the
    flat one; the batches are equal), and ``hier_load_factor`` bounds its
    cross-host leg, the drops in ``metadata['exchange_dropped']``.
    :meth:`sample_from_nodes` returns a :class:`SamplerOutput` whose
    fields lead with the shard axis: each shard's batch is its own
    ego-subgraph, ready for data-parallel training.
    """

    def __init__(self, sharded_graph, mesh: Mesh,
                 axis_name: Optional[str] = None,
                 num_neighbors: Sequence[int] = (15, 10, 5),
                 batch_size: int = 512,
                 frontier_cap: Optional[int] = None,
                 collective: str = "all_to_all",
                 valid_per_shard: Optional[np.ndarray] = None,
                 seed: int = 0,
                 last_hop_dedup: bool = True,
                 exchange_load_factor: Optional[float] = None,
                 route: str = "auto",
                 fused: Optional[bool] = None,
                 hier_load_factor: Optional[float] = None):
        if collective not in ("all_to_all", "ring"):
            raise ValueError(f"collective must be 'all_to_all' or 'ring', "
                             f"got {collective!r}")
        g = sharded_graph
        if g.num_shards != mesh.size:
            raise ValueError(f"a graph of {g.num_shards} shards on a mesh "
                             f"of {mesh.size}")
        check_on_mesh(mesh, indptr=g.indptr, indices=g.indices,
                      edge_ids=g.edge_ids)
        self.collective = collective
        self.valid_per_shard = valid_per_shard
        self._sorted_view = None
        self.last_hop_dedup = bool(last_hop_dedup)
        self.exchange_load_factor = exchange_load_factor
        self.fused = fused
        self.hier_load_factor = hier_load_factor
        self.g = g
        self.mesh = mesh
        self.axis_name = resolve_mesh_axes(mesh, axis_name)
        self.mesh_shape = mesh_axis_sizes(mesh, self.axis_name)
        self.num_neighbors = list(num_neighbors)
        self.batch_size = int(batch_size)
        self.frontier_cap = frontier_cap
        self._base_key = trandom.PRNGKey(seed, device=mesh.device)
        self._call_count = 0
        self._widths = hop_widths(self.batch_size, self.num_neighbors,
                                  frontier_cap)
        # 'auto' resolves once, at the widest frontier, to the
        # shard-count heuristic (glt_tpu's autotuner pins the same
        # choice off the TPU); on a 2-D mesh the topology resolves per
        # call from the mesh's shape (_topology_choice), so a resolved
        # bucketing keeps 'hier' there.
        resolved = _route_choice(max(self._widths), g.num_shards,
                                 max(self._widths), route)
        self.route = resolved if route == "auto" else route
        self.node_capacity = max_sampled_nodes(self.batch_size,
                                               self.num_neighbors,
                                               frontier_cap)

    def _next_key(self) -> torch.Tensor:
        key = trandom.fold_in(self._base_key, self._call_count)
        self._call_count += 1
        return key

    def _sample_local(self, seeds: Sequence[torch.Tensor],
                      key: torch.Tensor) -> List[SamplerOutput]:
        """Every shard's body: shard ``s`` samples with ``fold_in(key,
        s)``, as ``glt_tpu`` folds in the mesh axis index."""
        g = self.g
        return dist_sample_multi_hop(
            g.indptr, g.indices, g.edge_ids, seeds,
            [trandom.fold_in(key, s) for s in range(g.num_shards)],
            self.num_neighbors, g.nodes_per_shard, g.num_shards,
            self.frontier_cap, self.collective,
            last_hop_dedup=self.last_hop_dedup,
            exchange_load_factor=self.exchange_load_factor,
            route=self.route, fused=self.fused, mesh_shape=self.mesh_shape,
            hier_load_factor=self.hier_load_factor,
            axis_name=self.axis_name)

    def sample_from_nodes(self, seeds_per_shard,
                          key: Optional[torch.Tensor] = None
                          ) -> SamplerOutput:
        """``seeds_per_shard``: ``[S, batch_size]`` global ids, -1
        padded (a host array or a tensor)."""
        if key is None:
            key = self._next_key()
        seeds = seeds_on_mesh(seeds_per_shard, self.mesh)
        # The span times the host dispatch of every shard's stages; the
        # consumer's sync sees the device work.
        with _span("dist.sample_dispatch", route=self.route), \
                _M_DIST_SAMPLE_MS.time():
            out = _stack_outputs(self._sample_local(seeds, key))
        _M_DIST_BATCHES.inc()
        return out


    # -- seed edges (cf. glt_tpu's DistNeighborSampler.sample_from_edges) -
    def _valid_per_shard(self) -> torch.Tensor:
        """Valid-node count of every shard, for uniform negative draws."""
        dev = self.mesh.device
        if self.valid_per_shard is not None:
            return torch.as_tensor(np.asarray(self.valid_per_shard,
                                              np.int32), device=dev)
        g = self.g
        counts = np.clip(g.num_nodes - np.arange(g.num_shards)
                         * g.nodes_per_shard, 0, g.nodes_per_shard)
        return torch.from_numpy(counts.astype(np.int32)).to(dev)

    def _sorted_edge_view(self):
        """Every shard's sorted ``(row, dst)`` view for the strict
        negative checks, built once and kept."""
        if self._sorted_view is None:
            views = [build_sorted_edge_view(ip, ix) for ip, ix in
                     zip(self.g.indptr, self.g.indices)]
            self._sorted_view = tuple(list(v) for v in zip(*views))
        return self._sorted_view

    def sample_from_edges(self, src, dst,
                          neg_sampling: Optional[NegativeSampling] = None,
                          key: Optional[torch.Tensor] = None,
                          strict: bool = False,
                          trials: int = 4) -> SamplerOutput:
        """Seed-edge sampling of every shard's ``[S, B]`` endpoint ids
        (-1 padded; host arrays or tensors).

        Negatives are drawn uniformly over the valid ids (a shard, then
        a row below its valid count; a ``neg_sampling.weight`` is not
        used, as in ``glt_tpu``).  ``strict=True`` routes each
        candidate pair to the shard owning its source and redraws the
        pairs that are edges there (:func:`dist_edge_exists`) over
        ``trials`` rounds; a slot that never clears keeps its last draw.
        Returns a :class:`SamplerOutput` whose fields lead with the shard
        axis; its metadata carries ``edge_label_index`` and
        ``edge_label`` (binary or no negatives) or ``src_index``,
        ``dst_pos_index`` and ``dst_neg_index`` (triplet).
        """
        if key is None:
            key = self._next_key()
        mode = None if neg_sampling is None else neg_sampling.mode
        amount = (0 if neg_sampling is None
                  else int(round(neg_sampling.amount)))
        strict = bool(strict) and mode is not None
        src = seeds_on_mesh(src, self.mesh)
        dst = seeds_on_mesh(dst, self.mesh)
        view = self._sorted_edge_view() if strict else None
        return _stack_outputs(self._edges_body(
            mode, amount, list(src), list(dst), key, view, int(trials)))

    def _edges_body(self, mode, amount, src, dst, key, strict_view,
                    trials):
        """Every shard's seed-edge batch: shard ``s`` splits ``fold_in(
        key, s)`` into its negative and its sampling key."""
        g = self.g
        S, c = g.num_shards, g.nodes_per_shard
        q = src[0].shape[0]
        counts = self._valid_per_shard()
        ks = [trandom.split(trandom.fold_in(key, s)) for s in range(S)]
        kneg, ksample = [k[0] for k in ks], [k[1] for k in ks]

        def uniform_ids(k, n):
            # A shard, then a row below its valid count, drawn over the
            # whole int31 range before the modulo.
            k2 = trandom.split(k)
            sh = trandom.randint(k2[0], (n,), 0, S)
            u = trandom.randint(k2[1], (n,), 0, 2**31 - 1)
            return sh * c + u % counts[sh.long()].clamp(min=1)

        def strict_pairs(keys, n, valid, fixed_src=None):
            rows_s, dsts_s = strict_view
            dev = valid[0].device
            best_s = [torch.full((n,), PADDING_ID, dtype=torch.int32,
                                 device=dev) for _ in range(S)]
            best_d = [b.clone() for b in best_s]
            found = [torch.zeros(n, dtype=torch.bool, device=dev)
                     for _ in range(S)]
            last = None
            for t in range(trials):
                draws = []
                for s in range(S):
                    kt = trandom.split(trandom.fold_in(keys[s], t))
                    a = (fixed_src[s] if fixed_src is not None
                         else uniform_ids(kt[0], n))
                    draws.append((a, uniform_ids(kt[1], n)))
                ex = dist_edge_exists(
                    rows_s, dsts_s,
                    [torch.where(v, a, PADDING_ID)
                     for v, (a, _) in zip(valid, draws)],
                    [d for _, d in draws], c, S, route=self.route,
                    fused=self.fused)
                for s, (a, d) in enumerate(draws):
                    take = valid[s] & ~found[s] & ~ex[s]
                    best_s[s] = torch.where(take, a, best_s[s])
                    best_d[s] = torch.where(take, d, best_d[s])
                    found[s] = found[s] | take
                last = draws
            # Slots that never cleared keep their last draw.
            for s, (a, d) in enumerate(last):
                pad = valid[s] & ~found[s]
                best_s[s] = torch.where(pad, a, best_s[s])
                best_d[s] = torch.where(pad, d, best_d[s])
            return best_s, best_d

        rep = [(x >= 0).repeat_interleave(amount) for x in src]
        neg_src = neg_dst = None
        if mode == "binary":
            if strict_view is not None:
                neg_src, neg_dst = strict_pairs(kneg, q * amount, rep)
            else:
                kk = [trandom.split(k) for k in kneg]
                neg_src = [uniform_ids(k[0], q * amount) for k in kk]
                neg_dst = [uniform_ids(k[1], q * amount) for k in kk]
            neg_src = [torch.where(r, x, PADDING_ID)
                       for r, x in zip(rep, neg_src)]
            neg_dst = [torch.where(r, x, PADDING_ID)
                       for r, x in zip(rep, neg_dst)]
            seeds = [torch.cat([a, b, x, y]) for a, b, x, y in
                     zip(src, dst, neg_src, neg_dst)]
        elif mode == "triplet":
            if strict_view is not None:
                _, neg_dst = strict_pairs(
                    kneg, q * amount, rep,
                    fixed_src=[x.repeat_interleave(amount) for x in src])
            else:
                neg_dst = [uniform_ids(k, q * amount) for k in kneg]
            neg_dst = [torch.where(r, x, PADDING_ID)
                       for r, x in zip(rep, neg_dst)]
            seeds = [torch.cat([a, b, y]) for a, b, y in
                     zip(src, dst, neg_dst)]
        else:
            seeds = [torch.cat([a, b]) for a, b in zip(src, dst)]

        outs = dist_sample_multi_hop(
            g.indptr, g.indices, g.edge_ids, [_i32(x) for x in seeds],
            ksample, self.num_neighbors, c, S, self.frontier_cap,
            self.collective, last_hop_dedup=self.last_hop_dedup,
            exchange_load_factor=self.exchange_load_factor,
            route=self.route, fused=self.fused, axis_name=self.axis_name)
        for s, out in enumerate(outs):
            # Seed ids first occur in the hop-0 prefix: relabel against
            # it alone (a leaf block may repeat them).
            ref = out.node[: seeds[s].shape[0]]
            meta = dict(out.metadata or {})
            if mode == "binary":
                meta["edge_label_index"] = torch.stack([
                    relabel_by_reference(ref, torch.cat([src[s],
                                                         neg_src[s]])),
                    relabel_by_reference(ref, torch.cat([dst[s],
                                                         neg_dst[s]]))])
                pos = _i32(torch.where(src[s] >= 0, 1, PADDING_ID))
                meta["edge_label"] = torch.cat([pos, torch.zeros(
                    q * amount, dtype=torch.int32, device=pos.device)])
            elif mode == "triplet":
                meta["src_index"] = relabel_by_reference(ref, src[s])
                meta["dst_pos_index"] = relabel_by_reference(ref, dst[s])
                meta["dst_neg_index"] = relabel_by_reference(
                    ref, neg_dst[s]).reshape(q, amount)
            else:
                meta["edge_label_index"] = torch.stack([
                    relabel_by_reference(ref, src[s]),
                    relabel_by_reference(ref, dst[s])])
            out.metadata = meta
        return outs

    # -- induced subgraphs (cf. glt_tpu's DistNeighborSampler.subgraph) ---
    def subgraph(self, seeds_per_shard, max_degree: int = 64,
                 key: Optional[torch.Tensor] = None) -> SamplerOutput:
        """Hop expansion, then the subgraph induced by each shard's node
        set (:func:`dist_node_subgraph`): every member's row, capped at
        ``max_degree``, from its owner shard, filtered to the set.
        Fields lead with the shard axis; ``metadata['mapping']`` is
        ``arange(batch_size)``."""
        if key is None:
            key = self._next_key()
        g = self.g
        S = g.num_shards
        seeds = seeds_on_mesh(seeds_per_shard, self.mesh)
        # Exact dedup: the induced extract relabels against a unique set.
        base = dist_sample_multi_hop(
            g.indptr, g.indices, g.edge_ids, list(seeds),
            [trandom.fold_in(key, s) for s in range(S)], self.num_neighbors,
            g.nodes_per_shard, S, self.frontier_cap, self.collective,
            last_hop_dedup=True, route=self.route, fused=self.fused,
            axis_name=self.axis_name)
        sub = dist_node_subgraph(g.indptr, g.indices, g.edge_ids,
                                 [b.node for b in base], max_degree,
                                 g.nodes_per_shard, S, route=self.route,
                                 fused=self.fused)
        mapping = torch.arange(self.batch_size, dtype=torch.int32,
                               device=self.mesh.device)
        return _stack_outputs([
            SamplerOutput(node=b.node, row=r, col=c_, edge=e,
                          batch=seeds[s], node_mask=b.node_mask,
                          edge_mask=m,
                          num_sampled_nodes=b.num_sampled_nodes,
                          metadata={"mapping": mapping})
            for s, (b, (r, c_, e, m)) in enumerate(zip(base, sub))])
