"""Kernel B1: one hop's neighbor sample on the card (``csrc/sample.cu``).

Counterpart of ``glt_tpu/ops/sample_pallas.py`` and of the XLA draw that
feeds it: ``glt_tpu.ops.neighbor_sample.sample_neighbors`` whole.  Per
seed row it finds the degree, draws the fanout's positions with
threefry (Floyd's k-subset, or i.i.d. with replacement; keyed by buffer
slot or by seed id), and reads

    nbrs[i, k] = indices[indptr[seeds[i]] + pos[i, k]]   (-1 where ~mask)

and the matching edge ids: ``edge_ids[...]``, the CSR position when the
ids are positional (``edge_ids is None``), or nothing (``with_edge``
False).

:func:`sample_neighbors_cuda` launches the kernel, draw and read in one,
and takes CUDA tensors only; the key stays on the card (no host sync).
:func:`sample_neighbors_plain` is the same function in plain PyTorch
(``glt_tpu``'s XLA arithmetic: the degrees, the plain threefry draw of
:func:`~glt_tpu_torch.ops.neighbor_sample.draw_positions`, the read),
which the CPU runs and the card's checks compare against; it launches no
hand-written kernel on any device.

**The autotune seam** (``sample_pallas.py``'s ``autotune_sample``).
``glt_tpu`` sweeps its binned kernel's (tile_rows, ring_depth,
bin_edges) grid per exact (batch, fanout, dtype).  Here the points are
B1's launch parameters: threads per block crossed with the lanes-per-row
rule, ``"fit"`` (``min(32, next_pow2(F))`` lanes, the launch B1 always
had) or ``"warp"`` (a whole warp a row).  :func:`autotune_sample` times
every point on the card at warmup and memoizes the fastest concrete
``(threads, lanes)`` for its exact key; ``ops.sample_neighbors`` then
launches :func:`auto_params` for a CUDA seed tensor of that key, the
default point for any other.  Draws are keyed by slot or id, never by
thread, so every point gives the same bits.  On the CPU nothing is
timed.  A CUDA graph records the point it was captured with: a later
sweep does not reach a graph already captured.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs import metrics as _metrics
from ..typing import PADDING_ID
from . import cuda_lib
from .autotune import check_eager, dtype_name, sweep_ms
from .neighbor_sample import (
    NeighborOutput,
    _row_offsets_and_degrees,
    draw_positions,
)

KEY_BY = ("slot", "id")
# Without replacement a row's picks sit in its lanes' registers: at most
# 64 a lane over 32 lanes (``csrc/sample.cu``).
MAX_FANOUT = 32 * 64

# The launch grid autotune_sample sweeps, and the grid the static launch
# model (analysis/kernelmodel.py, GLT017 and GLT019) checks every point
# of through LAUNCH_MODEL_DOMAIN.  The kernel is built for exactly these
# thread counts (csrc/launch.cuh).
CANDIDATE_THREADS = (128, 256, 512)
LANE_RULES = ("fit", "warp")
# Every lane count lanes_per_row gives: the powers of two up to a warp.
LANES_PER_ROW = (1, 2, 4, 8, 16, 32)
# sizeof(glt::Key): two uint32 words (csrc/threefry.cuh).
KEY_BYTES = 8
# The widest fanout the launch model checks B1's shared memory at.
MODEL_MAX_FANOUT = MAX_FANOUT

# The launch model evaluates dynamic_smem_bytes at every point of this
# domain, its parameters bound by name.
LAUNCH_MODEL_DOMAIN = {
    "threads": CANDIDATE_THREADS,
    "lanes": LANES_PER_ROW,
    "fanout": MODEL_MAX_FANOUT,
    "replace": (False, True),
    "by_id": (False, True),
}

# (threads, lanes per row)
SampleParams = Tuple[int, int]

# Decision table: (batch, fanout, dtype name) -> None (plain: a CPU
# graph, never timed) | the winning SampleParams.  Filled by
# autotune_sample.
_AUTO: dict = {}
# Per-key sweep timings: (batch, fanout, dtype name) -> {"t256_g8": ms}.
_AUTO_TIMES: dict = {}


def dynamic_smem_bytes(fanout: int, replace: bool, by_id: bool) -> int:
    """B1's dynamic shared memory: the step keys every row keyed by slot
    shares (two a step without replacement, two with), none keyed by id
    (``csrc/sample.cu`` ``launch``)."""
    return 0 if by_id else KEY_BYTES * (2 if replace else 2 * fanout)


def lanes_per_row(fanout: int, rule: str = "fit") -> int:
    """Lanes a row takes: ``"fit"`` the smallest power of two >= the
    fanout, at most a warp; ``"warp"`` a whole warp."""
    if rule == "warp":
        return 32
    if rule != "fit":
        raise ValueError(f"lane rule must be one of {LANE_RULES}, got "
                         f"{rule!r}")
    g = 1
    while g < fanout and g < 32:
        g *= 2
    return g


def default_sample_params() -> tuple:
    """The launch B1 always had: 256 threads, the ``"fit"`` lane rule."""
    return 256, "fit"


def candidate_sample_params() -> list:
    """The (threads, lane rule) grid :func:`autotune_sample` sweeps,
    the default point first."""
    default = default_sample_params()
    grid = [(t, r) for r in LANE_RULES for t in CANDIDATE_THREADS]
    return [default] + [p for p in grid if p != default]


def launch_params(fanout: int, point=None) -> SampleParams:
    """The concrete ``(threads, lanes)`` of a (threads, lane rule) point
    at this fanout (default: the default point)."""
    threads, rule = default_sample_params() if point is None else point
    return int(threads), lanes_per_row(fanout, rule)


def _auto_key(batch: int, fanout: int, dtype: torch.dtype) -> tuple:
    return int(batch), int(fanout), dtype_name(dtype)


def auto_params(batch: int, fanout: int, dtype: torch.dtype
                ) -> Optional[SampleParams]:
    """The memoized ``(threads, lanes)`` for this exact shape, or None
    (not swept, or pinned to the plain version: launch the default)."""
    return _AUTO.get(_auto_key(batch, fanout, dtype))


def _fmt_params(params: Optional[SampleParams]) -> str:
    if params is None:
        return "plain"
    return f"t{params[0]}_g{params[1]}"


def sample_neighbors_plain(indptr: torch.Tensor, indices: torch.Tensor,
                           seeds: torch.Tensor, fanout: int,
                           key: torch.Tensor,
                           edge_ids: Optional[torch.Tensor] = None,
                           with_replacement: bool = False,
                           with_edge: bool = True,
                           key_by: str = "slot") -> NeighborOutput:
    """Plain PyTorch hop: degrees, the plain draw, then the read
    ``flat = start + where(mask, pos, 0)``, read where valid."""
    seeds = seeds.to(torch.int32)
    start, deg = _row_offsets_and_degrees(indptr, seeds)
    pos, mask = draw_positions(deg, fanout, key, with_replacement, seeds,
                               key_by=key_by)
    flat = start[:, None] + torch.where(mask, pos, 0)
    # Masked slots may sit one past the edge array (a deg-0 last row);
    # their value is discarded, so clamp them to a readable slot.
    e = indices.shape[0]
    read = flat.clamp(0, max(e - 1, 0)).long()
    pad = torch.full_like(flat, PADDING_ID)
    nbrs = torch.where(mask, indices[read], pad) if e else pad
    if not with_edge:
        eids = None
    elif edge_ids is None:
        eids = torch.where(mask, flat, pad).to(torch.int32)
    else:
        eids = torch.where(mask, edge_ids[read], pad) if e else pad
    return NeighborOutput(nbrs=nbrs, eids=eids, mask=mask)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(indptr, indices, seeds, fanout, key, edge_ids,
                  with_replacement, key_by) -> int:
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError("sample_neighbors_cuda takes CUDA tensors, got "
                         f"indices on {dev}")
    _check("indptr", indptr, torch.int32, 1, dev)
    _check("indices", indices, torch.int32, 1, dev)
    _check("seeds", seeds, torch.int32, 1, dev)
    _check("key", key, torch.int64, 1, dev)
    if key.shape[0] != 2:
        raise ValueError(f"key must hold 2 words, got {tuple(key.shape)}")
    if indptr.shape[0] == 0:
        raise ValueError("indptr must hold N + 1 >= 1 row pointers")
    if edge_ids is not None:
        _check("edge_ids", edge_ids, torch.int32, 1, dev)
        if edge_ids.shape[0] != indices.shape[0]:
            raise ValueError("edge_ids and indices differ in length")
    if key_by not in KEY_BY:
        raise ValueError(f"key_by must be 'slot' or 'id', got {key_by!r}")
    fanout = int(fanout)
    if fanout <= 0:
        raise ValueError(f"fanout must be positive, got {fanout}")
    b = seeds.shape[0]
    if b * fanout >= 1 << 32:
        raise ValueError(f"random arrays of {b * fanout} >= 2**32 elements "
                         f"are not supported")
    if not with_replacement and fanout > MAX_FANOUT:
        raise ValueError(f"kernel B1 draws without replacement up to "
                         f"fanout {MAX_FANOUT}, got {fanout}")
    return fanout


def _launch(indptr, indices, seeds, fanout, key, edge_ids,
            with_replacement, with_edge, key_by,
            params: SampleParams) -> NeighborOutput:
    """One launch of B1 at ``params`` on checked inputs (uncounted: the
    sweep's timing launches come here directly)."""
    dev = indices.device
    b = seeds.shape[0]
    mode = 0 if not with_edge else (1 if edge_ids is None else 2)
    nbrs = torch.empty((b, fanout), dtype=torch.int32, device=dev)
    eids = (torch.empty((b, fanout), dtype=torch.int32, device=dev)
            if mode else None)
    mask = torch.empty((b, fanout), dtype=torch.bool, device=dev)
    threads, lanes = params
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_sample_neighbors(
            indptr.data_ptr(), indptr.shape[0], indices.data_ptr(),
            None if edge_ids is None else edge_ids.data_ptr(),
            seeds.data_ptr(), key.data_ptr(), b, fanout,
            int(with_replacement), int(key_by == "id"), mode,
            nbrs.data_ptr(), None if eids is None else eids.data_ptr(),
            mask.data_ptr(), int(threads), int(lanes),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, f"sample_neighbors_cuda at {_fmt_params(params)}")
    return NeighborOutput(nbrs=nbrs, eids=eids, mask=mask)


def sample_neighbors_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                          seeds: torch.Tensor, fanout: int,
                          key: torch.Tensor,
                          edge_ids: Optional[torch.Tensor] = None,
                          with_replacement: bool = False,
                          with_edge: bool = True,
                          key_by: str = "slot",
                          params: Optional[SampleParams] = None
                          ) -> NeighborOutput:
    """Launch kernel B1 on the current stream (no synchronisation) at the
    launch point ``params`` = ``(threads, lanes per row)`` (default: 256
    threads, the ``"fit"`` lanes); a point the kernel is not built for
    raises."""
    fanout = _check_inputs(indptr, indices, seeds, fanout, key, edge_ids,
                           with_replacement, key_by)
    params = (launch_params(fanout) if params is None
              else (int(params[0]), int(params[1])))
    out = _launch(indptr, indices, seeds, fanout, key, edge_ids,
                  with_replacement, with_edge, key_by, params)
    sample_neighbors_cuda.launches += 1
    by = sample_neighbors_cuda.launches_by_params
    by[params] = by.get(params, 0) + 1
    return out


sample_neighbors_cuda.launches = 0
sample_neighbors_cuda.launches_by_params = {}


def autotune_sample(indptr: torch.Tensor, indices: torch.Tensor,
                    seeds: torch.Tensor, fanout: int,
                    key: Optional[torch.Tensor] = None,
                    edge_ids: Optional[torch.Tensor] = None,
                    with_replacement: bool = False,
                    with_edge: bool = True, iters: int = 3) -> str:
    """Sweep B1's launch points for this exact (batch, fanout, dtype) and
    memoize the fastest for ``ops.sample_neighbors``.

    Call eagerly at warmup (loader construction, a benchmark's set-up),
    before any CUDA graph that should run the winner is captured; inside
    a capture it raises.  CPU tensors pin "plain" without timing.
    Returns "cuda" or "plain" (the per-point times are in
    :func:`sample_autotune_table`).  Keyed by the exact batch, so a
    capped hop width is its own key.  Points that resolve to the same
    ``(threads, lanes)`` at this fanout are timed once.
    """
    from .. import random as trandom

    akey = _auto_key(seeds.shape[0], fanout, indices.dtype)
    if akey in _AUTO:
        return "plain" if _AUTO[akey] is None else "cuda"
    winner, times = None, {}
    if indices.device.type == "cuda":
        check_eager("autotune_sample")
        if key is None:
            key = trandom.PRNGKey(0, device=indices.device)
        seeds = seeds.to(torch.int32).contiguous()
        fanout = _check_inputs(indptr, indices, seeds, fanout, key,
                               edge_ids, with_replacement, "slot")
        points = []
        for point in candidate_sample_params():
            p = launch_params(fanout, point)
            if p not in points:
                points.append(p)
        best = None
        for p in points:
            ms = sweep_ms(lambda: _launch(
                indptr, indices, seeds, fanout, key, edge_ids,
                with_replacement, with_edge, "slot", p), iters)
            times[_fmt_params(p)] = ms
            if best is None or ms < best:
                best, winner = ms, p
    _AUTO[akey] = winner
    _AUTO_TIMES[akey] = times
    choice = "plain" if winner is None else "cuda"
    _metrics.counter("glt.sample.autotune_runs",
                     "sample kernel sweep warmups").inc()
    _metrics.gauge("glt.sample.cuda_selected",
                   "1 if the last sample autotune swept the CUDA kernel",
                   labels={"fanout": str(fanout)},
                   ).set(1.0 if choice == "cuda" else 0.0)
    return choice


def sample_autotune_table() -> dict:
    """The sweep landscape, JSON-ready: ``{"b19200_f5_int32": {"winner":
    "t256_g8", "ms": {"t256_g8": 0.0066, ...}}, ...}``.  An empty ``ms``
    means the key was pinned to the plain version without a sweep."""
    out = {}
    for akey, winner in _AUTO.items():
        b, f, dt = akey
        out[f"b{b}_f{f}_{dt}"] = {
            "winner": _fmt_params(winner),
            "ms": {k: round(v, 5)
                   for k, v in _AUTO_TIMES.get(akey, {}).items()},
        }
    return out


def reset_autotune() -> None:
    """Drop all memoized decisions (tests, re-calibration)."""
    _AUTO.clear()
    _AUTO_TIMES.clear()
