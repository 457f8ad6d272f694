"""Kernel B2: the row gather on the card (``csrc/gather.cu``), and the
exact-shape autotune seam of B2 and B4.

Counterpart of ``glt_tpu/ops/gather_pallas.py``:
``out[i] = table[clamp(idx[i], 0, N - 1)]`` for f32, bf16 and int8
tables of any width (the kernel copies bytes).  :func:`gather_rows_cuda`
launches the kernel and takes CUDA tensors only; :func:`gather_rows_plain`
is the plain PyTorch version (``glt_tpu``'s ``_xla_gather``).
:func:`gather_rows` is the seam of ``gather_pallas.gather_rows``: with a
compressed ``dequant`` spec it routes to kernel B4
(:mod:`.gather_dequant_cuda`), else to B2, and picks the kernel or the
plain version by the device the table lies on, and nothing else.

**The autotune seam.**  ``glt_tpu`` sweeps its tiled kernel's (tile_rows,
ring_depth) grid per exact (row width, batch, dtype) and memoizes the
winning point.  Here the points are B2's and B4's launch parameters:
threads per block, the grid cap in blocks per SM and the largest vector
width in bytes (``CANDIDATE_*``; the default point is the launch the
kernels always had).  :func:`autotune_gather_rows` times every point on
the card at warmup and memoizes the fastest for its exact key;
:func:`gather_rows` then launches the memoized point for a CUDA table of
that key, the default point for any other.  The plain version is never a
candidate on the card; on a CPU table nothing is timed and the key pins
"plain" (``glt_tpu`` pins "xla" off the TPU).  Every point copies the
same bytes, so the sweep changes times, never results.  A CUDA graph
records the point it was captured with: a later sweep does not reach a
graph already captured.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs import metrics as _metrics
from . import cuda_lib
from .autotune import check_eager, dtype_name, sweep_ms

GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int8)

# The launch grid autotune_gather_rows sweeps for B2 and B4, and the grid
# the static launch model (analysis/kernelmodel.py, GLT017 and GLT019)
# checks every point of through LAUNCH_MODEL_DOMAIN.  The kernels are
# built for exactly these thread counts (csrc/launch.cuh).
CANDIDATE_THREADS = (128, 256, 512)
CANDIDATE_BLOCKS_PER_SM = (8, 16)
CANDIDATE_VEC_BYTES = (4, 8, 16)

LAUNCH_MODEL_DOMAIN = {
    "threads": CANDIDATE_THREADS,
    "blocks_per_sm": CANDIDATE_BLOCKS_PER_SM,
    "vec_bytes": CANDIDATE_VEC_BYTES,
}

# (threads, blocks per SM, largest vector bytes)
GatherParams = Tuple[int, int, int]

# Decision table: (d, b, dtype name) -> None (plain: a CPU table, never
# timed) | the winning GatherParams.  Filled by autotune_gather_rows.
_AUTO: dict = {}
# Per-key sweep timings: (d, b, dtype name) -> {"t256_c16_v16": ms, ...}.
_AUTO_TIMES: dict = {}


def default_gather_params() -> GatherParams:
    """The launch B2 and B4 always had: 256 threads, 16 blocks an SM,
    16-byte units."""
    return 256, 16, 16


def _runs_as_asked(d: int, dtype: torch.dtype, vec: int,
                   dequant: bool) -> bool:
    """Whether a row of ``d`` values of ``dtype`` lets the kernel use
    ``vec``-byte units (the pitch alone; base alignment is per call).
    B4's unit is its f32 output group: 16 bytes (4 codes) when ``d % 4
    == 0``, else one 4-byte value."""
    if dequant:
        return vec == 4 or (vec == 16 and d % 4 == 0)
    return (int(d) * dtype.itemsize) % vec == 0


def candidate_gather_params(d: int, dtype: torch.dtype = torch.float32,
                            dequant: bool = False) -> list:
    """The points :func:`autotune_gather_rows` sweeps for one shape:
    threads x blocks per SM x vector widths (at most 18), pruned to the
    widths the row pitch lets run as asked (a wider ask would run the
    same launch as a narrower one).  The default point always stays, and
    comes first."""
    default = default_gather_params()
    grid = [(t, c, v) for t in CANDIDATE_THREADS
            for c in CANDIDATE_BLOCKS_PER_SM for v in CANDIDATE_VEC_BYTES
            if _runs_as_asked(d, dtype, v, dequant)]
    return [default] + [p for p in grid if p != default]


def _auto_key(d: int, b: int, dtype: torch.dtype) -> tuple:
    return int(d), int(b), dtype_name(dtype)


def resolve_gather_params(d: int, b: int, dtype: torch.dtype
                          ) -> GatherParams:
    """The point a CUDA table of this exact (row width, batch, dtype)
    launches: the memoized winner, else the default point."""
    return _AUTO.get(_auto_key(d, b, dtype)) or default_gather_params()


def _fmt_params(params: Optional[GatherParams]) -> str:
    if params is None:
        return "plain"
    t, c, v = params
    return f"t{t}_c{c}_v{v}"


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """``table[clamp(idx, 0, N - 1)]`` in plain PyTorch."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rows_cuda takes CUDA tensors, got a "
                         f"table on {dev}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, table on {dev}")
    if table.dtype not in GATHER_DTYPES:
        raise TypeError(f"table must be one of {GATHER_DTYPES}, got "
                        f"{table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [N, d] and idx [B], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if table.shape[0] == 0 and idx.shape[0]:
        raise ValueError("cannot gather from an empty table")


def _launch(table: torch.Tensor, idx: torch.Tensor,
            params: GatherParams) -> torch.Tensor:
    """One launch of B2 at ``params`` on checked inputs (uncounted: the
    sweep's timing launches come here directly)."""
    n, d = table.shape
    b = idx.shape[0]
    dev = table.device
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    threads, per_sm, vec = params
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, b,
            d * table.element_size(), int(threads), int(per_sm), int(vec),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, f"gather_rows_cuda at {_fmt_params(params)}")
    return out


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor,
                     params: Optional[GatherParams] = None
                     ) -> torch.Tensor:
    """Launch kernel B2 on the current stream (no synchronisation) at
    the launch point ``params`` (default: :func:`default_gather_params`);
    a point the kernel is not built for raises."""
    _check(table, idx)
    params = tuple(params) if params is not None else default_gather_params()
    out = _launch(table, idx, params)
    gather_rows_cuda.launches += 1
    by = gather_rows_cuda.launches_by_params
    by[params] = by.get(params, 0) + 1
    return out


gather_rows_cuda.launches = 0
gather_rows_cuda.launches_by_params = {}


def autotune_gather_rows(table: torch.Tensor, idx: torch.Tensor,
                         iters: int = 3, dequant=None) -> str:
    """Sweep the launch points of the kernel :func:`gather_rows` runs for
    this table (B4 with a compressed ``dequant`` spec, else B2) at this
    exact (row width, batch, dtype) and memoize the fastest.

    Call eagerly at warmup (loader construction, a benchmark's set-up),
    before any CUDA graph that should run the winner is captured; inside
    a capture it raises.  A CPU table pins "plain" without timing.
    Returns "cuda" or "plain" (the per-point times are in
    :func:`autotune_table`).  The key holds the exact batch, so a capped
    loader's shape is swept on its own.
    """
    key = _auto_key(table.shape[1], idx.shape[0], table.dtype)
    if key in _AUTO:
        return "plain" if _AUTO[key] is None else "cuda"
    winner, times = None, {}
    if table.device.type == "cuda":
        check_eager("autotune_gather_rows")
        compressed = dequant is not None and dequant.is_compressed
        if compressed:
            from ..store import quant
            from . import gather_dequant_cuda as dq

            sz = quant.scale_zero_tensor(dequant, table.shape[1],
                                         table.device)
            dq.check_gather_inputs(table, idx, sz)

            def launch(p):
                return dq._launch(table, idx, sz, p)
        else:
            _check(table, idx)

            def launch(p):
                return _launch(table, idx, p)

        best = None
        for params in candidate_gather_params(table.shape[1], table.dtype,
                                              dequant=compressed):
            ms = sweep_ms(lambda: launch(params), iters)
            times[_fmt_params(params)] = ms
            if best is None or ms < best:
                best, winner = ms, params
    _AUTO[key] = winner
    _AUTO_TIMES[key] = times
    choice = "plain" if winner is None else "cuda"
    _metrics.counter("glt.gather.autotune_runs",
                     "gather kernel sweep warmups").inc()
    _metrics.gauge("glt.gather.cuda_selected",
                   "1 if the last gather autotune swept the CUDA kernel",
                   labels={"d": str(key[0])},
                   ).set(1.0 if choice == "cuda" else 0.0)
    return choice


def autotune_table() -> dict:
    """The sweep landscape, JSON-ready: ``{"d100_b117248_float32":
    {"winner": "t256_c16_v16", "ms": {"t256_c16_v16": 0.035, ...}},
    ...}``.  An empty ``ms`` means the key was pinned to the plain
    version without a sweep (a CPU table)."""
    out = {}
    for key, winner in _AUTO.items():
        d, b, dt = key
        out[f"d{d}_b{b}_{dt}"] = {
            "winner": _fmt_params(winner),
            "ms": {k: round(v, 5)
                   for k, v in _AUTO_TIMES.get(key, {}).items()},
        }
    return out


def reset_autotune() -> None:
    """Drop all memoized decisions (tests, re-calibration)."""
    _AUTO.clear()
    _AUTO_TIMES.clear()


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                dequant=None) -> torch.Tensor:
    """Row gather: kernel B2 for a CUDA table, at the point memoized for
    its exact shape (:func:`resolve_gather_params`), and the plain
    version for a CPU table.

    ``dequant``: optional :class:`~glt_tpu_torch.store.quant.QuantSpec`
    of a compressed ``table``; the rows then come out decoded to f32,
    through kernel B4 on a CUDA table and through its plain version,
    ``dequantize(gather_rows_plain(...))``, on a CPU table.  ``None`` or a
    raw spec is the plain row gather.
    """
    cuda = table.device.type == "cuda"
    params = (resolve_gather_params(table.shape[1], idx.shape[0],
                                    table.dtype) if cuda else None)
    if dequant is not None and dequant.is_compressed:
        from ..store import quant
        from . import gather_dequant_cuda as dq

        sz = quant.scale_zero_tensor(dequant, table.shape[1], table.device)
        if cuda:
            return dq.gather_rows_dequant_cuda(table, idx, sz, params=params)
        return dq.gather_rows_dequant_plain(table, idx, sz)
    if cuda:
        return gather_rows_cuda(table, idx, params=params)
    return gather_rows_plain(table, idx)
