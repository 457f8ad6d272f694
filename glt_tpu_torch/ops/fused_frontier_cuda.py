"""Kernel B3: the fused frontier gather on the card
(``csrc/fused_frontier.cu``).

Counterpart of ``glt_tpu/ops/fused_frontier.py``'s ``_fused_gather``
plus its zero epilogue: given the first-occurrence unique rows ``uidx``
(``[B]`` int32, already mapped through ``id2index``) and the inverse map
``inv`` (``[B]`` int32, -1 at padding) of
:func:`~glt_tpu_torch.ops.unique.unique_first_occurrence`,

    out[i] = table[clamp(uidx[inv[i]], 0, N - 1)] if inv[i] >= 0 else 0

:func:`fused_frontier_cuda` launches the kernel and takes CUDA tensors
only; :func:`fused_frontier_plain` is the plain PyTorch version (the
unfused branch of ``glt_tpu``'s ``fused_frontier``: gather the unique
rows, expand them to every position, zero the padding).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .gather_cuda import GATHER_DTYPES, gather_rows_plain

FUSED_DTYPES = GATHER_DTYPES


def fused_frontier_plain(table: torch.Tensor, uidx: torch.Tensor,
                         inv: torch.Tensor) -> torch.Tensor:
    """The unfused dedup gather in plain PyTorch: unique rows once, then
    one row per position, zeros at padding."""
    urows = gather_rows_plain(table, uidx)
    rows = urows[inv.clamp(0, max(inv.shape[0] - 1, 0)).long()]
    return torch.where((inv >= 0)[:, None], rows, 0)


def fused_frontier_cuda(table: torch.Tensor, uidx: torch.Tensor,
                        inv: torch.Tensor) -> torch.Tensor:
    """Launch kernel B3 on the current stream (no synchronisation)."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"fused_frontier_cuda takes CUDA tensors, got a "
                         f"table on {dev}")
    for name, t in (("uidx", uidx), ("inv", inv)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got "
                             f"shape {tuple(t.shape)}")
    if table.dtype not in FUSED_DTYPES:
        raise TypeError(f"table must be one of {FUSED_DTYPES}, got "
                        f"{table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [N, d] tensor, got "
                         f"shape {tuple(table.shape)}")
    b = inv.shape[0]
    if uidx.shape[0] != b:
        raise ValueError(f"uidx {tuple(uidx.shape)} and inv "
                         f"{tuple(inv.shape)} differ in length")
    n, d = table.shape
    if n == 0 and b:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_fused_frontier(
            table.data_ptr(), uidx.data_ptr(), inv.data_ptr(),
            out.data_ptr(), n, b, d * table.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "fused_frontier_cuda")
    fused_frontier_cuda.launches += 1
    return out


fused_frontier_cuda.launches = 0
