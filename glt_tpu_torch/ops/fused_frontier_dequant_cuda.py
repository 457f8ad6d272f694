"""Kernel B5: the dequantizing fused frontier gather on the card
(``csrc/fused_frontier_dequant.cu``).

Counterpart of ``glt_tpu/ops/fused_frontier.py``'s ``_fused_gather_dq``
plus its zero epilogue: given the first-occurrence unique rows ``uidx``
and the inverse map ``inv`` of
:func:`~glt_tpu_torch.ops.fused_frontier.frontier_plan`, over a
compressed table (``torch.int8`` or ``torch.bfloat16``),

    out[i] = dequant(table[clamp(uidx[inv[i]], 0, N - 1)]) if inv[i] >= 0
             else 0.0                                          (float32)

:func:`fused_frontier_dequant_cuda` launches the kernel and takes CUDA
tensors only; :func:`fused_frontier_dequant_plain` is the plain PyTorch
version (``glt_tpu``'s fallback: gather the unique rows with dequant,
expand them to every position, zero the padding).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .gather_dequant_cuda import (
    DEQUANT_CODECS,
    check_dequant_inputs,
    gather_rows_dequant_plain,
)


def fused_frontier_dequant_plain(table: torch.Tensor, uidx: torch.Tensor,
                                 inv: torch.Tensor, sz: torch.Tensor
                                 ) -> torch.Tensor:
    """The unfused dequant gather in plain PyTorch, ``glt_tpu``'s
    fallback: unique rows decoded once, then one row per position, zeros
    at padding (after the decode).  The fallback's mask of the unused
    unique slots is left out: ``inv`` points at live slots only, so it
    changes no output."""
    urows = gather_rows_dequant_plain(table, uidx, sz)
    rows = urows[inv.clamp(0, max(inv.shape[0] - 1, 0)).long()]
    return torch.where((inv >= 0)[:, None], rows, 0.0)


def fused_frontier_dequant_cuda(table: torch.Tensor, uidx: torch.Tensor,
                                inv: torch.Tensor, sz: torch.Tensor
                                ) -> torch.Tensor:
    """Launch kernel B5 on the current stream (no synchronisation)."""
    check_dequant_inputs("fused_frontier_dequant_cuda", table, sz)
    dev = table.device
    for name, t in (("uidx", uidx), ("inv", inv)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, table on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be 1-D and contiguous, got "
                             f"shape {tuple(t.shape)}")
    b = inv.shape[0]
    if uidx.shape[0] != b:
        raise ValueError(f"uidx {tuple(uidx.shape)} and inv "
                         f"{tuple(inv.shape)} differ in length")
    n, d = table.shape
    if n == 0 and b:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_fused_frontier_dequant(
            table.data_ptr(), uidx.data_ptr(), inv.data_ptr(),
            sz.data_ptr(), out.data_ptr(), n, b, d,
            DEQUANT_CODECS[table.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "fused_frontier_dequant_cuda")
    fused_frontier_dequant_cuda.launches += 1
    return out


fused_frontier_dequant_cuda.launches = 0
