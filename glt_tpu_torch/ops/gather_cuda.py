"""Kernel B2: the row gather on the card (``csrc/gather.cu``).

Counterpart of ``glt_tpu/ops/gather_pallas.py``:
``out[i] = table[clamp(idx[i], 0, N - 1)]`` for f32, bf16 and int8
tables of any width (the kernel copies bytes).  :func:`gather_rows_cuda`
launches the kernel and takes CUDA tensors only; :func:`gather_rows_plain`
is the plain PyTorch version (``glt_tpu``'s ``_xla_gather``).
:func:`gather_rows` is the seam of ``gather_pallas.gather_rows``: with a
compressed ``dequant`` spec it routes to kernel B4
(:mod:`.gather_dequant_cuda`), else to B2, and picks the kernel or the
plain version by the device the table lies on, and nothing else.
"""
from __future__ import annotations

import torch

from . import cuda_lib

GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """``table[clamp(idx, 0, N - 1)]`` in plain PyTorch."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 on the current stream (no synchronisation)."""
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
    n, d = table.shape
    b = idx.shape[0]
    if n == 0 and b:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_gather_rows(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, b,
            d * table.element_size(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "gather_rows_cuda")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                dequant=None) -> torch.Tensor:
    """Row gather: kernel B2 for a CUDA table, the plain version for a
    CPU table.

    ``dequant``: optional :class:`~glt_tpu_torch.store.quant.QuantSpec`
    of a compressed ``table``; the rows then come out decoded to f32,
    through kernel B4 on a CUDA table and through its plain version,
    ``dequantize(gather_rows_plain(...))``, on a CPU table.  ``None`` or a
    raw spec is the plain row gather.
    """
    if dequant is not None and dequant.is_compressed:
        from ..store import quant
        from . import gather_dequant_cuda as dq

        sz = quant.scale_zero_tensor(dequant, table.shape[1], table.device)
        if table.device.type == "cuda":
            return dq.gather_rows_dequant_cuda(table, idx, sz)
        return dq.gather_rows_dequant_plain(table, idx, sz)
    if table.device.type == "cuda":
        return gather_rows_cuda(table, idx)
    return gather_rows_plain(table, idx)
