"""Kernel B4: the dequantizing row gather on the card
(``csrc/gather_dequant.cu``).

Counterpart of ``glt_tpu/ops/gather_pallas.py``'s
``gather_rows_pallas_dq``: over a compressed table (``torch.int8`` codes
or ``torch.bfloat16``) of any width,

    out[i] = dequant(table[clamp(idx[i], 0, N - 1)])      (float32)

with ``sz`` the ``[8, d]`` f32 :func:`~glt_tpu_torch.store.quant.
scale_zero_rows` input on the table's device; the codec follows from the
table's dtype (bf16 widens, int8 decodes affinely).
:func:`gather_rows_dequant_cuda` launches the kernel and takes CUDA
tensors only; :func:`gather_rows_dequant_plain` is the plain PyTorch
version (``glt_tpu``'s XLA arm, ``dequantize(_xla_gather(...))``).
"""
from __future__ import annotations

import torch

from ..store.quant import SCALE_ZERO_ROWS, dequantize_rows
from . import cuda_lib
from .gather_cuda import gather_rows_plain

# Storage dtype -> the kernels' codec number (csrc/dequant.cuh glt::Codec).
DEQUANT_CODECS = {torch.bfloat16: 0, torch.int8: 1}


def gather_rows_dequant_plain(table: torch.Tensor, idx: torch.Tensor,
                              sz: torch.Tensor) -> torch.Tensor:
    """``dequant(table[clamp(idx, 0, N - 1)])`` in plain PyTorch."""
    return dequantize_rows(gather_rows_plain(table, idx), sz)


def check_dequant_inputs(name: str, table: torch.Tensor, sz: torch.Tensor
                         ) -> None:
    """The checks B4 and B5 share on the table and ``sz``."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got a table on {dev}")
    if table.dtype not in DEQUANT_CODECS:
        raise TypeError(f"table must be one of {tuple(DEQUANT_CODECS)}, "
                        f"got {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous [N, d] tensor, got "
                         f"shape {tuple(table.shape)}")
    want = (SCALE_ZERO_ROWS, table.shape[1])
    if sz.device != dev or sz.dtype != torch.float32:
        raise TypeError(f"sz must be float32 on {dev}, got {sz.dtype} on "
                        f"{sz.device}")
    if tuple(sz.shape) != want or not sz.is_contiguous():
        raise ValueError(f"sz must be a contiguous {want} tensor, got "
                         f"{tuple(sz.shape)}")


def gather_rows_dequant_cuda(table: torch.Tensor, idx: torch.Tensor,
                             sz: torch.Tensor) -> torch.Tensor:
    """Launch kernel B4 on the current stream (no synchronisation)."""
    check_dequant_inputs("gather_rows_dequant_cuda", table, sz)
    dev = table.device
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, table on {dev}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"idx must be 1-D and contiguous, got shape "
                         f"{tuple(idx.shape)}")
    n, d = table.shape
    b = idx.shape[0]
    if n == 0 and b:
        raise ValueError("cannot gather from an empty table")
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_gather_rows_dequant(
            table.data_ptr(), idx.data_ptr(), sz.data_ptr(), out.data_ptr(),
            n, b, d, DEQUANT_CODECS[table.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "gather_rows_dequant_cuda")
    gather_rows_dequant_cuda.launches += 1
    return out


gather_rows_dequant_cuda.launches = 0
