"""Kernel B1: one hop's neighbor read on the card (``csrc/sample.cu``).

Counterpart of ``glt_tpu/ops/sample_pallas.py``.  Given the drawn
positions ``pos [B, F]`` and their validity ``mask [B, F]`` (the draw of
:func:`glt_tpu_torch.ops.neighbor_sample.draw_positions`), it reads

    nbrs[i, k] = indices[indptr[seeds[i]] + pos[i, k]]   (-1 where ~mask)

and the matching edge ids: ``edge_ids[...]``, the CSR position when the
ids are positional (``edge_ids is None``), or nothing (``with_edge``
False).

:func:`sample_neighbors_cuda` launches the kernel and takes CUDA
tensors only; :func:`sample_neighbors_plain` is the same function in
plain PyTorch (``glt_tpu``'s XLA arithmetic), which the CPU runs and the
card's checks compare against.  :func:`read_neighbors` picks by the
device the tensors lie on, and nothing else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..typing import PADDING_ID
from . import cuda_lib

Reads = Tuple[torch.Tensor, Optional[torch.Tensor]]


def sample_neighbors_plain(indptr: torch.Tensor, seeds: torch.Tensor,
                           pos: torch.Tensor, mask: torch.Tensor,
                           indices: torch.Tensor,
                           edge_ids: Optional[torch.Tensor] = None,
                           with_edge: bool = True) -> Reads:
    """Plain PyTorch neighbor read (``neighbor_sample.py``'s XLA
    epilogue): ``flat = start + where(mask, pos, 0)``, read where valid."""
    safe = torch.where(seeds >= 0, seeds, 0).clamp(max=indptr.shape[0] - 1)
    start = indptr[safe.long()]
    flat = start[:, None] + torch.where(mask, pos, 0)
    # Masked slots may sit one past the edge array (a deg-0 last row);
    # their value is discarded, so clamp them to a readable slot.
    e = indices.shape[0]
    read = flat.clamp(0, max(e - 1, 0)).long()
    pad = torch.full_like(flat, PADDING_ID)
    nbrs = torch.where(mask, indices[read], pad) if e else pad
    if not with_edge:
        return nbrs, None
    if edge_ids is None:
        return nbrs, torch.where(mask, flat, pad).to(torch.int32)
    return nbrs, (torch.where(mask, edge_ids[read], pad) if e else pad)


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


def sample_neighbors_cuda(indptr: torch.Tensor, seeds: torch.Tensor,
                          pos: torch.Tensor, mask: torch.Tensor,
                          indices: torch.Tensor,
                          edge_ids: Optional[torch.Tensor] = None,
                          with_edge: bool = True) -> Reads:
    """Launch kernel B1 on the current stream (no synchronisation)."""
    dev = indices.device
    if dev.type != "cuda":
        raise ValueError("sample_neighbors_cuda takes CUDA tensors, got "
                         f"indices on {dev}")
    _check("indptr", indptr, torch.int32, 1, dev)
    _check("seeds", seeds, torch.int32, 1, dev)
    _check("pos", pos, torch.int32, 2, dev)
    _check("mask", mask, torch.bool, 2, dev)
    _check("indices", indices, torch.int32, 1, dev)
    b, f = pos.shape
    if tuple(mask.shape) != (b, f) or seeds.shape[0] != b:
        raise ValueError(f"seeds {tuple(seeds.shape)}, pos {(b, f)} and "
                         f"mask {tuple(mask.shape)} disagree")
    if edge_ids is not None:
        _check("edge_ids", edge_ids, torch.int32, 1, dev)
        if edge_ids.shape[0] != indices.shape[0]:
            raise ValueError("edge_ids and indices differ in length")
    mode = 0 if not with_edge else (1 if edge_ids is None else 2)
    nbrs = torch.empty((b, f), dtype=torch.int32, device=dev)
    eids = (torch.empty((b, f), dtype=torch.int32, device=dev)
            if mode else None)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_sample_neighbors(
            indptr.data_ptr(), seeds.data_ptr(), pos.data_ptr(),
            mask.data_ptr(), indices.data_ptr(),
            None if edge_ids is None else edge_ids.data_ptr(),
            mode, b, f, nbrs.data_ptr(),
            None if eids is None else eids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "sample_neighbors_cuda")
    sample_neighbors_cuda.launches += 1
    return nbrs, eids


sample_neighbors_cuda.launches = 0


def read_neighbors(indptr, seeds, pos, mask, indices, edge_ids=None,
                   with_edge: bool = True) -> Reads:
    """The neighbor read: kernel B1 for CUDA tensors, the plain version
    for CPU tensors."""
    fn = (sample_neighbors_cuda if indices.device.type == "cuda"
          else sample_neighbors_plain)
    return fn(indptr, seeds, pos, mask, indices, edge_ids, with_edge)
