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
"""
from __future__ import annotations

from typing import Optional

import torch

from ..typing import PADDING_ID
from . import cuda_lib
from .neighbor_sample import (
    NeighborOutput,
    _row_offsets_and_degrees,
    draw_positions,
)

KEY_BY = ("slot", "id")
# Without replacement a row's picks sit in its lanes' registers: at most
# 64 a lane over 32 lanes (``csrc/sample.cu``).
MAX_FANOUT = 32 * 64


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


def sample_neighbors_cuda(indptr: torch.Tensor, indices: torch.Tensor,
                          seeds: torch.Tensor, fanout: int,
                          key: torch.Tensor,
                          edge_ids: Optional[torch.Tensor] = None,
                          with_replacement: bool = False,
                          with_edge: bool = True,
                          key_by: str = "slot") -> NeighborOutput:
    """Launch kernel B1 on the current stream (no synchronisation)."""
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
    mode = 0 if not with_edge else (1 if edge_ids is None else 2)
    nbrs = torch.empty((b, fanout), dtype=torch.int32, device=dev)
    eids = (torch.empty((b, fanout), dtype=torch.int32, device=dev)
            if mode else None)
    mask = torch.empty((b, fanout), dtype=torch.bool, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_sample_neighbors(
            indptr.data_ptr(), indptr.shape[0], indices.data_ptr(),
            None if edge_ids is None else edge_ids.data_ptr(),
            seeds.data_ptr(), key.data_ptr(), b, fanout,
            int(with_replacement), int(key_by == "id"), mode,
            nbrs.data_ptr(), None if eids is None else eids.data_ptr(),
            mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "sample_neighbors_cuda")
    sample_neighbors_cuda.launches += 1
    return NeighborOutput(nbrs=nbrs, eids=eids, mask=mask)


sample_neighbors_cuda.launches = 0
