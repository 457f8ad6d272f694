"""Fused frontier dedup + feature gather (cf.
``glt_tpu/ops/fused_frontier.py``).

The ordering stays in plain PyTorch ops:
:func:`~glt_tpu_torch.ops.unique.unique_first_occurrence` gives the
first-occurrence unique ids and the inverse map.  The bytes move in one
launch of kernel B3 (:mod:`.fused_frontier_cuda`) on a CUDA table, or
through its plain version (the unfused dedup gather) on a CPU table.
``features`` equals ``where(ids >= 0, table[id2index[ids]], 0)`` bit for
bit either way.

``glt_tpu`` gates its kernel on a VMEM budget and on ``d % 128 == 0``
and keeps a ``force`` seam; here the gate is the kernel's own (a 2-D
f32 or bf16 table, any width, any batch) and the device picks the
route.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .fused_frontier_cuda import (
    FUSED_DTYPES,
    fused_frontier_cuda,
    fused_frontier_plain,
)
from .unique import unique_first_occurrence


class FusedFrontier(NamedTuple):
    """Frontier ids deduped and their features gathered."""
    unique_ids: torch.Tensor  # [B] first-occurrence unique ids, -1 padded
    inverse: torch.Tensor     # [B] position -> unique slot, -1 at padding
    features: torch.Tensor    # [B, d], equal to the masked row gather


def fused_frontier_supported(table: torch.Tensor) -> bool:
    """Whether kernel B3 takes ``table``: a 2-D f32 or bf16 tensor."""
    return table.dim() == 2 and table.dtype in FUSED_DTYPES


def frontier_plan(ids: torch.Tensor,
                  id2index: Optional[torch.Tensor] = None):
    """The ordering half: ``(unique_ids, inverse, uidx)`` with ``uidx``
    the table row of each unique slot (0 at padding), ready for kernel
    B3.  ``id2index`` (optional ``[N]``) maps unique ids to table rows,
    clamped into range as a jax gather clamps."""
    uniq, inv, _ = unique_first_occurrence(ids.to(torch.int32))
    uidx = torch.where(uniq >= 0, uniq, 0)
    if id2index is not None:
        uidx = id2index[uidx.clamp(max=id2index.shape[0] - 1).long()]
    return uniq, inv.contiguous(), uidx.to(torch.int32).contiguous()


def fused_frontier(table: torch.Tensor, ids: torch.Tensor,
                   id2index: Optional[torch.Tensor] = None,
                   dequant=None) -> FusedFrontier:
    """Dedup ``ids`` ``[B]`` (-1 padded) and gather their ``table`` rows
    (``id2index`` as in :func:`frontier_plan`).  A CUDA table goes
    through kernel B3, which raises on what it does not take; a CPU
    table through the plain version."""
    if dequant is not None:
        raise NotImplementedError(
            "fused_frontier(dequant=...) needs the compressed feature "
            "store and its kernel (B5), which are not ported yet")
    uniq, inv, uidx = frontier_plan(ids, id2index)
    if table.device.type == "cuda":
        x = fused_frontier_cuda(table, uidx, inv)
    else:
        x = fused_frontier_plain(table, uidx, inv)
    return FusedFrontier(unique_ids=uniq, inverse=inv, features=x)
