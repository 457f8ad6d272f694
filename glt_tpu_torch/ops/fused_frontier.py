"""Fused frontier dedup + feature gather (cf.
``glt_tpu/ops/fused_frontier.py``).

The ordering stays in plain PyTorch ops:
:func:`~glt_tpu_torch.ops.unique.unique_first_occurrence` gives the
first-occurrence unique ids and the inverse map.  The bytes move in one
launch of kernel B3 (:mod:`.fused_frontier_cuda`) on a CUDA table, or
through its plain version (the unfused dedup gather) on a CPU table.
``features`` equals ``where(ids >= 0, table[id2index[ids]], 0)`` bit for
bit either way.  With a compressed ``dequant`` spec the rows come out
decoded to f32: one launch of kernel B5
(:mod:`.fused_frontier_dequant_cuda`) on a CUDA table, its plain version
(``glt_tpu``'s unfused fallback) on a CPU table; the padding rows are
zeroed after the decode.

``glt_tpu`` gates its kernel on a VMEM budget and on ``d % 128 == 0``
and keeps a ``force`` seam; here the gate is the kernels' own (a 2-D
f32, bf16 or int8 table, any width, any batch) and the device picks
the route.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..store import quant
from .fused_frontier_cuda import (
    FUSED_DTYPES,
    fused_frontier_cuda,
    fused_frontier_plain,
)
from .fused_frontier_dequant_cuda import (
    fused_frontier_dequant_cuda,
    fused_frontier_dequant_plain,
)
from .unique import unique_first_occurrence


class FusedFrontier(NamedTuple):
    """Frontier ids deduped and their features gathered."""
    unique_ids: torch.Tensor  # [B] first-occurrence unique ids, -1 padded
    inverse: torch.Tensor     # [B] position -> unique slot, -1 at padding
    features: torch.Tensor    # [B, d], equal to the masked row gather


def fused_frontier_supported(table: torch.Tensor) -> bool:
    """Whether kernel B3 takes ``table``: a 2-D tensor of a storage dtype
    (f32, bf16 or int8); B5 takes its bf16 and int8 tables."""
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
    through kernel B3 (B5 with a compressed ``dequant`` spec), which
    raises on what it does not take; a CPU table through the plain
    version."""
    uniq, inv, uidx = frontier_plan(ids, id2index)
    on_card = table.device.type == "cuda"
    if dequant is not None and dequant.is_compressed:
        sz = quant.scale_zero_tensor(dequant, table.shape[1], table.device)
        fn = (fused_frontier_dequant_cuda if on_card
              else fused_frontier_dequant_plain)
        x = fn(table, uidx, inv, sz)
    else:
        fn = fused_frontier_cuda if on_card else fused_frontier_plain
        x = fn(table, uidx, inv)
    return FusedFrontier(unique_ids=uniq, inverse=inv, features=x)
