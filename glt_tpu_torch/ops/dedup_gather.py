"""Dedup-aware feature row gather: fetch each unique row once (cf.
``glt_tpu/ops/dedup_gather.py``).

unique (first-occurrence order) -> row gather of the uniques -> expand
the rows back to every original position.  The output is bit-identical
to the naive masked gather ``where(ids >= 0, table[id2index[ids]], 0)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .gather_cuda import gather_rows
from .unique import unique_first_occurrence


def dedup_gather_rows(table: torch.Tensor, ids: torch.Tensor,
                      id2index: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Gather ``table`` rows for (duplicated, -1-padded) ``ids``; padding
    gives zero rows.  ``id2index`` (optional ``[N]``) maps unique ids to
    table rows, clamped into range as a jax gather clamps."""
    ids = ids.to(torch.int32)
    uniq, inv, _ = unique_first_occurrence(ids)
    uvalid = uniq >= 0
    uidx = torch.where(uvalid, uniq, 0)
    if id2index is not None:
        uidx = id2index[uidx.clamp(max=id2index.shape[0] - 1).long()]
    rows = gather_rows(table, uidx.contiguous())
    urows = torch.where(uvalid[:, None], rows, 0)
    out = urows[inv.clamp(0, max(inv.shape[0] - 1, 0)).long()]
    return torch.where((inv >= 0)[:, None], out, 0)


def dedup_counts(ids: torch.Tensor) -> tuple:
    """``(valid, unique)`` id counts of ``ids`` as 0-d int32 tensors on
    its device (the dedup ratio is ``valid / unique``); no host sync."""
    ids = ids.to(torch.int32)
    valid = (ids >= 0).sum(dtype=torch.int32)
    return valid, unique_first_occurrence(ids).count
