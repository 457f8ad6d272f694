"""Hetero sampler-output merge and format helpers, cf.
``glt_tpu/utils/common.py``: used where per-edge-type partial results
(e.g. from distributed hetero sampling) are combined into one
:class:`~glt_tpu_torch.sampler.base.HeteroSamplerOutput`.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..sampler.base import HeteroSamplerOutput


def _cat(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return torch.cat([a, b])


def merge_hetero_sampler_output(
        a: HeteroSamplerOutput, b: HeteroSamplerOutput) -> HeteroSamplerOutput:
    """Concatenate two hetero outputs type by type.  Edges keep their
    local indices within each source output; callers relabel when node
    lists merge, as in the reference's merge."""
    def md(da, db):
        if da is None:
            return db
        if db is None:
            return da
        out = dict(da)
        for k, v in db.items():
            out[k] = _cat(out.get(k), v)
        return out

    return HeteroSamplerOutput(
        node=md(a.node, b.node),
        row=md(a.row, b.row),
        col=md(a.col, b.col),
        edge=md(a.edge, b.edge),
        batch=md(a.batch, b.batch),
        node_mask=md(a.node_mask, b.node_mask),
        edge_mask=md(a.edge_mask, b.edge_mask),
        input_type=a.input_type or b.input_type,
        metadata=a.metadata or b.metadata,
    )


def format_hetero_sampler_output(
        out: HeteroSamplerOutput) -> HeteroSamplerOutput:
    """Drop empty edge-type entries (zero-length tensors), the
    reference's tidy-up before building HeteroData."""
    keep = [et for et, r in out.row.items() if r.shape[0] > 0]

    def pick(d):
        return None if d is None else {k: d[k] for k in keep if k in d}

    return HeteroSamplerOutput(
        node=out.node,
        row=pick(out.row),
        col=pick(out.col),
        edge=pick(out.edge),
        batch=out.batch,
        node_mask=out.node_mask,
        edge_mask=pick(out.edge_mask),
        num_sampled_nodes=out.num_sampled_nodes,
        num_sampled_edges=pick(out.num_sampled_edges),
        input_type=out.input_type,
        metadata=out.metadata,
    )
