"""Graph convolution over padded COO batches (cf.
``glt_tpu/models/conv.py``).

Layers consume ``[2, E]`` COO with -1 padding and an ``edge_mask``;
``edge_index[0]`` is the message source.  Aggregation is ``index_add_``
into a spill row that absorbs padding edges.

Mixed precision: ``dtype`` (e.g. ``torch.bfloat16``) is the compute
type of the two linear maps only; parameters, aggregation and outputs
stay float32, as in ``glt_tpu``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _segments(dst: torch.Tensor, num_nodes: int, mask: torch.Tensor
              ) -> torch.Tensor:
    """Destination rows; masked edges and ids outside ``[0, num_nodes)``
    go to the spill row ``num_nodes`` (a jax segment sum drops them)."""
    keep = mask & (dst >= 0) & (dst < num_nodes)
    return torch.where(keep, dst, num_nodes).long()


def scatter_sum(msgs: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum messages into destination slots; -1/masked edges go to a spill
    row."""
    if mask is None:
        mask = dst >= 0
    seg = _segments(dst, num_nodes, mask)
    msgs = torch.where(mask[:, None], msgs, 0)
    out = msgs.new_zeros((num_nodes + 1,) + tuple(msgs.shape[1:]))
    return out.index_add_(0, seg, msgs)[:num_nodes]


def scatter_mean(msgs: torch.Tensor, dst: torch.Tensor, num_nodes: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        mask = dst >= 0
    s = scatter_sum(msgs, dst, num_nodes, mask)
    seg = _segments(dst, num_nodes, mask)
    cnt = msgs.new_zeros(num_nodes + 1).index_add_(0, seg, mask.to(msgs.dtype))
    return s / cnt[:num_nodes].clamp(min=1)[:, None]


class SAGEConv(nn.Module):
    """GraphSAGE convolution (mean aggregator):
    ``h_i = W_self x_i + b + W_nbr mean_{j->i} x_j``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin_self = nn.Linear(in_features, out_features, bias=use_bias)
        self.lin_nbr = nn.Linear(in_features, out_features, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        # index_select, not x[idx]: the same rows, but its backward is an
        # atomic index_add_, where x[idx]'s sorts the ids and sums each
        # run of equal ids serially, and every padded edge reads row 0.
        msgs = x.index_select(0, src.clamp(0, max(num_nodes - 1, 0)).long())
        agg = scatter_mean(msgs, dst, num_nodes, edge_mask)
        if self.dtype is None:
            return self.lin_self(x) + self.lin_nbr(agg)
        dt = self.dtype
        bias = self.lin_self.bias
        out = (F.linear(x.to(dt), self.lin_self.weight.to(dt),
                        None if bias is None else bias.to(dt))
               + F.linear(agg.to(dt), self.lin_nbr.weight.to(dt)))
        return out.float()
