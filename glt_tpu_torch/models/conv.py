"""Graph convolution over padded COO batches (cf.
``glt_tpu/models/conv.py``).

Layers consume ``[2, E]`` COO with -1 padding and an ``edge_mask``;
``edge_index[0]`` is the message source.  Aggregation is ``index_add_``
into a spill row that absorbs padding edges; the attention layers'
segment max is ``scatter_reduce_("amax")`` over a ``-inf`` buffer.

Mixed precision: ``dtype`` (e.g. ``torch.bfloat16``) is the compute
type of the linear maps only; parameters, aggregation, the attention
math and outputs stay float32, as in ``glt_tpu``.
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


def linear(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(x)``, its matmul in ``dtype`` when one is given (flax's
    ``Dense(dtype=...)``), the result float32."""
    if dtype is None:
        return lin(x)
    bias = lin.bias
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if bias is None else bias.to(dtype)).float()


def segment_max(scores: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max of ``scores`` ``[E, ...]`` over ``num_segments``
    rows (``seg`` in range); an empty segment holds ``-inf``."""
    out = scores.new_full((num_segments,) + tuple(scores.shape[1:]),
                          float("-inf"))
    idx = seg.view((-1,) + (1,) * (scores.dim() - 1)).expand_as(scores)
    return out.scatter_reduce_(0, idx, scores, "amax", include_self=True)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = vals.new_zeros((num_segments,) + tuple(vals.shape[1:]))
    return out.index_add_(0, seg, vals)


def clamped_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(min(x, 0))``.  Valid lanes have ``x <= 0`` already; masked
    lanes read the spill row's reset max and would overflow ``exp`` into
    ``inf`` (then NaN gradients through the mask) without the clamp."""
    return torch.exp(torch.minimum(x, x.new_zeros(())))


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor,
                    num_segments: int, mask: torch.Tensor) -> torch.Tensor:
    """Softmax of ``scores`` ``[E]`` or ``[E, heads]`` over the edges of
    each destination ``seg``, masked lanes 0.

    The max per segment starts from ``-inf``; a segment with no valid
    lane resets it to 0, and the exponent is clamped at 0
    (:func:`clamped_exp`), as in ``glt_tpu``.
    """
    seg_safe = _segments(seg, num_segments, mask)
    m = mask.view((-1,) + (1,) * (scores.dim() - 1))
    smax = segment_max(torch.where(m, scores, float("-inf")), seg_safe,
                       num_segments + 1)
    smax = torch.where(torch.isfinite(smax), smax, 0)
    # index_select, not smax[seg_safe]: the same values, but an atomic
    # index_add_ backward instead of a sort of the segment ids.
    ex = torch.where(m, clamped_exp(scores - smax.index_select(0, seg_safe)),
                     0)
    denom = segment_sum(ex, seg_safe, num_segments + 1)
    return ex / denom.index_select(0, seg_safe).clamp(min=1e-16)


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


class GATConv(nn.Module):
    """Graph attention convolution (GATv1, multi-head): per head,
    ``alpha = softmax_j(leaky_relu(a_src . z_j + a_dst . z_i))`` over
    the edges into ``i``, ``out_i = sum_j alpha z_j``; heads
    concatenated (``concat``) or averaged, plus a bias.  Only the
    linear map runs in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.out_features = heads, out_features
        self.concat = concat
        self.negative_slope = negative_slope
        self.dtype = dtype
        self.lin = nn.Linear(in_features, heads * out_features, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, out_features))
        self.att_dst = nn.Parameter(torch.empty(heads, out_features))
        self.bias = nn.Parameter(torch.zeros(
            heads * out_features if concat else out_features))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        h, f = self.heads, self.out_features
        src, dst = edge_index[0], edge_index[1]
        src_c = src.clamp(0, max(n - 1, 0)).long()
        dst_c = dst.clamp(0, max(n - 1, 0)).long()
        z = linear(self.lin, x, self.dtype).reshape(n, h, f)
        alpha_src = (z * self.att_src).sum(-1)                # [N, h]
        alpha_dst = (z * self.att_dst).sum(-1)
        e = F.leaky_relu(alpha_src.index_select(0, src_c)
                         + alpha_dst.index_select(0, dst_c),
                         self.negative_slope)                 # [E, h]
        alpha = segment_softmax(e, dst, n, edge_mask)
        msgs = z.index_select(0, src_c) * alpha[:, :, None]  # [E, h, f]
        out = scatter_sum(msgs.reshape(-1, h * f), dst, n,
                          edge_mask).reshape(n, h, f)
        out = out.reshape(n, h * f) if self.concat else out.mean(dim=1)
        return out + self.bias
