"""Graph convolution over padded COO batches (cf.
``glt_tpu/models/conv.py``).

Layers consume ``[2, E]`` COO with -1 padding and an ``edge_mask``;
``edge_index[0]`` is the message source.  Aggregation is ``index_add_``
into a spill row that absorbs padding edges; the attention layers'
segment max is ``scatter_reduce_("amax")`` over a ``-inf`` buffer.

Mixed precision: ``dtype`` (e.g. ``torch.bfloat16``) is the compute
type of the linear maps only; parameters, aggregation, the attention
math and outputs stay float32, as in ``glt_tpu``.

Trimming: :class:`SAGEConv` and :class:`GATConv` also run on a bipartite
pair, the rows ``x`` as sources and their prefix ``x[:num_out]`` as
destinations.  A stack given the hop prefixes of a sampled block
(:func:`~glt_tpu_torch.sampler.neighbor_sampler.hop_prefixes`) computes
each layer only where the last layer's first rows depend on it
(:func:`layer_spans`): PyG's ``trim_to_layer``.  It relies on the
sampler's layout: nodes in first-occurrence order, hop by hop; hop
``k``'s edge slots after hop ``k - 1``'s; and each node expanded at most
once, so a row's in-edges lie in one hop.  The scanned node train step
passes the prefixes for a batch of ``batch_size`` distinct seeds, since
its loss reads only the seed rows; every other caller, and that step's
ragged batches, run the whole block.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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


Span = Optional[Tuple[int, int, int]]
# A block's hop prefixes ``(nodes, edges)``: the sampler's ``HopPrefixes``.
Bounds = Optional[Tuple[Sequence[int], Sequence[int]]]


def layer_spans(num_layers: int, num_rows: int, num_edges: int,
                bounds: Bounds = None) -> List[Span]:
    """``(input rows, output rows, edge slots)`` of each layer of a
    ``num_layers`` stack over a block of ``num_rows`` rows and
    ``num_edges`` edge slots.

    Without ``bounds`` every layer spans the whole block (``None``).
    With the block's hop prefixes ``bounds = (nodes, edges)`` (``nodes``
    ending at ``num_rows``, ``edges`` at ``num_edges``), layer ``l`` of
    ``L`` reads rows ``[0, nodes[L - l])`` and edges ``[0, edges[L - 1 -
    l])`` and writes rows ``[0, nodes[L - 1 - l])``.  Those rows hold
    the nodes within ``L - 1 - l`` hops, whose in-edges and sources the
    spans hold, and they are all the next layer reads: so the last
    layer's seed rows are those of the whole block.  A prefix past the
    listed hops is the whole block."""
    if bounds is None:
        return [None] * num_layers
    nodes, edges = bounds
    if nodes[-1] != num_rows or edges[-1] != num_edges:
        raise ValueError(
            f"hop prefixes end at {nodes[-1]} rows and {edges[-1]} edge "
            f"slots; the block has {num_rows} and {num_edges}")

    def rows(k):
        return nodes[k] if k < len(nodes) else num_rows

    def slots(k):
        return edges[k] if k < len(edges) else num_edges

    last = num_layers - 1
    return [(rows(last + 1 - l), rows(last - l), slots(last - l))
            for l in range(num_layers)]


def on_span(conv: nn.Module, x: torch.Tensor, edge_index: torch.Tensor,
            edge_mask: torch.Tensor, span: Span) -> torch.Tensor:
    """``conv`` over one layer's span of :func:`layer_spans`, reading
    views of the rows and edge slots it spans; the whole block for
    ``None``."""
    if span is None:
        return conv(x, edge_index, edge_mask)
    rows_in, rows_out, slots = span
    return conv(x[:rows_in], edge_index[:, :slots], edge_mask[:slots],
                num_out=rows_out)


def linear(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``lin(x)``, its matmul in ``dtype`` when one is given (flax's
    ``Dense(dtype=...)``), the result float32."""
    if dtype is None:
        return lin(x)
    bias = lin.bias
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if bias is None else bias.to(dtype)).float()


class _HeadScores(torch.autograd.Function):
    """``(z * att).sum(-1)`` of a 16-bit ``z`` ``[n, heads, f]``, in
    float32, keeping ``z`` itself for the backward instead of its
    float32 copy (whose values are the same)."""

    @staticmethod
    def forward(ctx, z, att):
        ctx.save_for_backward(z, att)
        return (z.float() * att).sum(-1)

    @staticmethod
    def backward(ctx, g):
        z, att = ctx.saved_tensors
        g = g[:, :, None]
        return (g * att).to(z.dtype), (g * z.float()).sum(0)


class _WeightedRows(torch.autograd.Function):
    """``z[src] * alpha[..., None]`` in float32 from a 16-bit ``z``,
    reading the rows again in the backward instead of keeping the
    ``[E, heads, f]`` float32 gather."""

    @staticmethod
    def forward(ctx, z, src, alpha):
        ctx.save_for_backward(z, src, alpha)
        return z.index_select(0, src).float() * alpha[:, :, None]

    @staticmethod
    def backward(ctx, g):
        z, src, alpha = ctx.saved_tensors
        g_alpha = (g * z.index_select(0, src).float()).sum(-1)
        g_z = torch.zeros(z.shape, dtype=torch.float32,
                          device=z.device).index_add_(
                              0, src, g * alpha[:, :, None])
        return g_z.to(z.dtype), None, g_alpha


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
    ``h_i = W_self x_i + b + W_nbr mean_{j->i} x_j``, over all rows of
    ``x`` or, given ``num_out``, over the bipartite pair of the rows
    ``x`` (sources) and ``x[:num_out]`` (destinations)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.lin_self = nn.Linear(in_features, out_features, bias=use_bias)
        self.lin_nbr = nn.Linear(in_features, out_features, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor,
                num_out: Optional[int] = None) -> torch.Tensor:
        """Rows ``[0, num_out)`` (all rows by default) from source rows
        ``x``: edges whose destination lies past ``num_out`` go to the
        spill row, as masked ones do."""
        num_in = x.shape[0]
        num_out = num_in if num_out is None else num_out
        src, dst = edge_index[0], edge_index[1]
        # index_select, not x[idx]: the same rows, but its backward is an
        # atomic index_add_, where x[idx]'s sorts the ids and sums each
        # run of equal ids serially, and every padded edge reads row 0.
        msgs = x.index_select(0, src.clamp(0, max(num_in - 1, 0)).long())
        agg = scatter_mean(msgs, dst, num_out, edge_mask)
        x = x[:num_out]
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
                edge_mask: torch.Tensor,
                num_out: Optional[int] = None) -> torch.Tensor:
        """Rows ``[0, num_out)`` (all rows by default), as
        :meth:`SAGEConv.forward`."""
        m = x.shape[0] if num_out is None else num_out
        z = self.project(x)
        return self.attend(z, z[:m], edge_index, edge_mask)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """``z = W x`` as ``[n, heads, out_features]``, float32 or, with a
        ``dtype``, in that dtype (:meth:`attend` keeps those 16-bit rows
        for its backward, not a float32 copy)."""
        if self.dtype is None:
            z = self.lin(x)
        else:
            z = F.linear(x.to(self.dtype), self.lin.weight.to(self.dtype))
        return z.reshape(x.shape[0], self.heads, self.out_features)

    def attend(self, z_src: torch.Tensor, z_dst: torch.Tensor,
               edge_index: torch.Tensor,
               edge_mask: torch.Tensor) -> torch.Tensor:
        """The attention over projected rows: ``edge_index[0]`` indexes
        ``z_src``, ``edge_index[1]`` the output rows, which are those of
        ``z_dst``; heads combined, plus the bias.  The scores, softmax,
        messages and sums run in float32 whatever ``z``'s dtype; of 16-bit
        rows the backward keeps the rows themselves."""
        n, m = z_src.shape[0], z_dst.shape[0]
        h, f = self.heads, self.out_features
        src, dst = edge_index[0], edge_index[1]
        src_c = src.clamp(0, max(n - 1, 0)).long()
        dst_c = dst.clamp(0, max(m - 1, 0)).long()
        lean = z_src.dtype != torch.float32
        if lean:
            alpha_src = _HeadScores.apply(z_src, self.att_src)
            alpha_dst = _HeadScores.apply(z_dst, self.att_dst)
        else:
            alpha_src = (z_src * self.att_src).sum(-1)        # [N, h]
            alpha_dst = (z_dst * self.att_dst).sum(-1)
        e = F.leaky_relu(alpha_src.index_select(0, src_c)
                         + alpha_dst.index_select(0, dst_c),
                         self.negative_slope)                 # [E, h]
        alpha = segment_softmax(e, dst, m, edge_mask)
        if lean:
            msgs = _WeightedRows.apply(z_src, src_c, alpha)
        else:
            msgs = z_src.index_select(0, src_c) * alpha[:, :, None]
        out = scatter_sum(msgs.reshape(-1, h * f), dst, m,
                          edge_mask).reshape(m, h, f)
        out = out.reshape(m, h * f) if self.concat else out.mean(dim=1)
        return out + self.bias
