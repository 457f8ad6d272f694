"""Heterogeneous Graph Transformer over hetero batches (cf.
``glt_tpu/models/hgt.py``; Hu et al., WWW 2020).

Type-specific K/Q/V projections, per-edge-type attention and message
maps with a learned relation prior, attention normalised **jointly over
every edge type** into a destination node (a shared per-(node, head) max
and one denominator, accumulated in ``edge_types`` order), and a gated
residual per node type.  Same batch interface as
:class:`~glt_tpu_torch.models.rgat.RGAT`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..typing import EdgeType, as_str
from .conv import clamped_exp, linear, segment_max, segment_sum
from .rgat import layer_dropout, layer_keys


class HGTConv(nn.Module):
    """One HGT layer over the node types of ``node_types``.

    Attention of edge ``s -> t`` of type ``et``, head ``i``:
    ``(K_i(s) W_att[et, i] . Q_i(t)) mu[et, i] / sqrt(d)``, softmaxed
    over all edges into ``t``; messages ``V_i(s) W_msg[et, i]``; output
    ``x + sigmoid(skip_t) A_t(gelu(agg))`` (tanh gelu, flax's default).
    Types that receive no edge pass through.

    With ``record_attention`` set, each forward keeps the normalised
    attention mass per destination node and head in
    ``att_weight_sum[t]`` (1 where a node has an incoming edge, 0
    elsewhere); off, it is not computed.
    """

    def __init__(self, edge_types: Sequence[EdgeType],
                 node_types: Sequence[str], out_features: int,
                 heads: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if out_features % heads:
            raise ValueError("heads must divide out_features")
        self.edge_types = [tuple(et) for et in edge_types]
        self.heads, self.d = heads, out_features // heads
        self.dtype = dtype
        self.record_attention = False
        self.att_weight_sum: Dict[str, torch.Tensor] = {}
        hd = heads * self.d

        def per_type(bias=False, width=hd):
            return nn.ModuleDict({t: nn.Linear(out_features, width, bias=bias)
                                  for t in node_types})

        self.k, self.q, self.v = per_type(), per_type(), per_type()
        self.a = per_type(bias=True, width=out_features)
        self.skip = nn.ParameterDict({t: nn.Parameter(torch.ones(()))
                                      for t in node_types})
        types = set(node_types)
        rel = [et for et in self.edge_types
               if et[0] in types and et[2] in types]
        shape = (heads, self.d, self.d)
        self.w_att = nn.ParameterDict({as_str(et): nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(shape))) for et in rel})
        self.w_msg = nn.ParameterDict({as_str(et): nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(shape))) for et in rel})
        self.mu = nn.ParameterDict({as_str(et): nn.Parameter(
            torch.ones(heads)) for et in rel})

    def forward(self, x: Dict[str, torch.Tensor], edge_index, edge_mask
                ) -> Dict[str, torch.Tensor]:
        h, d = self.heads, self.d

        def proj(lins):
            return {t: linear(lins[t], v, self.dtype).reshape(-1, h, d)
                    for t, v in x.items()}

        K, Q, V = proj(self.k), proj(self.q), proj(self.v)
        grouped: Dict[str, list] = {}
        for et in self.edge_types:
            src_t, _, dst_t = et
            name = as_str(et)
            if (name not in self.w_att or et not in edge_index
                    or src_t not in x or dst_t not in x):
                continue
            ei = edge_index[et]
            if ei.shape[-1] == 0:
                continue
            n_src, n_dst = x[src_t].shape[0], x[dst_t].shape[0]
            s_idx = ei[0].clamp(0, n_src - 1).long()
            d_idx = ei[1].clamp(0, n_dst - 1).long()
            ks = K[src_t].index_select(0, s_idx)               # [E, h, d]
            qd = Q[dst_t].index_select(0, d_idx)
            score = torch.einsum("ehd,hdc,ehc->eh", ks, self.w_att[name], qd)
            score = score * self.mu[name] / math.sqrt(d)
            msg = torch.einsum("ehd,hdc->ehc", V[src_t].index_select(0, s_idx),
                               self.w_msg[name])
            grouped.setdefault(dst_t, []).append(
                (score, msg, d_idx, edge_mask[et]))

        out = {}
        for t, items in grouped.items():
            n_t = x[t].shape[0]
            segs = [torch.where(mask, d_idx, n_t)
                    for _, _, d_idx, mask in items]
            m = torch.full((n_t + 1, h), float("-inf"), device=x[t].device)
            for (score, _, _, mask), seg in zip(items, segs):
                m = torch.maximum(m, segment_max(
                    torch.where(mask[:, None], score, float("-inf")), seg,
                    n_t + 1))
            m = torch.where(torch.isfinite(m), m, 0)
            exs = [torch.where(mask[:, None], clamped_exp(
                score - m.index_select(0, seg)), 0)
                for (score, _, _, mask), seg in zip(items, segs)]
            denom = x[t].new_zeros((n_t + 1, h))
            num = x[t].new_zeros((n_t + 1, h, d))
            for (_, msg, _, _), seg, ex in zip(items, segs, exs):
                denom = denom + segment_sum(ex, seg, n_t + 1)
                num = num + segment_sum(ex[:, :, None] * msg, seg, n_t + 1)
            denom = denom.clamp(min=1e-16)
            agg = (num / denom[:, :, None])[:n_t]
            if self.record_attention:
                mass = x[t].new_zeros((n_t + 1, h))
                for seg, ex in zip(segs, exs):
                    mass = mass + segment_sum(
                        ex / denom.index_select(0, seg), seg, n_t + 1)
                self.att_weight_sum[t] = mass[:n_t].detach()
            a_out = linear(self.a[t], F.gelu(agg.reshape(n_t, h * d),
                                             approximate="tanh"), self.dtype)
            out[t] = x[t] + torch.sigmoid(self.skip[t]) * a_out
        return {t: out.get(t, x[t]) for t in x}


class HGT(nn.Module):
    """Per-type input projections ``in_{t}``, ``num_layers``
    :class:`HGTConv` layers with dropout after each, and a head on
    ``target_type`` (the ``train_hgt_mag.py`` configuration).
    ``in_features`` maps each node type with features to its width;
    ``dropout_key`` as in :class:`~glt_tpu_torch.models.rgat.RGAT`."""

    def __init__(self, edge_types: Sequence[EdgeType],
                 in_features: Dict[str, int], hidden_features: int,
                 out_features: int, target_type: str, num_layers: int = 2,
                 heads: int = 2, dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = dict(in_features)
        self.target_type = target_type
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        self.inputs = nn.ModuleDict({
            t: nn.Linear(d, hidden_features) for t, d in in_features.items()})
        self.layers = nn.ModuleList(
            HGTConv(edge_types, sorted(in_features), hidden_features,
                    heads=heads, dtype=dtype)
            for _ in range(num_layers))
        self.head = nn.Linear(hidden_features, out_features)

    def record_attention(self, on: bool = True) -> None:
        """Keep each layer's attention mass (``HGTConv.att_weight_sum``)."""
        for layer in self.layers:
            layer.record_attention = on

    def forward(self, x: Dict[str, torch.Tensor], edge_index, edge_mask,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = {t: linear(self.inputs[t], v, self.dtype) for t, v in x.items()}
        keys = layer_keys(dropout_key, self.dropout_rate, len(self.layers))
        for i, layer in enumerate(self.layers):
            h = layer(h, edge_index, edge_mask)
            h = layer_dropout(h, self.dropout_rate, keys, i,
                              self.target_type)
        return self.head(h[self.target_type])
