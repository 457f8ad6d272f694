"""Relational GNNs over hetero batches (cf. ``glt_tpu/models/rgat.py``):
the :class:`HeteroConv` combinator and R-GAT.

A batch holds per-type node features ``x[t]`` and per-(reversed)-edge-
type COO ``edge_index[et]`` (row 0 into ``x[src_t]``, row 1 into
``x[dst_t]``) with its ``edge_mask[et]``.  The torch modules take the
per-type input widths at construction.  Edge-type keys of module dicts
are :func:`~glt_tpu_torch.typing.as_str` (``a__rel__b``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .. import random as trandom
from ..obs.stages import stage as _stage
from ..typing import EdgeType, as_str
from .conv import GATConv, SAGEConv, linear
from .gat import dropout


def hetero_dropout(h: Dict[str, torch.Tensor], rate: float,
                   key: torch.Tensor, only: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """Dropout of every node type's rows (or of type ``only``'s alone),
    type ``t`` (in sorted order) from ``split(key, types)[t]``."""
    types = sorted(h)
    keys = trandom.split(key, len(types))
    return {t: dropout(h[t], rate, keys[i]) if only in (None, t) else h[t]
            for i, t in enumerate(types)}


def layer_dropout(h, rate, keys, i, target_type):
    """Dropout after layer ``i`` (``keys`` from :func:`layer_keys`): of
    every type, but after the last layer of the target type alone, the
    one row set the head reads."""
    if keys is None:
        return h
    last = i == keys.shape[0] - 1
    return hetero_dropout(h, rate, keys[i], target_type if last else None)


def layer_keys(dropout_key: Optional[torch.Tensor], rate: float,
               num_layers: int):
    """One dropout key per layer, or None when dropout is off."""
    if dropout_key is None or rate <= 0.0:
        return None
    return trandom.split(dropout_key, num_layers)


class HeteroConv(nn.Module):
    """One conv per edge type, summed per destination type in
    ``edge_types`` order.  ``edge_types`` are the batch's (reversed)
    keys; an edge type ``(src_t, rel, dst_t)`` aggregates ``x[src_t]``
    rows into ``x[dst_t]`` rows.  The source rows stack behind the
    destination rows so a homogeneous conv runs on one node array; they
    are projected to the destination width (``{et}_align``) only where
    the two widths differ.  An edge type whose ends lack features, or
    whose batch holds no edges, is skipped.

    ``concat=True`` (GAT convs only) is PyG's ``HeteroConv`` over
    ``GATConv(d, out_features // heads, heads)``: the heads concatenated
    to ``out_features``, and each edge type's conv run on the bipartite
    pair, its source rows and its destination rows each projected by the
    one ``W`` (once when both ends are one type), with no stacking and
    no alignment (both ends must have one width).  Each edge type is
    then two graph-safe stages (:mod:`glt_tpu_torch.obs.stages`):
    ``rgat.proj`` (the projections) and ``rgat.attn`` (scores,
    :func:`~glt_tpu_torch.models.conv.segment_softmax` and the weighted
    sum), attrs ``layer`` (the constructor's) and ``relation``."""

    def __init__(self, edge_types: Sequence[EdgeType],
                 in_features: Dict[str, int], out_features: int,
                 conv: str = "sage", heads: int = 2,
                 dtype: Optional[torch.dtype] = None, concat: bool = False,
                 layer: Optional[int] = None):
        super().__init__()
        self.edge_types = [tuple(et) for et in edge_types]
        self.dtype = dtype
        self.concat = bool(concat)
        self.layer = layer
        if self.concat and (conv != "gat" or out_features % heads):
            raise ValueError("concat takes GAT convs whose heads divide "
                             f"out_features (got {conv!r}, {out_features} "
                             f"over {heads})")
        self.convs = nn.ModuleDict()
        self.align = nn.ModuleDict()
        for et in self.edge_types:
            src_t, _, dst_t = et
            if src_t not in in_features or dst_t not in in_features:
                continue
            d_dst = in_features[dst_t]
            if self.concat:
                if in_features[src_t] != d_dst:
                    raise ValueError(f"concat: {et} joins widths "
                                     f"{in_features[src_t]} and {d_dst}")
                self.convs[as_str(et)] = GATConv(
                    d_dst, out_features // heads, heads=heads, concat=True,
                    dtype=dtype)
                continue
            if in_features[src_t] != d_dst:
                self.align[as_str(et)] = nn.Linear(in_features[src_t], d_dst)
            if conv == "gat":
                self.convs[as_str(et)] = GATConv(d_dst, out_features,
                                                 heads=heads, concat=False,
                                                 dtype=dtype)
            else:
                self.convs[as_str(et)] = SAGEConv(d_dst, out_features,
                                                  dtype=dtype)

    def forward(self, x: Dict[str, torch.Tensor], edge_index, edge_mask
                ) -> Dict[str, torch.Tensor]:
        if self.concat:
            return self._pairs(x, edge_index, edge_mask)
        outs: Dict[str, list] = {}
        for et in self.edge_types:
            src_t, _, dst_t = et
            name = as_str(et)
            if (name not in self.convs or et not in edge_index
                    or src_t not in x or dst_t not in x):
                continue
            ei = edge_index[et]
            if ei.shape[-1] == 0:
                continue
            n_dst = x[dst_t].shape[0]
            src_rows = x[src_t]
            if name in self.align:
                src_rows = linear(self.align[name], src_rows, self.dtype)
            joint = torch.cat([x[dst_t], src_rows])
            ei_shift = torch.stack([torch.where(ei[0] >= 0, ei[0] + n_dst, -1),
                                    ei[1]])
            h = self.convs[name](joint, ei_shift, edge_mask[et])
            outs.setdefault(dst_t, []).append(h[:n_dst])
        return {t: sum(hs) for t, hs in outs.items()}

    def _pairs(self, x, edge_index, edge_mask) -> Dict[str, torch.Tensor]:
        """The ``concat`` forward: each edge type on its bipartite pair."""
        outs: Dict[str, list] = {}
        for et in self.edge_types:
            src_t, _, dst_t = et
            name = as_str(et)
            if (name not in self.convs or et not in edge_index
                    or src_t not in x or dst_t not in x):
                continue
            ei = edge_index[et]
            if ei.shape[-1] == 0:
                continue
            conv = self.convs[name]
            with _stage("rgat.proj", device=ei.device, layer=self.layer,
                        relation=name) as st:
                z_src = conv.project(x[src_t])
                z_dst = (z_src if src_t == dst_t
                         else conv.project(x[dst_t]))
                st.next("rgat.attn", layer=self.layer, relation=name)
                h = conv.attend(z_src, z_dst, ei, edge_mask[et])
            outs.setdefault(dst_t, []).append(h)
        return {t: sum(hs) for t, hs in outs.items()}


class RGAT(nn.Module):
    """Multi-layer relational GAT (IGBH-style): per-type input
    projections ``in_{t}``, ``num_layers`` :class:`HeteroConv` layers
    with a residual ``h + relu(conv)`` per type (untouched types pass
    through), dropout, and a head on ``target_type``.

    ``in_features`` maps each node type with features to its width;
    ``dropout_key`` (training) draws layer ``i``'s masks from
    ``split(dropout_key, L)[i]``, one key per node type below it.
    """

    def __init__(self, edge_types: Sequence[EdgeType],
                 in_features: Dict[str, int], hidden_features: int,
                 out_features: int, target_type: str, num_layers: int = 2,
                 heads: int = 2, conv: str = "gat", dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = dict(in_features)
        self.target_type = target_type
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        self.inputs = nn.ModuleDict({
            t: nn.Linear(d, hidden_features) for t, d in in_features.items()})
        widths = {t: hidden_features for t in in_features}
        self.layers = nn.ModuleList(
            HeteroConv(edge_types, widths, hidden_features, conv=conv,
                       heads=heads, dtype=dtype)
            for _ in range(num_layers))
        self.head = nn.Linear(hidden_features, out_features)

    def forward(self, x: Dict[str, torch.Tensor], edge_index, edge_mask,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = {t: linear(self.inputs[t], v, self.dtype) for t, v in x.items()}
        keys = layer_keys(dropout_key, self.dropout_rate, len(self.layers))
        for i, layer in enumerate(self.layers):
            out = layer(h, edge_index, edge_mask)
            h = {t: h[t] + torch.relu(out[t]) if t in out else h[t]
                 for t in h}
            h = layer_dropout(h, self.dropout_rate, keys, i,
                              self.target_type)
        return self.head(h[self.target_type])
