"""GAT stack over padded batches (cf. ``glt_tpu/models/gat.py``):
``num_layers`` :class:`~glt_tpu_torch.models.conv.GATConv` layers, the
hidden ones ``heads`` wide and concatenated (elu, dropout), the last one
head averaged to ``out_features``.  ``bounds`` trims the layers as
:class:`~glt_tpu_torch.models.sage.GraphSAGE`'s do (a row's softmax, too,
sees only its own hop's in-edges)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from .conv import Bounds, GATConv, layer_spans, on_span


def dropout(x: torch.Tensor, rate: float, key: torch.Tensor) -> torch.Tensor:
    """Inverted dropout from a threefry ``key`` (flax's ``Dropout``;
    its bits are not reproduced)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    return torch.where(trandom.bernoulli(key, keep, x.shape), x / keep, 0)


class GAT(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_layers: int = 2, heads: int = 4,
                 dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        convs, width = [], in_features
        for i in range(num_layers):
            if i == num_layers - 1:
                convs.append(GATConv(width, out_features, heads=1,
                                     concat=False, dtype=dtype))
            else:
                convs.append(GATConv(width, hidden_features, heads=heads,
                                     dtype=dtype))
                width = hidden_features * heads
        self.convs = nn.ModuleList(convs)
        self.dropout_rate = float(dropout_rate)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None,
                bounds: Bounds = None) -> torch.Tensor:
        """Logits, or their first ``nodes[0]`` rows given the block's
        hop prefixes ``bounds = (nodes, edges)``; dropout draws from
        ``dropout_key`` when one is given (layer ``i`` from
        ``split(dropout_key, L - 1)[i]``)."""
        last = len(self.convs) - 1
        keys = None
        if dropout_key is not None and self.dropout_rate > 0.0 and last:
            keys = trandom.split(dropout_key, last)
        spans = layer_spans(len(self.convs), x.shape[0], edge_index.shape[1],
                            bounds)
        for i, conv in enumerate(self.convs):
            x = on_span(conv, x, edge_index, edge_mask, spans[i])
            if i != last:
                x = F.elu(x)
                if keys is not None:
                    x = dropout(x, self.dropout_rate, keys[i])
        return x
