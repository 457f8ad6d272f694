"""GraphSAGE — the flagship model (cf. ``glt_tpu/models/sage.py``):
a stack of :class:`SAGEConv`, relu + dropout between layers."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .conv import SAGEConv


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConv layers: ``in -> hidden -> ... -> out``.

    ``dtype`` is the matmul compute type (e.g. ``torch.bfloat16``);
    dropout is active only in ``train()`` mode.
    """

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_layers: int = 3,
                 dropout_rate: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = ([in_features] + [hidden_features] * (num_layers - 1)
                + [out_features])
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], dtype=dtype)
            for i in range(num_layers))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor) -> torch.Tensor:
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_mask)
            if i != last:
                x = self.dropout(torch.relu(x))
        return x
