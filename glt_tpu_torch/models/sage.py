"""GraphSAGE — the flagship model (cf. ``glt_tpu/models/sage.py``):
a stack of :class:`SAGEConv`, relu + dropout between layers.

Dropout randomness is explicit, as flax's ``rngs={"dropout": key}``:
it runs only when the caller passes a ``torch.Generator`` and draws from
that generator alone, never from torch's global one.  The train steps
seed one per step from ``(dropout_seed, step)``; without a generator
the forward is deterministic (evaluation).  Flax's dropout bits are not
reproduced: a parity test runs with ``dropout_rate=0``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .conv import SAGEConv


class GraphSAGE(nn.Module):
    """``num_layers`` SAGEConv layers: ``in -> hidden -> ... -> out``.

    ``dtype`` is the matmul compute type (e.g. ``torch.bfloat16``).
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
        self.dropout_rate = float(dropout_rate)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        rate = self.dropout_rate
        if generator is None or rate == 0.0:
            return x
        if rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - rate
        bits = torch.empty_like(x).bernoulli_(keep, generator=generator)
        return torch.where(bits.bool(), x / keep, 0)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[num_nodes, out]``; dropout draws from ``generator``
        when one is given (training) and is off otherwise."""
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_mask)
            if i != last:
                x = self._dropout(torch.relu(x), generator)
        return x
