"""GraphSAGE — the flagship model (cf. ``glt_tpu/models/sage.py``):
a stack of :class:`SAGEConv`, relu + dropout between layers.

Dropout randomness is explicit, as flax's ``rngs={"dropout": key}``:
it runs only when the caller passes a threefry ``dropout_key``
(:mod:`glt_tpu_torch.random`), never from torch's global generator.
Layer ``i``'s mask is ``bernoulli(split(dropout_key, L - 1)[i], keep)``:
hash-kernel launches on the card reading the key from device memory,
so a CUDA graph replays a step's dropout with whatever key the step
derives on the card.  The train steps pass ``fold_in(PRNGKey(
dropout_seed), step)``; without a key the forward is deterministic
(evaluation).  Flax's dropout bits are not reproduced: a parity test
runs with ``dropout_rate=0``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import random as trandom
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

    def _dropout(self, x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        rate = self.dropout_rate
        if rate >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - rate
        return torch.where(trandom.bernoulli(key, keep, x.shape), x / keep,
                           0)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_mask: torch.Tensor,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits ``[num_nodes, out]``; dropout draws from ``dropout_key``
        when one is given (training) and is off otherwise."""
        last = len(self.convs) - 1
        keys = None
        if dropout_key is not None and self.dropout_rate > 0.0 and last:
            keys = trandom.split(dropout_key, last)
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_mask)
            if i != last:
                x = torch.relu(x)
                if keys is not None:
                    x = self._dropout(x, keys[i])
        return x
