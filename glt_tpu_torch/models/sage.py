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

``bounds``, the sampled block's hop prefixes ``(nodes, edges)``
(:func:`~glt_tpu_torch.sampler.neighbor_sampler.hop_prefixes`), trims
each layer to the rows and edges that the first ``nodes[0]`` rows of
the logits depend on (:func:`~.conv.layer_spans`); those rows are the
same function of the same inputs, and so is every gradient of a loss
that reads only them.  Layer ``i``'s mask is then drawn at its output
rows only: threefry's partitionable layout gives a row the same bits at
any row count, so the kept rows keep their masks.  The scanned node
train step passes the bounds for a batch of distinct seeds (its loss
reads the seed rows alone) and none for a ragged one; the eager train
and eval steps, the link, subgraph, distributed and tiered steps and
serving pass none and run the whole block.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import random as trandom
from .conv import Bounds, SAGEConv, layer_spans, on_span


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
                dropout_key: Optional[torch.Tensor] = None,
                bounds: Bounds = None) -> torch.Tensor:
        """Logits ``[num_nodes, out]``, or their first ``nodes[0]``
        rows given the block's hop prefixes ``bounds = (nodes, edges)``;
        dropout draws from ``dropout_key`` when one is given (training)
        and is off otherwise."""
        last = len(self.convs) - 1
        keys = None
        if dropout_key is not None and self.dropout_rate > 0.0 and last:
            keys = trandom.split(dropout_key, last)
        spans = layer_spans(len(self.convs), x.shape[0], edge_index.shape[1],
                            bounds)
        for i, conv in enumerate(self.convs):
            x = on_span(conv, x, edge_index, edge_mask, spans[i])
            if i != last:
                x = torch.relu(x)
                if keys is not None:
                    x = self._dropout(x, keys[i])
        return x
