"""The relational GAT of MLPerf Training's GNN benchmark: GLT's
``examples/igbh/rgnn.py``, ``RGNN(model='rgat')``, on hetero batches.

Layer ``l`` of ``L`` holds one ``GATConv(d_l, hidden / heads,
heads=heads, add_self_loops=False)`` per relation ``r = (s, rel, d)``
(a batch's reversed edge type: messages from ``s`` rows into ``d``
rows), with one ``W_r`` without bias for both ends:

* ``z = W_r x`` for the source rows and for the destination rows (once
  when both ends are one type);
* per head ``e_ij = LeakyReLU_0.2(a_src,r . z_j + a_dst,r . z_i)``, and
  ``alpha`` the softmax of ``e_ij`` over the edges into ``i``;
* ``out_r,i = concat_h sum_j alpha_ij z_j + b_r``;

summed over the relations into each type
(:class:`~glt_tpu_torch.models.rgat.HeteroConv` with ``concat=True``).
Between layers every type goes through ``LeakyReLU_0.01`` and dropout;
neither follows the last layer.  The head is ``Linear(hidden,
classes)`` on the target type's rows.

Precision: with ``dtype`` (``torch.bfloat16``) every matmul runs in it,
each type's rows cast once a layer; parameters, scores, softmax,
aggregation and the logits stay float32.

Dropout: ``rate`` on every type after layer ``i < L - 1``, its masks
``bernoulli(k, 1 - rate, rows.shape)`` (inverted: kept rows over
``1 - rate``) with ``k = split(split(dropout_key, L - 1)[i], T)[t]``
for type ``t`` among the ``T`` types the layer wrote, sorted.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..typing import EdgeType
from .conv import linear
from .rgat import HeteroConv, hetero_dropout


class RGNN(nn.Module):
    """R-GAT at MLPerf's widths by default: 3 layers of 4-head GAT, hidden
    512, dropout 0.2.

    Args:
      edge_types: the batch's (reversed) edge types; a type's sum runs
        over them in this order.
      in_features: the input width, one for every node type.
      hidden_features: each layer's output width (heads concatenated).
      out_features: classes of the head.
      target_type: the node type the head reads.
    """

    def __init__(self, edge_types: Sequence[EdgeType], in_features: int,
                 hidden_features: int, out_features: int, target_type: str,
                 num_layers: int = 3, heads: int = 4,
                 dropout_rate: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        types = sorted({et[0] for et in edge_types}
                       | {et[2] for et in edge_types})
        self.in_features = {t: int(in_features) for t in types}
        self.target_type = target_type
        self.dropout_rate = float(dropout_rate)
        self.dtype = dtype
        self.layers = nn.ModuleList(
            HeteroConv(edge_types, {t: in_features if l == 0
                                    else hidden_features for t in types},
                       hidden_features, conv="gat", heads=heads,
                       dtype=dtype, concat=True, layer=l)
            for l in range(num_layers))
        self.head = nn.Linear(hidden_features, out_features)

    def forward(self, x: Dict[str, torch.Tensor], edge_index, edge_mask,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits of every row of the target type."""
        last = len(self.layers) - 1
        keys = None
        if dropout_key is not None and self.dropout_rate > 0.0 and last:
            keys = trandom.split(dropout_key, last)
        h = x
        for i, layer in enumerate(self.layers):
            if self.dtype is not None:
                h = {t: v.to(self.dtype) for t, v in h.items()}
            h = layer(h, edge_index, edge_mask)
            if i != last:
                h = {t: F.leaky_relu(v, 0.01) for t, v in h.items()}
                if keys is not None:
                    h = hetero_dropout(h, self.dropout_rate, keys[i])
        return linear(self.head, h[self.target_type], self.dtype)
