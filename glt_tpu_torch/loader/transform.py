"""Sampled-batch container and assembly (cf.
``glt_tpu/loader/transform.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..sampler.base import HeteroSamplerOutput, SamplerOutput
from ..typing import EdgeType, NodeType


@dataclasses.dataclass
class Batch:
    """One sampled ego-subgraph batch (the PyG ``Data`` analog).

    * ``x``: ``[num_nodes, d]`` features for ``node`` (zeros on padding).
    * ``y``: ``[num_nodes]`` labels (-1 on padding rows).
    * ``edge_index``: ``[2, num_edges]`` local COO, row 0 = message
      source, -1 padded.
    * ``edge_id``: ``[num_edges]`` global edge ids.
    * ``node``: ``[num_nodes]`` global node ids; seeds occupy the first
      ``batch_size`` slots.
    * ``batch``: ``[batch_size]`` seed ids.
    """
    x: Optional[Any]
    y: Optional[Any]
    edge_index: Any
    edge_id: Optional[Any]
    node: Any
    node_mask: Any
    edge_mask: Any
    batch: Optional[Any]
    batch_size: int = 0
    metadata: Optional[Dict[str, Any]] = None

    @property
    def num_nodes(self) -> int:
        return int(self.node.shape[0])


@dataclasses.dataclass
class HeteroBatch:
    """Heterogeneous batch (the PyG ``HeteroData`` analog): the fields
    of :class:`Batch` as dicts keyed by node type or (reversed) edge
    type.  ``x`` lacks a type without features; ``y`` holds the types
    with labels."""
    x: Dict[NodeType, Any]
    y: Optional[Dict[NodeType, Any]]
    edge_index: Dict[EdgeType, Any]
    edge_id: Dict[EdgeType, Any]
    node: Dict[NodeType, Any]
    node_mask: Dict[NodeType, Any]
    edge_mask: Dict[EdgeType, Any]
    batch: Optional[Dict[NodeType, Any]]
    batch_size: int = 0
    input_type: Optional[NodeType] = None
    metadata: Optional[Dict[str, Any]] = None


def to_batch(out: SamplerOutput, x: Optional[torch.Tensor] = None,
             y: Optional[torch.Tensor] = None, batch_size: int = 0) -> Batch:
    """Assemble a :class:`Batch` from sampler output and gathered
    tensors.  ``out.row`` is already the message-source side (the
    sampler transposed), so ``edge_index[0] = row``."""
    return Batch(
        x=x,
        y=y,
        edge_index=torch.stack([out.row, out.col]),
        edge_id=out.edge,
        node=out.node,
        node_mask=out.node_mask,
        edge_mask=out.edge_mask,
        batch=out.batch,
        batch_size=batch_size,
        metadata=out.metadata,
    )


def as_pyg_v1_adjs(batch: Batch, batch_size: int, fanouts,
                   frontier_cap: Optional[int] = None):
    """PyG v1's layered output (cf. ``glt_tpu``'s ``as_pyg_v1_adjs``):
    ``(batch_size, n_id, adjs)`` with one ``(edge_index, e_id, size)``
    triple per hop, outermost hop first, the order PyG v1 models
    consume.  A hop's edges are a contiguous segment of the batch's
    padded COO, since the sampler concatenates the hops in order; the
    widths are the sampler's static ones for ``batch_size``."""
    from ..sampler.neighbor_sampler import hop_widths

    widths = hop_widths(batch_size, list(fanouts), frontier_cap)
    n = batch.node.shape[0]
    adjs = []
    lo = 0
    for w, f in zip(widths, fanouts):
        hi = lo + w * f
        adjs.append((batch.edge_index[:, lo:hi],
                     None if batch.edge_id is None else batch.edge_id[lo:hi],
                     (n, n)))
        lo = hi
    return batch_size, batch.node, list(reversed(adjs))


def to_hetero_batch(out: HeteroSamplerOutput,
                    x: Optional[Dict[NodeType, torch.Tensor]] = None,
                    y: Optional[Dict[NodeType, torch.Tensor]] = None,
                    batch_size: int = 0) -> HeteroBatch:
    """Assemble a :class:`HeteroBatch` from hetero sampler output and
    gathered tensors (``edge_index[et] = stack([row, col])``)."""
    return HeteroBatch(
        x=x or {}, y=y,
        edge_index={et: torch.stack([out.row[et], out.col[et]])
                    for et in out.row},
        edge_id=out.edge, node=out.node, node_mask=out.node_mask,
        edge_mask=out.edge_mask, batch=out.batch, batch_size=batch_size,
        input_type=out.input_type, metadata=out.metadata)
