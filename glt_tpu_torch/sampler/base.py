"""Sampler input/output containers (cf. ``glt_tpu/sampler/base.py``).

Every tensor has a static shape, padded with -1; ragged truths (how many
nodes/edges were really sampled) travel as device tensors, so no step of
the sampler waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..typing import NodeType


@dataclasses.dataclass
class NodeSamplerInput:
    """Seed nodes for node-based sampling: a host array or a tensor of
    global node ids."""
    node: Any
    input_type: Optional[NodeType] = None

    def __len__(self) -> int:
        return int(self.node.shape[0])

    def __getitem__(self, index) -> "NodeSamplerInput":
        return NodeSamplerInput(self.node[index], self.input_type)


@dataclasses.dataclass
class SamplerOutput:
    """Sampled ego-subgraph in local (relabeled) COO form.

    * ``node``: ``[max_nodes]`` global ids, first-occurrence order (seeds
      first), -1 padded.
    * ``row`` / ``col``: ``[max_edges]`` local indices into ``node``;
      row = neighbor (message source), col = seed side.
    * ``edge``: ``[max_edges]`` global edge ids, -1 padded (None without
      edge ids).
    * ``batch``: ``[batch_size]`` the seeds of this batch.
    * ``num_sampled_nodes`` / ``num_sampled_edges``: per-hop valid counts.

    With ``last_hop_dedup=False`` the final hop's nodes sit in a leaf
    block at offset ``max_nodes - last_width * last_fanout``; select valid
    rows with ``node_mask``.
    """
    node: torch.Tensor
    row: torch.Tensor
    col: torch.Tensor
    edge: Optional[torch.Tensor]
    batch: Optional[torch.Tensor] = None
    node_mask: Optional[torch.Tensor] = None
    edge_mask: Optional[torch.Tensor] = None
    num_sampled_nodes: Optional[torch.Tensor] = None
    num_sampled_edges: Optional[torch.Tensor] = None
    input_type: Optional[Any] = None
    metadata: Optional[Dict[str, Any]] = None
