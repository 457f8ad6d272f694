"""Sampler input/output containers (cf. ``glt_tpu/sampler/base.py``).

Every tensor has a static shape, padded with -1; ragged truths (how many
nodes/edges were really sampled) travel as device tensors, so no step of
the sampler waits for the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..typing import EdgeType, NodeType
from ..utils.device import DeviceLike, resolve_device


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


class NegativeSampling:
    """Negative sampling spec.

    mode 'binary': ``amount`` negative edges per positive edge, labeled
    0 (positives 1).  mode 'triplet': ``amount`` negative destination
    nodes per positive edge's source.  ``weight`` is an optional
    non-negative node weight (need not sum to one) that biases the
    negative node draws; uniform when absent.
    """
    MODES = ("binary", "triplet")

    def __init__(self, mode: str = "binary", amount: float = 1,
                 weight=None):
        mode = mode.lower()
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.amount = amount
        self.weight = None if weight is None else np.asarray(weight,
                                                             np.float32)
        if self.weight is not None:
            if not np.isfinite(self.weight).all():
                raise ValueError("negative-sampling weight must be finite")
            if (self.weight < 0).any():
                raise ValueError("negative-sampling weight must be >= 0")
            if float(self.weight.sum()) <= 0.0:
                # An all-zero weight makes the CDF 0/0 = NaN and every
                # draw collapse onto one node.
                raise ValueError("negative-sampling weight must have a "
                                 "positive sum")
        self._cdf: Dict[str, torch.Tensor] = {}

    def is_binary(self) -> bool:
        return self.mode == "binary"

    def is_triplet(self) -> bool:
        return self.mode == "triplet"

    def sample_count(self, num_pos: int) -> int:
        return int(round(num_pos * self.amount))

    def cdf(self, device: DeviceLike = None) -> Optional[torch.Tensor]:
        """The normalised cumulative weight on ``device`` (default
        ``"cuda"``; cached there), or None without a weight.  It is
        summed on the host, so every device gets the same bits."""
        if self.weight is None:
            return None
        dev = resolve_device(device)
        if str(dev) not in self._cdf:
            from ..ops.negative_sample import weight_to_cdf

            self._cdf[str(dev)] = weight_to_cdf(self.weight).to(dev)
        return self._cdf[str(dev)]


@dataclasses.dataclass
class EdgeSamplerInput:
    """Seed edges for link-based sampling: host arrays of global ids.
    ``input_type`` names the seed edge type of a heterogeneous graph."""
    row: Any
    col: Any
    label: Optional[Any] = None
    input_type: Optional[EdgeType] = None
    neg_sampling: Optional[NegativeSampling] = None

    def __len__(self) -> int:
        return int(self.row.shape[0])

    def __getitem__(self, index) -> "EdgeSamplerInput":
        return EdgeSamplerInput(
            self.row[index], self.col[index],
            None if self.label is None else self.label[index],
            self.input_type, self.neg_sampling)


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


@dataclasses.dataclass
class HeteroSamplerOutput:
    """Heterogeneous sampling result: dicts keyed by node type or edge
    type, each value with :class:`SamplerOutput`'s static-shape
    meaning.  The edge types of ``row``/``col``/``edge`` are the
    *reversed* types (dst <- src), as the reference emits."""
    node: Dict[NodeType, torch.Tensor]
    row: Dict[EdgeType, torch.Tensor]
    col: Dict[EdgeType, torch.Tensor]
    edge: Dict[EdgeType, torch.Tensor]
    batch: Optional[Dict[NodeType, torch.Tensor]] = None
    node_mask: Optional[Dict[NodeType, torch.Tensor]] = None
    edge_mask: Optional[Dict[EdgeType, torch.Tensor]] = None
    num_sampled_nodes: Optional[Dict[NodeType, torch.Tensor]] = None
    num_sampled_edges: Optional[Dict[EdgeType, torch.Tensor]] = None
    input_type: Optional[Any] = None
    metadata: Optional[Dict[str, Any]] = None
