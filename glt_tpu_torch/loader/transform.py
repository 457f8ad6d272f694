"""Sampled-batch container (cf. ``glt_tpu/loader/transform.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


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
