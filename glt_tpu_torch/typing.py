"""Core constants and type helpers shared by the port (cf.
``glt_tpu/typing.py``)."""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

NodeType = str
EdgeType = Tuple[str, str, str]

# Per-hop fanout specification: [15, 10, 5] or {edge_type: [15, 10]}.
NumNeighbors = Union[List[int], Dict[EdgeType, List[int]]]

# Sentinel id used to pad static-shape id tensors.  All ops treat
# negative ids as "absent".
PADDING_ID = -1

_REVERSE_PREFIX = "rev_"


def as_str(type_: Union[NodeType, EdgeType]) -> str:
    """Canonical string form of a node or edge type: an edge type's
    three parts joined by ``__`` (a valid module key, unlike ``.``)."""
    if isinstance(type_, NodeType):
        return type_
    if isinstance(type_, (tuple, list)) and len(type_) == 3:
        return "__".join(type_)
    raise ValueError(f"invalid graph type: {type_!r}")


def edge_type_from_str(s: str) -> EdgeType:
    parts = tuple(s.split("__"))
    if len(parts) != 3:
        raise ValueError(f"not an edge-type string: {s!r}")
    return parts  # type: ignore[return-value]


def reverse_edge_type(etype: EdgeType) -> EdgeType:
    """Reverse an edge type: ``(src, rel, dst) -> (dst, rev_rel, src)``,
    dropping the ``rev_`` prefix where there is one; a relation between
    nodes of one type keeps its name."""
    src, rel, dst = etype
    if src != dst:
        if rel.startswith(_REVERSE_PREFIX):
            rel = rel[len(_REVERSE_PREFIX):]
        else:
            rel = _REVERSE_PREFIX + rel
    return (dst, rel, src)


class GraphPartitionData(NamedTuple):
    """One partition's topology on the host: COO edges and their global
    edge ids."""
    edge_index: np.ndarray  # [2, E] global node ids (row=src, col=dst)
    eids: np.ndarray        # [E] global edge ids
    weights: Optional[np.ndarray] = None


class FeaturePartitionData(NamedTuple):
    """One partition's feature rows on the host and the global ids they
    belong to, with the hot-cache rows of remote nodes."""
    feats: np.ndarray            # [n, d]
    ids: np.ndarray              # [n] global ids
    cache_feats: Optional[np.ndarray] = None
    cache_ids: Optional[np.ndarray] = None
