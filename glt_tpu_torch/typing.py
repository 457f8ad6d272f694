"""Core constants shared by the port (cf. ``glt_tpu/typing.py``)."""
from __future__ import annotations

from typing import Dict, List, Tuple, Union

NodeType = str
EdgeType = Tuple[str, str, str]

# Per-hop fanout specification: [15, 10, 5].
NumNeighbors = Union[List[int], Dict[EdgeType, List[int]]]

# Sentinel id used to pad static-shape id tensors.  All ops treat
# negative ids as "absent".
PADDING_ID = -1
