"""CSRTopo — host-side topology container (numpy), cf.
``glt_tpu/data/topology.py``.

Accepts COO / CSR / CSC input and canonicalises to out-edge CSR, exposing
``indptr / indices / edge_ids / degrees``.  Graph construction is host
prep; device code consumes the finished arrays through
:class:`glt_tpu_torch.data.graph.Graph`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from ..utils.topo import coo_to_csr, csr_to_coo

__all__ = ["CSRTopo", "coo_to_csr", "csr_to_coo"]

_LAYOUTS = ("COO", "CSR", "CSC")


class CSRTopo:
    """Graph topology stored as CSR over out-edges.

    Args:
      edge_index: ``[2, E]`` COO (row=src, col=dst) when layout is 'COO',
        otherwise ``(indptr, indices)``.
      edge_ids: optional ``[E]`` global edge ids (default: input positions).
      layout: 'COO' | 'CSR' | 'CSC' ('CSC' is the CSR of the reverse
        graph and is transposed into out-edge CSR).
      num_nodes: optional node count override.
      edge_weights: optional ``[E]`` per-edge weights, in input order;
        stored in CSR order, aligned with ``indices``.
    """

    def __init__(self,
                 edge_index: Union[np.ndarray, Tuple[np.ndarray, np.ndarray]],
                 edge_ids: Optional[np.ndarray] = None,
                 layout: str = "COO",
                 num_nodes: Optional[int] = None,
                 edge_weights: Optional[np.ndarray] = None):
        layout = layout.upper()
        if layout not in _LAYOUTS:
            raise ValueError(
                f"layout must be one of {_LAYOUTS}, got {layout!r}")
        if layout == "COO":
            edge_index = np.asarray(edge_index)
            row, col = edge_index[0], edge_index[1]
        else:
            indptr, indices = edge_index
            indptr = np.asarray(indptr)
            row, col = csr_to_coo(indptr, np.asarray(indices))
            if layout == "CSC":
                row, col = col, row
            if num_nodes is None:
                num_nodes = indptr.shape[0] - 1
        self._indptr, self._indices, self._edge_ids, perm = coo_to_csr(
            row, col, edge_ids, num_nodes, return_perm=True)
        self._edge_weights = (None if edge_weights is None
                              else np.asarray(edge_weights)[perm])

    @classmethod
    def from_csr_arrays(cls, indptr: np.ndarray, indices: np.ndarray,
                        edge_ids: Optional[np.ndarray] = None,
                        edge_weights: Optional[np.ndarray] = None
                        ) -> "CSRTopo":
        """Adopt finished CSR arrays as they are (no COO round trip, no
        copy: the shared-memory attach path maps them in place)."""
        t = cls.__new__(cls)
        t._indptr = np.asarray(indptr)
        t._indices = np.asarray(indices)
        t._edge_ids = (np.arange(t._indices.shape[0], dtype=np.int64)
                       if edge_ids is None else np.asarray(edge_ids))
        t._edge_weights = (None if edge_weights is None
                           else np.asarray(edge_weights))
        return t

    @property
    def indptr(self) -> np.ndarray:
        return self._indptr

    @property
    def indices(self) -> np.ndarray:
        return self._indices

    @property
    def edge_ids(self) -> np.ndarray:
        return self._edge_ids

    @property
    def edge_weights(self) -> Optional[np.ndarray]:
        return self._edge_weights

    @property
    def num_nodes(self) -> int:
        return self._indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return int(self._indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self._indptr)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self._indices, minlength=self.num_nodes)

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(row, col)`` of the out-edges in CSR order."""
        return csr_to_coo(self._indptr, self._indices)

    def __repr__(self) -> str:
        return (f"CSRTopo(num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges})")
