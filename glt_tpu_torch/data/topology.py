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

_LAYOUTS = ("COO", "CSR", "CSC")


def coo_to_csr(row: np.ndarray, col: np.ndarray,
               edge_ids: Optional[np.ndarray] = None,
               num_nodes: Optional[int] = None):
    """COO -> CSR ``(indptr, indices, edge_ids)``.  Rows are grouped with
    a stable sort, so ties keep input order; ``edge_ids`` defaults to the
    input edge positions."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    if row.shape != col.shape or row.ndim != 1:
        raise ValueError("row/col must be 1-D arrays of equal length")
    if edge_ids is None:
        edge_ids = np.arange(row.shape[0], dtype=np.int64)
    else:
        edge_ids = np.asarray(edge_ids, dtype=np.int64)
    if num_nodes is None:
        num_nodes = int(max(row.max(initial=-1), col.max(initial=-1)) + 1)
    perm = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, col[perm], edge_ids[perm]


def csr_to_coo(indptr: np.ndarray, indices: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    indptr = np.asarray(indptr)
    row = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
    return row, np.asarray(indices)


class CSRTopo:
    """Graph topology stored as CSR over out-edges.

    Args:
      edge_index: ``[2, E]`` COO (row=src, col=dst) when layout is 'COO',
        otherwise ``(indptr, indices)``.
      edge_ids: optional ``[E]`` global edge ids (default: input positions).
      layout: 'COO' | 'CSR' | 'CSC' ('CSC' is the CSR of the reverse
        graph and is transposed into out-edge CSR).
      num_nodes: optional node count override.
    """

    def __init__(self,
                 edge_index: Union[np.ndarray, Tuple[np.ndarray, np.ndarray]],
                 edge_ids: Optional[np.ndarray] = None,
                 layout: str = "COO",
                 num_nodes: Optional[int] = None):
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
        self._indptr, self._indices, self._edge_ids = coo_to_csr(
            row, col, edge_ids, num_nodes)

    @classmethod
    def from_csr_arrays(cls, indptr: np.ndarray, indices: np.ndarray,
                        edge_ids: Optional[np.ndarray] = None) -> "CSRTopo":
        """Adopt finished CSR arrays as they are (no COO round trip)."""
        t = cls.__new__(cls)
        t._indptr = np.asarray(indptr)
        t._indices = np.asarray(indices)
        t._edge_ids = (np.arange(t._indices.shape[0], dtype=np.int64)
                       if edge_ids is None else np.asarray(edge_ids))
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
