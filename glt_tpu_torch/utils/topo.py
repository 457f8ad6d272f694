"""Host-side topology conversions (COO <-> CSR/CSC), cf.
``glt_tpu/utils/topo.py``.

Plain numpy: graph construction is host prep; the device only sees the
finished ``indptr``/``indices`` arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def coo_to_csr(
    row: np.ndarray,
    col: np.ndarray,
    edge_ids: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
    return_perm: bool = False,
):
    """Convert a COO edge list to CSR ``(indptr, indices, edge_ids)``.

    Rows are grouped by ``row`` with a stable sort, so ties keep input
    order.  ``edge_ids`` defaults to the input edge positions.  With
    ``return_perm`` the input -> CSR edge permutation is also returned,
    so callers can realign per-edge payloads (e.g. weights).
    """
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
    indices = col[perm]
    eids = edge_ids[perm]
    counts = np.bincount(row, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    if return_perm:
        return indptr, indices, eids, perm
    return indptr, indices, eids


def coo_to_csc(
    row: np.ndarray,
    col: np.ndarray,
    edge_ids: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSC is CSR of the transposed graph."""
    return coo_to_csr(col, row, edge_ids, num_nodes)


def csr_to_coo(
    indptr: np.ndarray, indices: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand CSR back to a COO ``(row, col)`` pair; the inverse of
    :func:`coo_to_csr`."""
    row = ptr2ind(indptr, indices.shape[0])
    return row, np.asarray(indices)


def ptr2ind(indptr: np.ndarray, num_edges: Optional[int] = None) -> np.ndarray:
    """Expand an indptr array to per-edge row indices."""
    indptr = np.asarray(indptr)
    return np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))


def degrees_from_ptr(indptr: np.ndarray) -> np.ndarray:
    return np.diff(np.asarray(indptr))
