"""Vineyard (GraphScope) store connectors (cf. ``glt_tpu/data/vineyard.py``).

Reads a property-graph fragment's CSR topology and vertex/edge feature
columns out of a vineyard object store: per (v_label, e_label) the
outgoing offset array, the adjacency's neighbor ids and edge ids, and
property columns reshaped into ``[n, k]`` float32 matrices.  The three
entry points work against a small documented fragment protocol
(:class:`FragmentProtocol`), so the logic runs without a deployment:

* pass any object implementing the protocol (:class:`MockFragment`, or
  a thin adapter over a deployment's fragment class), or
* pass ``(sock, object_id)`` to :func:`connect_fragment`, which fetches
  the object through the ``vineyard`` client (gated: imported only
  there) and wraps a real ``ArrowFragment`` in
  :class:`ArrowFragmentAdapter`.

Host numpy; :func:`fragment_to_dataset` places the dataset on
``device`` (default ``"cuda"``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.device import DeviceLike
from .topology import CSRTopo


class FragmentProtocol:
    """Duck-typed fragment interface (document, not a base class): the
    slices of ``vineyard::ArrowFragment`` the connector reads.

    * ``outgoing_offsets(v_label, e_label) -> [n+1] int array`` — CSR
      indptr for the label pair (``GetOutgoingOffsetArray``).
    * ``outgoing_indices(v_label, e_label) -> [E] int array`` — neighbor
      vertex ids (``GetOutgoingAdjList`` neighbors).
    * ``outgoing_edge_ids(v_label, e_label) -> [E] int array or None``
      (``edge_id`` per adjacency entry; None when ``has_eid=False``).
    * ``vertex_columns(v_label) -> Dict[str, np.ndarray]`` — property
      name -> ``[n]`` or ``[n, k]`` column.
    * ``edge_columns(e_label) -> Dict[str, np.ndarray]``.
    """


class MockFragment:
    """In-memory :class:`FragmentProtocol` implementation (tests/dev)."""

    def __init__(self, indptr, indices, edge_ids=None,
                 vertex_cols: Optional[Dict[str, np.ndarray]] = None,
                 edge_cols: Optional[Dict[str, np.ndarray]] = None):
        self._indptr = {(0, 0): np.asarray(indptr)}
        self._indices = {(0, 0): np.asarray(indices)}
        self._eids = {(0, 0): None if edge_ids is None
                      else np.asarray(edge_ids)}
        self._vcols = {0: dict(vertex_cols or {})}
        self._ecols = {0: dict(edge_cols or {})}

    def outgoing_offsets(self, v_label, e_label):
        return self._indptr[(v_label, e_label)]

    def outgoing_indices(self, v_label, e_label):
        return self._indices[(v_label, e_label)]

    def outgoing_edge_ids(self, v_label, e_label):
        return self._eids[(v_label, e_label)]

    def vertex_columns(self, v_label):
        return self._vcols[v_label]

    def edge_columns(self, e_label):
        return self._ecols[e_label]


class ArrowFragmentAdapter:
    """:class:`FragmentProtocol` over a REAL ``vineyard::ArrowFragment``.

    Wraps an object exposing the C++ fragment surface, as bound to
    Python by GraphScope/vineyard deployments:

    * ``GetOutgoingOffsetArray(v_label, e_label)`` +
      ``GetOutgoingOffsetLength(v_label, e_label)`` — the CSR indptr;
    * ``InnerVertices(v_label)`` — iterable of vertex handles;
    * ``GetOutgoingAdjList(v, e_label)`` — iterable of entries with
      ``get_neighbor().GetValue()`` and ``edge_id()``
      (``GetOutgoingRawAdjList`` when edge ids are absent);
    * ``vertex_data_table(v_label)`` / ``edge_data_table(e_label)`` —
      Arrow tables with ``ColumnNames()`` / ``column_names`` and
      ``GetColumnByName(name)`` / ``column(name)`` chunked columns.

    It imports nothing of vineyard (it only touches the passed object),
    so it runs without a deployment; ``connect_fragment`` wraps fetched
    objects in it.
    """

    def __init__(self, frag):
        self._f = frag
        self._adj_cache: Dict[tuple, tuple] = {}

    # -- topology -----------------------------------------------------------
    def outgoing_offsets(self, v_label, e_label):
        arr = np.asarray(self._f.GetOutgoingOffsetArray(v_label, e_label),
                         dtype=np.int64)
        n = int(self._f.GetOutgoingOffsetLength(v_label, e_label))
        return arr[:n]

    def _walk_adj(self, v_label, e_label):
        """One Python pass over the adjacency, cached: ``to_csr`` reads
        both indices and edge ids, and at real fragment scale the
        per-edge loop dominates load time.  A fragment loaded without
        edge ids falls back to the raw adjacency list
        (``GetOutgoingRawAdjList``), yielding ``eids=None``.
        """
        key = (v_label, e_label)
        if key in self._adj_cache:
            return self._adj_cache[key]
        nbrs, eids = [], []
        has_eid = True
        try:
            adj = self._f.GetOutgoingAdjList
        except AttributeError:
            # Fragments loaded without edge ids may expose only the raw
            # adjacency surface.
            adj = self._f.GetOutgoingRawAdjList
            has_eid = False
        for v in self._f.InnerVertices(v_label):
            for e in adj(v, e_label):
                nbrs.append(int(e.get_neighbor().GetValue()))
                if has_eid:
                    try:
                        eids.append(int(e.edge_id()))
                    except AttributeError:
                        has_eid = False
        out = (np.asarray(nbrs, dtype=np.int64),
               np.asarray(eids, dtype=np.int64) if has_eid else None)
        self._adj_cache[key] = out
        return out

    def outgoing_indices(self, v_label, e_label):
        return self._walk_adj(v_label, e_label)[0]

    def outgoing_edge_ids(self, v_label, e_label):
        return self._walk_adj(v_label, e_label)[1]

    # -- property columns ---------------------------------------------------
    @staticmethod
    def _chunk_to_numpy(chunk) -> np.ndarray:
        if hasattr(chunk, "to_numpy"):
            try:  # arrow arrays need zero_copy_only=False for strings
                return np.asarray(chunk.to_numpy(zero_copy_only=False))
            except TypeError:
                return np.asarray(chunk.to_numpy())
        return np.asarray(chunk)

    @classmethod
    def _table_columns(cls, tbl) -> Dict[str, np.ndarray]:
        names = (list(tbl.ColumnNames()) if hasattr(tbl, "ColumnNames")
                 else list(tbl.column_names))
        cols = {}
        for name in names:
            col = (tbl.GetColumnByName(name)
                   if hasattr(tbl, "GetColumnByName")
                   else tbl.column(name))
            # Arrow ChunkedArrays hold several chunks at fragment scale
            # (one per record batch): concatenate them all, or the table
            # is silently truncated.
            if hasattr(col, "num_chunks"):
                parts = [cls._chunk_to_numpy(col.chunk(i))
                         for i in range(col.num_chunks)]
                cols[name] = (parts[0] if len(parts) == 1
                              else np.concatenate(parts))
            elif hasattr(col, "chunk"):
                cols[name] = cls._chunk_to_numpy(col.chunk(0))
            else:
                cols[name] = cls._chunk_to_numpy(col)
        return cols

    def vertex_columns(self, v_label):
        return self._table_columns(self._f.vertex_data_table(v_label))

    def edge_columns(self, e_label):
        return self._table_columns(self._f.edge_data_table(e_label))


def _require_vineyard():
    try:
        import vineyard  # noqa: F401
        return vineyard
    except ImportError as e:
        raise ImportError(
            "vineyard support requires the 'vineyard' client package "
            "(GraphScope deployments); pass a FragmentProtocol object "
            "directly, or load your graph via Dataset/TableDataset"
        ) from e


def connect_fragment(sock: str, object_id):
    """Fetch a fragment through the vineyard client (gated).

    The returned object must implement :class:`FragmentProtocol`; wrap
    your deployment's fragment class if it does not.
    """
    vineyard = _require_vineyard()
    client = vineyard.connect(sock)
    frag = client.get_object(object_id)
    if all(hasattr(frag, m) for m in ("outgoing_offsets",
                                      "outgoing_indices",
                                      "vertex_columns")):
        return frag
    if all(hasattr(frag, m) for m in ("GetOutgoingOffsetArray",
                                      "InnerVertices",
                                      "vertex_data_table")):
        # A real ArrowFragment binding: adapt it.
        return ArrowFragmentAdapter(frag)
    raise TypeError(
        f"vineyard object {object_id} implements neither the fragment "
        f"protocol nor the ArrowFragment accessor surface; wrap it in an "
        f"adapter exposing FragmentProtocol (see module docstring)")


def _resolve(frag_or_sock, object_id):
    if isinstance(frag_or_sock, str):
        return connect_fragment(frag_or_sock, object_id)
    return frag_or_sock


def to_csr(frag_or_sock, object_id=None, v_label: int = 0,
           e_label: int = 0, has_eid: bool = True) -> CSRTopo:
    """Read one (v_label, e_label) fragment CSR into a :class:`CSRTopo`.

    Args:
      frag_or_sock: a :class:`FragmentProtocol` object, or a vineyard IPC
        socket path (then ``object_id`` is required).
    """
    frag = _resolve(frag_or_sock, object_id)
    indptr = np.asarray(frag.outgoing_offsets(v_label, e_label),
                        dtype=np.int64)
    indices = np.asarray(frag.outgoing_indices(v_label, e_label),
                         dtype=np.int64)
    tail = int(indptr[-1]) if indptr.ndim == 1 and indptr.size else None
    if tail is None or tail != indices.shape[0]:
        raise ValueError(
            f"fragment CSR is inconsistent: indptr[-1]={tail} but "
            f"{indices.shape[0]} indices")
    edge_ids = None
    if has_eid:
        edge_ids = frag.outgoing_edge_ids(v_label, e_label)
        if edge_ids is not None:
            edge_ids = np.asarray(edge_ids, dtype=np.int64)
    return CSRTopo((indptr, indices), layout="CSR", edge_ids=edge_ids)


def _columns_to_matrix(cols: Dict[str, np.ndarray],
                       selected: Optional[List[str]]) -> np.ndarray:
    """Stack selected property columns into a float32 ``[n, d]``
    matrix."""
    names = list(cols.keys()) if selected is None else list(selected)
    if not names:
        raise ValueError("no feature columns selected")
    blocks = []
    n = None
    for name in names:
        if name not in cols:
            raise KeyError(f"fragment has no column {name!r}; available: "
                           f"{sorted(cols)}")
        col = np.asarray(cols[name], dtype=np.float32)
        if col.ndim == 1:
            col = col[:, None]
        if n is None:
            n = col.shape[0]
        elif col.shape[0] != n:
            raise ValueError(
                f"column {name!r} has {col.shape[0]} rows, expected {n}")
        blocks.append(col)
    return np.concatenate(blocks, axis=1)


def load_vertex_features(frag_or_sock, object_id=None, v_label: int = 0,
                         columns: Optional[List[str]] = None) -> np.ndarray:
    """Vertex property columns as ``[n, d]`` float32."""
    frag = _resolve(frag_or_sock, object_id)
    return _columns_to_matrix(frag.vertex_columns(v_label), columns)


def load_edge_features(frag_or_sock, object_id=None, e_label: int = 0,
                       columns: Optional[List[str]] = None) -> np.ndarray:
    """Edge property columns as ``[E, d]`` float32."""
    frag = _resolve(frag_or_sock, object_id)
    return _columns_to_matrix(frag.edge_columns(e_label), columns)


def fragment_to_dataset(frag, v_label: int = 0, e_label: int = 0,
                        feature_columns: Optional[List[str]] = None,
                        label_column: Optional[str] = None,
                        device: DeviceLike = None,
                        split_ratio: float = 1.0):
    """A fragment as a ready-to-sample :class:`Dataset` on ``device``
    (``glt_tpu``'s takes ``graph_mode=`` there)."""
    from .dataset import Dataset
    from .graph import Graph

    topo = to_csr(frag, v_label=v_label, e_label=e_label)
    ds = Dataset(device=device)
    ds.graph = Graph(topo, device=ds.device)
    vcols = frag.vertex_columns(v_label)
    feat_cols = feature_columns
    if feat_cols is None:
        feat_cols = [c for c in vcols if c != label_column]
    if feat_cols:
        ds.init_node_features(_columns_to_matrix(vcols, feat_cols),
                              split_ratio=split_ratio)
    if label_column is not None:
        ds.init_node_labels(np.asarray(vcols[label_column]).ravel())
    return ds
