"""TableDataset — graph, features and labels from tabular storage (cf.
``glt_tpu/data/table_dataset.py``).

Edge tables yield ``(src_id, dst_id)`` records and node tables ``(id,
"f1:f2:...:fd")`` records, read through a ``common_io``-shaped reader:
any object with ``read(batch_size, allow_smaller_final_batch=True)``
and ``close()``.  The PAI ``common_io`` package is optional: it is
imported only when no reader factory is given.  ``from_arrays`` is the
columnar path that needs no reader.  The dataset lives on ``device``
(default ``"cuda"``), as every port entry point's does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.device import DeviceLike
from .dataset import Dataset


def resolve_reader_factory(reader_factory):
    """Return ``(factory, out_of_range_exceptions)`` for table draining.

    Defaults to the PAI ``common_io`` reader; any object with
    ``read(batch_size, allow_smaller_final_batch=True)`` + ``close()``
    works in its place.
    """
    if reader_factory is None:
        try:
            import common_io
        except ImportError as e:
            raise ImportError(
                "table reading without reader_factory needs the PAI "
                "'common_io' reader; pass reader_factory=... (any object "
                "with read()/close()) elsewhere") from e
        return (common_io.table.TableReader,
                (StopIteration, common_io.exception.OutOfRangeException))
    try:
        import common_io
        return reader_factory, (StopIteration,
                                common_io.exception.OutOfRangeException)
    except ImportError:
        return reader_factory, (StopIteration,)


def drain_table(table, reader_factory, oor, batch_size: int = 1024):
    """Read every record of ``table`` through the reader protocol."""
    reader = reader_factory(table)
    records = []
    try:
        while True:
            try:
                got = reader.read(batch_size,
                                  allow_smaller_final_batch=True)
            except oor:
                break
            if not got:
                break
            records.extend(got)
    finally:
        reader.close()
    return records


def parse_feature_field(field) -> list:
    """Decode a ``"f1:f2:...:fd"`` feature string (str or bytes)."""
    if isinstance(field, bytes):
        field = field.decode()
    return [float(v) for v in field.split(":")]


class TableDataset(Dataset):
    """Build a :class:`~glt_tpu_torch.data.Dataset` from edge and node
    tables.

    ``from_arrays`` is the columnar path; ``from_tables`` drains table
    readers; ``from_odps`` is the two-table entry point over the gated
    ``common_io`` reader.  Each takes ``device=`` where ``glt_tpu``'s
    takes ``graph_mode=``.
    """

    @classmethod
    def from_arrays(
        cls,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        node_ids: Optional[np.ndarray] = None,
        node_feat: Optional[np.ndarray] = None,
        node_label: Optional[np.ndarray] = None,
        device: DeviceLike = None,
        split_ratio: float = 1.0,
    ) -> "TableDataset":
        num_nodes = None
        if node_ids is not None:
            num_nodes = int(np.max(node_ids)) + 1
        ds = cls(device=device)
        ds.init_graph(np.stack([np.asarray(edge_src), np.asarray(edge_dst)]),
                      num_nodes=num_nodes)
        if node_feat is not None:
            feat = np.asarray(node_feat)
            if node_ids is not None:
                full = np.zeros((num_nodes, feat.shape[1]), feat.dtype)
                full[np.asarray(node_ids)] = feat
                feat = full
            ds.init_node_features(feat, split_ratio=split_ratio)
        if node_label is not None:
            lab = np.asarray(node_label)
            if node_ids is not None:
                full = np.full(num_nodes, -1, lab.dtype)
                full[np.asarray(node_ids)] = lab
                lab = full
            ds.init_node_labels(lab)
        return ds

    @classmethod
    def from_tables(
        cls,
        edge_tables,
        node_tables,
        reader_factory=None,
        device: DeviceLike = None,
        split_ratio: float = 1.0,
        label_from_last_column: bool = False,
        reader_batch_size: int = 1024,
        **graph_kwargs,
    ) -> "TableDataset":
        """Build a dataset by draining table readers.

        Edge tables yield ``(src_id, dst_id)``; node tables yield ``(id,
        "f1:f2:...:fd")``, the string ``str`` or ``bytes``; with
        ``label_from_last_column`` the last component is split off as an
        integer label.  Feature rows are stored by id, so the graph's
        raw ids index them; ids no record names get zero features and
        label -1.

        ``reader_factory(table_name) -> reader`` returns an object whose
        ``read(batch_size, allow_smaller_final_batch=True)`` raises
        ``StopIteration`` (or common_io's OutOfRangeException) when
        drained, and ``close()``.  Single-entry dicts build a homogeneous
        dataset; multi-entry dicts (keyed by edge type / node type) a
        heterogeneous one.
        """
        reader_factory, oor = resolve_reader_factory(reader_factory)

        def drain(table):
            return drain_table(table, reader_factory, oor,
                               reader_batch_size)

        edge_hetero = len(edge_tables) > 1
        node_hetero = len(node_tables) > 1
        if edge_hetero != node_hetero:
            raise ValueError(
                f"edge_tables ({len(edge_tables)}) and node_tables "
                f"({len(node_tables)}) must agree on hetero-ness: a homo "
                f"graph with per-type features (or vice versa) is not a "
                f"consistent Dataset")
        edge_index = {}
        for e_type, table in edge_tables.items():
            recs = drain(table)
            edge_index[e_type] = np.stack([
                np.array([r[0] for r in recs], dtype=np.int64),
                np.array([r[1] for r in recs], dtype=np.int64)])
        if not edge_hetero:
            edge_index = next(iter(edge_index.values()))

        feats, labels = {}, {}
        for n_type, table in node_tables.items():
            recs = drain(table)
            ids = np.array([r[0] for r in recs], dtype=np.int64)
            mat = np.asarray([parse_feature_field(r[1]) for r in recs],
                             np.float32)
            n_rows = int(ids.max()) + 1 if ids.size else 0
            full = np.zeros((n_rows, mat.shape[1]), np.float32)
            full[ids] = mat
            if label_from_last_column:
                lab = np.full(n_rows, -1, np.int64)
                lab[ids] = full[ids][:, -1].astype(np.int64)
                labels[n_type] = lab
                full = full[:, :-1]
            feats[n_type] = full
        if not node_hetero:
            feats = next(iter(feats.values()))
            labels = next(iter(labels.values())) if labels else None

        ds = cls(device=device)
        ds.init_graph(edge_index, **graph_kwargs)
        ds.init_node_features(feats, split_ratio=split_ratio)
        if label_from_last_column:
            ds.init_node_labels(labels)
        return ds

    @classmethod
    def from_odps(cls, edge_table: str, node_table: str, **kwargs):
        """A homogeneous graph from two ODPS tables through the PAI
        ``common_io`` reader (gated; see :meth:`from_tables`)."""
        return cls.from_tables({"edge": edge_table}, {"node": node_table},
                               **kwargs)
