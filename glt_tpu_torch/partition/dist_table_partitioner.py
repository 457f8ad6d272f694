"""Distributed partitioning fed directly from table readers (cf.
``glt_tpu/partition/dist_table_partitioner.py``).

Each rank drains its slice of an edge and a node table through the
reader protocol of :class:`~glt_tpu_torch.data.table_dataset.TableDataset`
(``common_io``-shaped ``read``/``close``; any factory works) and spills
rows per owner through the filesystem, the
:class:`DistRandomPartitioner` flow: stateless hash ownership and a
merge on a shared filesystem.

Usage (one call per rank, then one ``finalize``)::

    p = DistTableRandomPartitioner(out_dir, num_parts=4,
                                   num_nodes=n, num_edges=e)
    p.partition_rank_tables(rank, edge_table="odps://.../edges_slice_r",
                            node_table="odps://.../nodes_slice_r",
                            edge_id_offset=rank_edge_offset,
                            reader_factory=my_reader)
    ...
    p.finalize()

Records are as ``TableDataset.from_tables`` reads them: edge tables
yield ``(src_id, dst_id)``, node tables ``(id, "f1:f2:...:fd")``.
Global edge ids are ``edge_id_offset + position`` within the rank's
slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..data.table_dataset import (
    drain_table,
    parse_feature_field,
    resolve_reader_factory,
)
from .dist_random_partitioner import DistRandomPartitioner


class DistTableRandomPartitioner(DistRandomPartitioner):
    """Per-rank, table-fed distributed random partitioner."""

    def partition_rank_tables(
        self,
        rank: int,
        edge_table,
        node_table=None,
        reader_factory=None,
        edge_id_offset: int = 0,
        reader_batch_size: int = 1024,
    ) -> int:
        """Drain this rank's table slices and spill per-owner rows.

        Returns the number of edges read (so callers can chain
        ``edge_id_offset`` across ranks when slice sizes aren't known
        upfront).  Labels are not partitioned: label lookup stays a
        whole-array load at ``DistDataset.load`` time.
        """
        factory, oor = resolve_reader_factory(reader_factory)
        edge_recs = drain_table(edge_table, factory, oor, reader_batch_size)
        edge_index = np.stack([
            np.array([r[0] for r in edge_recs], dtype=np.int64),
            np.array([r[1] for r in edge_recs], dtype=np.int64)])
        edge_ids = edge_id_offset + np.arange(len(edge_recs), dtype=np.int64)

        node_ids: Optional[np.ndarray] = None
        node_feat: Optional[np.ndarray] = None
        if node_table is not None:
            node_recs = drain_table(node_table, factory, oor,
                                    reader_batch_size)
            # An empty slice must not spill: np.asarray([]) is 1-D and
            # would break finalize's (k, d) feature concatenation.
            if node_recs:
                node_ids = np.array([r[0] for r in node_recs],
                                    dtype=np.int64)
                node_feat = np.asarray(
                    [parse_feature_field(r[1]) for r in node_recs],
                    np.float32)

        self.partition_rank_chunk(rank, edge_index, edge_ids,
                                  node_ids=node_ids, node_feat=node_feat)
        return len(edge_recs)
