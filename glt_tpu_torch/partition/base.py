"""Offline graph partitioning: orchestration and the on-disk layout (cf.
``glt_tpu/partition/base.py``).

``PartitionerBase`` assigns nodes (a subclass's strategy), then node
features, edges and edge features, and writes one directory per
partition as ``.npy`` files, in ``glt_tpu``'s layout byte for byte:

    <root>/
      META.json                  {num_parts, num_nodes, num_edges, ...}
      node_pb.npy                dense node -> partition book
      edge_pb.npy                dense edge -> partition book
      node_feat_pb.npy           feature ownership
      part{i}/graph/{rows,cols,eids}.npy
      part{i}/node_feat/{feats,ids}.npy [+ cache_feats, cache_ids]
      part{i}/edge_feat/{feats,ids}.npy

Host code, numpy only: partitioning happens once, before training, and
never touches the card.
"""
from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod
from typing import List, Optional, Tuple

import numpy as np

from ..typing import FeaturePartitionData, GraphPartitionData


class PartitionerBase(ABC):
    """Orchestrates a full partition pass.

    Args:
      output_dir: root directory for the on-disk layout.
      num_parts: number of partitions.
      num_nodes: global node count.
      edge_index: ``[2, E]`` COO (row=src, col=dst).
      edge_ids: ``[E]`` global edge ids (default positions).
      node_feat / edge_feat: optional feature matrices.
      edge_assign_strategy: 'by_src' or 'by_dst': an edge goes to the
        partition of that endpoint.
      chunk_size: nodes per assignment chunk.
    """

    def __init__(
        self,
        output_dir: str,
        num_parts: int,
        num_nodes: int,
        edge_index: np.ndarray,
        edge_ids: Optional[np.ndarray] = None,
        node_feat: Optional[np.ndarray] = None,
        edge_feat: Optional[np.ndarray] = None,
        edge_assign_strategy: str = "by_src",
        chunk_size: int = 10000,
    ):
        self.output_dir = output_dir
        self.num_parts = int(num_parts)
        self.num_nodes = int(num_nodes)
        self.edge_index = np.asarray(edge_index)
        self.num_edges = int(self.edge_index.shape[1])
        self.edge_ids = (np.arange(self.num_edges, dtype=np.int64)
                         if edge_ids is None else np.asarray(edge_ids))
        self.node_feat = None if node_feat is None else np.asarray(node_feat)
        self.edge_feat = None if edge_feat is None else np.asarray(edge_feat)
        if edge_assign_strategy not in ("by_src", "by_dst"):
            raise ValueError(f"edge_assign_strategy must be 'by_src' or "
                             f"'by_dst', got {edge_assign_strategy!r}")
        self.edge_assign_strategy = edge_assign_strategy
        self.chunk_size = int(chunk_size)

    # -- node assignment (subclass strategy) -------------------------------
    @abstractmethod
    def _partition_node(self) -> np.ndarray:
        """Return the dense node partition book ``[num_nodes] -> part``."""
        raise NotImplementedError

    def _cache_node(self, node_pb: np.ndarray) -> List[np.ndarray]:
        """Per-partition ids of *remote* nodes to hot-cache (default none)."""
        return [np.empty(0, np.int64) for _ in range(self.num_parts)]

    # -- orchestration -------------------------------------------------------
    def partition(self) -> None:
        node_pb = self._partition_node().astype(np.int32)

        # Edges follow their src (or dst) endpoint's partition.
        anchor = (self.edge_index[0] if self.edge_assign_strategy == "by_src"
                  else self.edge_index[1])
        edge_pb = node_pb[anchor].astype(np.int32)

        cache_ids = self._cache_node(node_pb)
        # The feature book starts as node_pb; cached rows stay owned by
        # their partition and are also resolvable locally through
        # cat_feature_cache.
        node_feat_pb = node_pb.copy()

        os.makedirs(self.output_dir, exist_ok=True)
        np.save(os.path.join(self.output_dir, "node_pb.npy"), node_pb)
        np.save(os.path.join(self.output_dir, "edge_pb.npy"), edge_pb)
        np.save(os.path.join(self.output_dir, "node_feat_pb.npy"),
                node_feat_pb)
        # META.json is the partition set's read gate (loaders open it
        # first): publish it atomically, so a loader racing the
        # partitioner sees no partition set or a complete one.
        meta_path = os.path.join(self.output_dir, "META.json")
        meta_tmp = f"{meta_path}.tmp-{os.getpid()}"
        with open(meta_tmp, "w") as fh:
            json.dump({
                "num_parts": self.num_parts,
                "num_nodes": self.num_nodes,
                "num_edges": self.num_edges,
                "edge_assign_strategy": self.edge_assign_strategy,
                "with_node_feat": self.node_feat is not None,
                "with_edge_feat": self.edge_feat is not None,
            }, fh)
        os.replace(meta_tmp, meta_path)

        for p in range(self.num_parts):
            pdir = os.path.join(self.output_dir, f"part{p}")
            gdir = os.path.join(pdir, "graph")
            os.makedirs(gdir, exist_ok=True)
            emask = edge_pb == p
            np.save(os.path.join(gdir, "rows.npy"), self.edge_index[0][emask])
            np.save(os.path.join(gdir, "cols.npy"), self.edge_index[1][emask])
            np.save(os.path.join(gdir, "eids.npy"), self.edge_ids[emask])

            if self.node_feat is not None:
                fdir = os.path.join(pdir, "node_feat")
                os.makedirs(fdir, exist_ok=True)
                own = np.where(node_pb == p)[0]
                np.save(os.path.join(fdir, "ids.npy"), own)
                np.save(os.path.join(fdir, "feats.npy"), self.node_feat[own])
                np.save(os.path.join(fdir, "cache_ids.npy"), cache_ids[p])
                np.save(os.path.join(fdir, "cache_feats.npy"),
                        self.node_feat[cache_ids[p].astype(np.int64)])

            if self.edge_feat is not None:
                fdir = os.path.join(pdir, "edge_feat")
                os.makedirs(fdir, exist_ok=True)
                np.save(os.path.join(fdir, "ids.npy"), self.edge_ids[emask])
                np.save(os.path.join(fdir, "feats.npy"),
                        self.edge_feat[emask])


def load_partition(root: str, part_idx: int):
    """Load one partition.

    Returns ``(graph, node_feat, edge_feat, node_pb, edge_pb, meta)``:
    ``graph`` a :class:`GraphPartitionData`, the features
    :class:`FeaturePartitionData` or None.
    """
    with open(os.path.join(root, "META.json")) as fh:
        meta = json.load(fh)
    node_pb = np.load(os.path.join(root, "node_pb.npy"))
    edge_pb = np.load(os.path.join(root, "edge_pb.npy"))
    pdir = os.path.join(root, f"part{part_idx}")

    gdir = os.path.join(pdir, "graph")
    graph = GraphPartitionData(
        edge_index=np.stack([np.load(os.path.join(gdir, "rows.npy")),
                             np.load(os.path.join(gdir, "cols.npy"))]),
        eids=np.load(os.path.join(gdir, "eids.npy")))

    node_feat = None
    fdir = os.path.join(pdir, "node_feat")
    if meta["with_node_feat"] and os.path.isdir(fdir):
        node_feat = FeaturePartitionData(
            feats=np.load(os.path.join(fdir, "feats.npy")),
            ids=np.load(os.path.join(fdir, "ids.npy")),
            cache_feats=np.load(os.path.join(fdir, "cache_feats.npy")),
            cache_ids=np.load(os.path.join(fdir, "cache_ids.npy")))

    edge_feat = None
    fdir = os.path.join(pdir, "edge_feat")
    if meta["with_edge_feat"] and os.path.isdir(fdir):
        edge_feat = FeaturePartitionData(
            feats=np.load(os.path.join(fdir, "feats.npy")),
            ids=np.load(os.path.join(fdir, "ids.npy")))

    return graph, node_feat, edge_feat, node_pb, edge_pb, meta


def cat_feature_cache(part_feat: FeaturePartitionData,
                      num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Merge the hot-cache rows in front of the owned rows.

    Returns ``(feats, id2index)``: cache rows first (so a
    hotness-ordered ``split_ratio`` prefix covers them), then owned
    rows; ``id2index`` maps a global id to its local row (-1 where the
    partition cannot resolve it).
    """
    if part_feat.cache_ids is None or part_feat.cache_ids.size == 0:
        feats = part_feat.feats
        ids = part_feat.ids
    else:
        feats = np.concatenate([part_feat.cache_feats, part_feat.feats])
        ids = np.concatenate([part_feat.cache_ids, part_feat.ids])
    id2index = np.full(num_nodes, -1, np.int64)
    # later (owned) rows win over cache duplicates
    id2index[ids] = np.arange(ids.shape[0])
    return feats, id2index
