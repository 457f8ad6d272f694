"""Partition directory -> the sharded dataset of a mesh (cf.
``glt_tpu/distributed/dist_dataset.py``, the single-process load).

Ownership must end up **arithmetic** (``owner = id // c``) for the
all-to-all routing, so the partition books fold into a one-time
contiguous relabel (:func:`~glt_tpu_torch.partition.contiguous.contiguous_relabel`)
instead of being read per lookup.  Hotness orders each partition's rows
hottest-first (the rows the reference would have hot-cached come
first).  Labels ride a sharded ``[S, c]`` block.  With ``hot_ratio <
1`` only each shard's hottest rows go to the device and the rest stay in
host memory (:class:`~glt_tpu_torch.parallel.dist_feature.
TieredShardedFeature`).

``mesh=`` (each host loading only its own partitions) is left for a
later slice (ROADMAP queue A item 7).
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..data.topology import CSRTopo
from ..parallel.dist_feature import TieredShardedFeature, shard_feature_tiered
from ..parallel.sharding import (
    ShardedFeature,
    ShardedGraph,
    shard_feature,
    shard_graph,
)
from ..partition.base import load_partition
from ..partition.contiguous import (
    ContiguousRelabel,
    contiguous_relabel,
    relabel_rows,
    relabel_topology,
)
from ..utils.device import DeviceLike, resolve_device


class DistDataset(NamedTuple):
    """Everything the distributed train step consumes."""
    graph: ShardedGraph
    feature: Optional[Union[ShardedFeature, TieredShardedFeature]]
    labels: Optional[torch.Tensor]         # [S, nodes_per_shard], -1 padded
    relabel: ContiguousRelabel
    num_parts: int

    # -- seed handling -----------------------------------------------------
    def translate(self, old_ids: np.ndarray) -> np.ndarray:
        """Global original ids -> relabelled (mesh) ids."""
        return self.relabel.old2new[np.asarray(old_ids)]

    def split_seeds(self, old_ids: np.ndarray, batch_size: int,
                    shuffle: bool = False, seed: int = 0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Group seeds by owner shard into ``[num_batches, S, B]`` (-1 pad):
        shard ``s`` trains on the seeds it owns, so hop 0 of every batch
        needs no exchange.

        ``rng``: a stateful Generator the caller threads through the
        epochs (each call draws a fresh permutation); without it a fresh
        ``default_rng(seed)`` replays one permutation every call.
        """
        new = self.translate(old_ids)
        if shuffle:
            gen = rng if rng is not None else np.random.default_rng(seed)
            new = new[gen.permutation(new.shape[0])]
        c = self.relabel.nodes_per_shard
        s_count = self.num_parts
        per_shard: List[np.ndarray] = [new[new // c == s]
                                       for s in range(s_count)]
        nb = max((p.shape[0] + batch_size - 1) // batch_size
                 for p in per_shard)
        out = np.full((nb, s_count, batch_size), -1, np.int64)
        for s, ids in enumerate(per_shard):
            for b in range(nb):
                chunk = ids[b * batch_size: (b + 1) * batch_size]
                out[b, s, : chunk.shape[0]] = chunk
        return out

    @staticmethod
    def load(
        root: str,
        hot_ratio: float = 1.0,
        labels: Optional[np.ndarray] = None,
        hotness: Optional[np.ndarray] = None,
        dtype=None,
        mesh=None,
        axis_name: str = "shard",
        device: DeviceLike = None,
    ) -> "DistDataset":
        """Compose a saved partition directory into sharded tensors on
        ``device`` (default ``"cuda"``), the device of the mesh that
        trains on it.

        Args:
          root: a partitioner's output directory.
          hot_ratio: fraction of each shard's rows on the device (the
            hottest first); below 1 the feature is a
            :class:`TieredShardedFeature` whose other rows stay in host
            memory.
          labels: optional global ``[N]`` label array.
          hotness: optional global ``[N]`` score ordering each
            partition's rows hottest-first; default the in-degree.
          dtype: optional feature dtype (torch or numpy).
          mesh: per-host loading; not ported.
        """
        del axis_name
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: loading each host's own partitions waits for "
                "multihost on torch.distributed (ROADMAP queue A item 7); "
                "pass device= to load every partition here")
        dev = resolve_device(device)
        with open(os.path.join(root, "META.json")) as fh:
            meta = json.load(fh)
        num_parts = int(meta["num_parts"])
        num_nodes = int(meta["num_nodes"])
        node_pb = np.load(os.path.join(root, "node_pb.npy"))

        # 1) every partition's edges and features.
        edge_chunks, eid_chunks = [], []
        feat_ids, feat_rows = [], []
        feat_dim = None
        for p in range(num_parts):
            graph, node_feat, _, _, _, _ = load_partition(root, p)
            edge_chunks.append(graph.edge_index)
            eid_chunks.append(graph.eids)
            if node_feat is not None:
                feat_ids.append(node_feat.ids)
                feat_rows.append(node_feat.feats)
                feat_dim = node_feat.feats.shape[1]
        edge_index = np.concatenate(edge_chunks, axis=1)
        edge_ids = np.concatenate(eid_chunks)

        # 2) the hotness-ordered contiguous relabel.
        if hotness is None:
            hotness = np.bincount(edge_index[1], minlength=num_nodes)
        rel = contiguous_relabel(node_pb, hotness=hotness,
                                 num_parts=num_parts)
        topo = relabel_topology(
            CSRTopo(edge_index, edge_ids=edge_ids, num_nodes=num_nodes), rel)
        g = shard_graph(topo, num_parts, device=dev)

        # 3) features into new-id order, then tiered or sharded.
        feature = None
        if feat_dim is not None:
            all_ids = np.concatenate(feat_ids)
            all_rows = np.concatenate(feat_rows)
            full = np.zeros((num_nodes, feat_dim), all_rows.dtype)
            full[all_ids.astype(np.int64)] = all_rows
            new_order = relabel_rows(full, rel)
            if hot_ratio >= 1.0:
                feature = shard_feature(new_order, num_parts, dtype=dtype,
                                        device=dev)
            else:
                feature = shard_feature_tiered(new_order, num_parts,
                                               hot_ratio, dtype=dtype,
                                               device=dev)

        lab = None
        if labels is not None:
            lab_new = relabel_rows(np.asarray(labels), rel, fill=-1)
            lab = torch.from_numpy(np.ascontiguousarray(
                lab_new.reshape(num_parts, rel.nodes_per_shard)
                .astype(np.int32))).to(dev)

        return DistDataset(graph=g, feature=feature, labels=lab,
                           relabel=rel, num_parts=num_parts)
