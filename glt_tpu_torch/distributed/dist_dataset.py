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

With ``mesh=`` a mesh that spans processes loads per process: each
process reads only the partitions of its own shards and holds only
their rows (the reference's "each machine loads its own partition").
"""
from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..data.topology import CSRTopo
from ..parallel import multihost
from ..parallel.dist_feature import (TieredShardedFeature, _hot_rows,
                                     shard_feature_tiered)
from ..parallel.sharding import (
    ShardedFeature,
    ShardedGraph,
    shard_feature,
    shard_graph,
    torch_dtype,
)
from ..partition.base import load_partition
from ..partition.contiguous import (
    ContiguousRelabel,
    contiguous_relabel,
    relabel_rows,
    relabel_topology,
)
from ..utils.device import DeviceLike, resolve_device, same_device


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
          mesh: load per process (:meth:`_load_multihost`): every tensor
            holds this process's shards' rows, on the mesh's device; the
            mesh's shard count must equal the directory's partitions.
            In-degree hotness then sums every process's partitions'
            counts (:func:`~glt_tpu_torch.parallel.multihost.agree_sum`);
            pass ``hotness`` to skip that gather.
        """
        with open(os.path.join(root, "META.json")) as fh:
            meta = json.load(fh)
        num_parts = int(meta["num_parts"])
        num_nodes = int(meta["num_nodes"])
        node_pb = np.load(os.path.join(root, "node_pb.npy"))
        if mesh is not None:
            if device is not None and not same_device(device, mesh.device):
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            if meta.get("edge_assign_strategy", "by_src") != "by_src":
                raise ValueError(
                    "per-host loading requires the by_src edge layout "
                    "(each partition owns its sources' out-edges)")
            return DistDataset._load_multihost(
                root, num_parts, num_nodes, node_pb, hot_ratio, labels,
                hotness, dtype, mesh, axis_name)
        dev = resolve_device(device)

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

    @staticmethod
    def _load_multihost(root, num_parts, num_nodes, node_pb, hot_ratio,
                        labels, hotness, dtype, mesh, axis_name):
        """Per-process composition: local partitions -> this process's
        shard rows (cf. ``glt_tpu``'s ``_load_multihost``).

        Every process computes the global contiguous relabel from the
        small ``node_pb`` and hotness arrays, loads only its own
        partitions' edges and feature rows, pads its CSR blocks to the
        edge width the processes agree on, and keeps its shards' rows:
        no process holds another's partition.
        """
        if mesh.size != num_parts:
            raise ValueError(
                f"mesh has {mesh.size} devices but the partition dir "
                f"holds {num_parts} partitions")
        local = multihost.local_shard_range(mesh, axis_name)

        # 1) local partitions only (edges and feature rows, old ids).
        parts = []
        local_max_e = 0
        for p in local:
            graph, node_feat, _, _, _, _ = load_partition(root, p)
            parts.append((p, graph, node_feat))
            local_max_e = max(local_max_e, int(graph.eids.shape[0]))

        # In-degree hotness needs incoming edges, which may live in any
        # partition: the processes sum their local counts.
        if hotness is None:
            local_deg = np.zeros(num_nodes, np.int64)
            for _, graph, _ in parts:
                local_deg += np.bincount(graph.edge_index[1],
                                         minlength=num_nodes)
            hotness = multihost.agree_sum(local_deg)
        rel = contiguous_relabel(node_pb, hotness=hotness,
                                 num_parts=num_parts)
        c = rel.nodes_per_shard

        # Relabelled per-partition CSR blocks and feature rows.
        part_topos, part_feats = [], []
        feat_dim = None
        for p, graph, node_feat in parts:
            src, dst = graph.edge_index
            nsrc = rel.old2new[src] - p * c
            if nsrc.size and (nsrc.min() < 0 or nsrc.max() >= c):
                raise ValueError(
                    f"partition {p} holds edges whose sources it does not "
                    f"own — not a by_src layout")
            part_topos.append(CSRTopo(np.stack([nsrc, rel.old2new[dst]]),
                                      edge_ids=graph.eids, num_nodes=c))
            if node_feat is not None:
                nloc = rel.old2new[node_feat.ids.astype(np.int64)] - p * c
                part_feats.append((nloc, node_feat.feats))
                feat_dim = node_feat.feats.shape[1]
                feat_dtype = node_feat.feats.dtype
            else:
                part_feats.append(None)

        # 2) pad to the agreed edge width; this process's graph blocks.
        max_e = multihost.agree_max(local_max_e)
        k = len(part_topos)
        ip = np.zeros((k, c + 1), np.int32)
        ix = np.full((k, max_e), -1, np.int32)
        ei = np.full((k, max_e), -1, np.int32)
        for j, t in enumerate(part_topos):
            ne = t.indices.shape[0]
            ip[j] = t.indptr.astype(np.int32)
            ix[j, :ne] = t.indices
            ei[j, :ne] = t.edge_ids
        g = ShardedGraph(
            indptr=multihost.assemble_global(ip, mesh, axis_name),
            indices=multihost.assemble_global(ix, mesh, axis_name),
            edge_ids=multihost.assemble_global(ei, mesh, axis_name),
            nodes_per_shard=c, num_nodes=num_nodes, num_shards=num_parts)

        # 3) features: each shard's [c, d] block, the hot prefix on the
        #    device and the rest in this process's host memory.
        feature = None
        if feat_dim is not None:
            h = c if hot_ratio >= 1.0 else _hot_rows(c, hot_ratio)
            hot = np.zeros((k, h, feat_dim), feat_dtype)
            cold = np.zeros((k, c - h, feat_dim), feat_dtype)
            for j, pf in enumerate(part_feats):
                if pf is None:
                    continue
                nloc, rows = pf
                blk = np.zeros((c, feat_dim), feat_dtype)
                blk[nloc] = rows
                hot[j] = blk[:h]
                cold[j] = blk[h:]
            hot_t = multihost.assemble_global(hot, mesh, axis_name)
            if dtype is not None:
                hot_t = hot_t.to(torch_dtype(dtype))
            if hot_ratio >= 1.0:
                feature = ShardedFeature(rows=hot_t, nodes_per_shard=c,
                                         num_shards=num_parts)
            else:
                feature = TieredShardedFeature(
                    hot=hot_t, cold=cold, nodes_per_shard=c,
                    hot_per_shard=h, num_shards=num_parts)

        # 4) labels: the whole-graph array (small) -> this process's rows.
        lab = None
        if labels is not None:
            lab_new = relabel_rows(np.asarray(labels), rel, fill=-1)
            lab_blk = lab_new.reshape(num_parts, c)[local.start: local.stop]
            lab = multihost.assemble_global(lab_blk.astype(np.int32), mesh,
                                            axis_name)

        return DistDataset(graph=g, feature=feature, labels=lab,
                           relabel=rel, num_parts=num_parts)
