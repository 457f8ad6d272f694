"""Distributed random partitioning: per-rank chunks, no global view (cf.
``glt_tpu/partition/dist_random_partitioner.py``).

Ownership is a seeded stateless hash every rank computes alike (no
partition-book exchange), and rows move through the filesystem: each
rank writes per-partition spill files for its chunk
(``_spill_rank<r>/``), and ``finalize`` concatenates them into the
on-disk layout of :mod:`glt_tpu_torch.partition.base`.  Ranks can be
processes on one host or jobs on a shared filesystem; nothing needs to
fit in one memory.  numpy only: either package loads the result.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

_MIX = np.uint64(0x9E3779B97F4A7C15)


def hash_partition(ids: np.ndarray, num_parts: int, seed: int) -> np.ndarray:
    """Stateless balanced-ish owner assignment (splitmix-style mixer)."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        x = ids.astype(np.uint64) + np.uint64(seed) * _MIX
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        # gltlint: disable-next=int64-id-truncation -- a partition number below num_parts
        return (x % np.uint64(num_parts)).astype(np.int32)


class DistRandomPartitioner:
    """Args:
      output_dir: shared output root.
      num_parts: number of partitions.
      num_nodes / num_edges: global counts.
      seed: hash seed — must match across ranks.
    """

    def __init__(self, output_dir: str, num_parts: int, num_nodes: int,
                 num_edges: int, seed: int = 0,
                 edge_assign_strategy: str = "by_src"):
        self.output_dir = output_dir
        self.num_parts = int(num_parts)
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.seed = int(seed)
        assert edge_assign_strategy in ("by_src", "by_dst")
        self.edge_assign_strategy = edge_assign_strategy

    def _spill_dir(self, rank: int) -> str:
        d = os.path.join(self.output_dir, f"_spill_rank{rank}")
        os.makedirs(d, exist_ok=True)
        return d

    # -- per-rank work ------------------------------------------------------
    def partition_rank_chunk(
        self,
        rank: int,
        edge_index: np.ndarray,          # [2, e_chunk] global ids
        edge_ids: np.ndarray,            # [e_chunk]
        node_ids: Optional[np.ndarray] = None,   # ids of feat rows held here
        node_feat: Optional[np.ndarray] = None,  # [n_chunk, d]
    ) -> None:
        d = self._spill_dir(rank)
        anchor = (edge_index[0] if self.edge_assign_strategy == "by_src"
                  else edge_index[1])
        e_owner = hash_partition(np.asarray(anchor), self.num_parts,
                                 self.seed)
        for p in range(self.num_parts):
            m = e_owner == p
            np.savez(os.path.join(d, f"edges_p{p}.npz"),
                     rows=edge_index[0][m], cols=edge_index[1][m],
                     eids=np.asarray(edge_ids)[m])
        if node_feat is not None:
            n_owner = hash_partition(np.asarray(node_ids), self.num_parts,
                                     self.seed)
            for p in range(self.num_parts):
                m = n_owner == p
                np.savez(os.path.join(d, f"nodes_p{p}.npz"),
                         ids=np.asarray(node_ids)[m],
                         feats=np.asarray(node_feat)[m])

    # -- merge: the owner-side accumulate ----------------------------------
    def finalize(self, with_node_feat: bool = True) -> None:
        node_pb = hash_partition(np.arange(self.num_nodes), self.num_parts,
                                 self.seed)
        os.makedirs(self.output_dir, exist_ok=True)
        np.save(os.path.join(self.output_dir, "node_pb.npy"), node_pb)

        ranks = sorted(
            int(d[len("_spill_rank"):]) for d in os.listdir(self.output_dir)
            if d.startswith("_spill_rank"))
        # -1 marks "no rank spilled this edge" so coverage gaps fail loudly
        # instead of silently landing every missing edge in partition 0.
        edge_pb = np.full(self.num_edges, -1, np.int32)
        for p in range(self.num_parts):
            rows, cols, eids, ids, feats = [], [], [], [], []
            for r in ranks:
                d = self._spill_dir(r)
                ef = os.path.join(d, f"edges_p{p}.npz")
                if os.path.exists(ef):
                    z = np.load(ef)
                    rows.append(z["rows"])
                    cols.append(z["cols"])
                    eids.append(z["eids"])
                nf = os.path.join(d, f"nodes_p{p}.npz")
                if with_node_feat and os.path.exists(nf):
                    z = np.load(nf)
                    ids.append(z["ids"])
                    feats.append(z["feats"])
            pdir = os.path.join(self.output_dir, f"part{p}", "graph")
            os.makedirs(pdir, exist_ok=True)
            cat = lambda xs: (np.concatenate(xs) if xs
                              else np.empty(0, np.int64))
            all_eids = cat(eids)
            np.save(os.path.join(pdir, "rows.npy"), cat(rows))
            np.save(os.path.join(pdir, "cols.npy"), cat(cols))
            np.save(os.path.join(pdir, "eids.npy"), all_eids)
            edge_pb[all_eids.astype(np.int64)] = p
            if with_node_feat and ids:
                fdir = os.path.join(self.output_dir, f"part{p}", "node_feat")
                os.makedirs(fdir, exist_ok=True)
                np.save(os.path.join(fdir, "ids.npy"), np.concatenate(ids))
                np.save(os.path.join(fdir, "feats.npy"),
                        np.concatenate(feats))
                np.save(os.path.join(fdir, "cache_ids.npy"),
                        np.empty(0, np.int64))
                np.save(os.path.join(fdir, "cache_feats.npy"),
                        np.empty((0,) + feats[0].shape[1:],
                                 feats[0].dtype))
        unassigned = int(np.count_nonzero(edge_pb < 0))
        if unassigned:
            raise RuntimeError(
                f"{unassigned} of {self.num_edges} edge ids were not "
                f"covered by any rank's spill files; every rank must call "
                f"partition_rank_chunk before finalize")
        np.save(os.path.join(self.output_dir, "edge_pb.npy"), edge_pb)
        np.save(os.path.join(self.output_dir, "node_feat_pb.npy"), node_pb)
        # Atomic META publish, as partition/base.py does: the META write
        # is the "partition set complete" commit point.
        meta_path = os.path.join(self.output_dir, "META.json")
        meta_tmp = f"{meta_path}.tmp-{os.getpid()}"
        with open(meta_tmp, "w") as fh:
            json.dump({
                "num_parts": self.num_parts,
                "num_nodes": self.num_nodes,
                "num_edges": self.num_edges,
                "edge_assign_strategy": self.edge_assign_strategy,
                "with_node_feat": with_node_feat,
                "with_edge_feat": False,
            }, fh)
        os.replace(meta_tmp, meta_path)
        # clean spill dirs
        for r in ranks:
            d = self._spill_dir(r)
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)
