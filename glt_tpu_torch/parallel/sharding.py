"""Graph and feature sharding across a device mesh (cf.
``glt_tpu/parallel/sharding.py``).

Each mesh shard owns a contiguous node range, so the partition book is
arithmetic (``owner = id // nodes_per_shard``), and the padded per-shard
CSR blocks are ``[S, ...]`` tensors whose row ``s`` is shard ``s``'s
block.  General partitions from :mod:`glt_tpu_torch.partition` reach
this form through the contiguous relabel.  The blocks are built on the
host (numpy) and placed on the mesh's device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.topology import CSRTopo
from ..utils.device import DeviceLike, resolve_device, same_device


class ShardedGraph(NamedTuple):
    """Padded per-shard CSR blocks; leading axis = shard.

    ``indptr``: ``[S, nodes_per_shard + 1]`` local row pointers (0-based
    within the shard); ``indices``: ``[S, max_edges_per_shard]`` global
    neighbor ids (-1 padded); ``edge_ids``: same shape, global edge ids.
    All int32.
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    edge_ids: torch.Tensor
    nodes_per_shard: int
    num_nodes: int
    num_shards: int

    def owner_of(self, ids: torch.Tensor) -> torch.Tensor:
        """The partition book, arithmetic form (-1 for padding)."""
        return torch.where(ids >= 0, ids // self.nodes_per_shard, -1)


class ShardedFeature(NamedTuple):
    """Per-shard feature blocks: ``[S, nodes_per_shard, d]``."""
    rows: torch.Tensor
    nodes_per_shard: int
    num_shards: int


def shard_bounds(topo: CSRTopo, num_shards: int):
    """Per-shard node and edge ranges of the contiguous split.

    Returns ``(c, bounds, max_e)``: nodes per shard, ``(lo, hi, e0, e1)``
    per shard, and the largest shard's edge count (the padding width).
    """
    n = topo.num_nodes
    c = -(-n // num_shards)  # ceil
    indptr = topo.indptr
    max_e = 0
    bounds = []
    for s in range(num_shards):
        lo, hi = min(s * c, n), min((s + 1) * c, n)
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        bounds.append((lo, hi, e0, e1))
        max_e = max(max_e, e1 - e0)
    return c, bounds, max_e


def shard_graph_blocks(topo: CSRTopo, num_shards: int,
                       shard_range: Optional[range] = None,
                       pad_edges: Optional[int] = None):
    """Host numpy CSR blocks for ``shard_range`` (default: all).

    Returns ``(ip, ix, ei, c)`` with leading axis ``len(shard_range)``;
    ``pad_edges`` overrides the edge padding width.
    """
    c, bounds, max_e = shard_bounds(topo, num_shards)
    if pad_edges is not None:
        if pad_edges < max_e:
            raise ValueError(f"pad_edges {pad_edges} < local max {max_e}")
        max_e = pad_edges
    if shard_range is None:
        shard_range = range(num_shards)
    indptr = topo.indptr.astype(np.int64)
    indices = topo.indices.astype(np.int32)
    edge_ids = topo.edge_ids.astype(np.int32)

    k = len(shard_range)
    ip = np.zeros((k, c + 1), np.int32)
    ix = np.full((k, max_e), -1, np.int32)
    ei = np.full((k, max_e), -1, np.int32)
    for j, s in enumerate(shard_range):
        lo, hi, e0, e1 = bounds[s]
        local = (indptr[lo: hi + 1] - indptr[lo]).astype(np.int32)
        ip[j, : hi - lo + 1] = local
        ip[j, hi - lo + 1:] = local[-1] if local.size else 0
        ix[j, : e1 - e0] = indices[e0:e1]
        ei[j, : e1 - e0] = edge_ids[e0:e1]
    return ip, ix, ei, c


def shard_graph(topo: CSRTopo, num_shards: int,
                device: DeviceLike = None) -> ShardedGraph:
    """Split a CSR topology into contiguous per-shard blocks on
    ``device`` (default ``"cuda"``): nodes ``[s * c, (s+1) * c)`` go to
    shard ``s`` with ``c = ceil(N / num_shards)``, edge blocks padded to
    the largest shard's."""
    dev = resolve_device(device)
    ip, ix, ei, c = shard_graph_blocks(topo, num_shards)
    return ShardedGraph(
        indptr=torch.from_numpy(ip).to(dev),
        indices=torch.from_numpy(ix).to(dev),
        edge_ids=torch.from_numpy(ei).to(dev), nodes_per_shard=c,
        num_nodes=topo.num_nodes, num_shards=num_shards)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def shard_feature(feature: np.ndarray, num_shards: int, dtype=None,
                  device: DeviceLike = None) -> ShardedFeature:
    """Split ``[N, d]`` features into ``[S, c, d]`` blocks (zero padded)
    on ``device`` (default ``"cuda"``), cast to ``dtype`` if given."""
    dev = resolve_device(device)
    feature = np.asarray(feature)
    n, d = feature.shape
    c = -(-n // num_shards)
    rows = np.zeros((num_shards, c, d), feature.dtype)
    for s in range(num_shards):
        lo, hi = min(s * c, n), min((s + 1) * c, n)
        rows[s, : hi - lo] = feature[lo:hi]
    arr = torch.from_numpy(rows)
    if dtype is not None:
        arr = arr.to(torch_dtype(dtype))
    return ShardedFeature(rows=arr.to(dev), nodes_per_shard=c,
                          num_shards=num_shards)


def put_sharded(sharded, mesh, axis: Optional[str] = None):
    """Place each shard's block (the leading axis of every tensor field)
    on its mesh device.  The mesh's shards share one device, so this
    moves each tensor there once."""
    del axis
    dev = mesh.device

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            if x.shape[0] != mesh.size:
                raise ValueError(f"a block of {x.shape[0]} shards on a mesh "
                                 f"of {mesh.size}")
            return x.to(dev)
        return x

    return type(sharded)(*[place(v) for v in sharded])


def check_on_mesh(mesh, **tensors) -> None:
    """Every tensor must already sit on the mesh's device."""
    for name, t in tensors.items():
        if t is not None and not same_device(t.device, mesh.device):
            raise ValueError(f"{name} lives on {t.device}, the mesh on "
                             f"{mesh.device}; place it with put_sharded")
