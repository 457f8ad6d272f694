"""A heterogeneous graph, its features, labels and train split, made from
``--seed`` on the device (the hetero counterpart of :mod:`.gen`).

The configuration's ``graph`` names the node types with their counts
and the relations with their edge counts.  Each relation ``(s, rel, t)``
gives every node of ``s`` an out-degree from :func:`.gen.powerlaw_degrees`
at the relation's mean (``num_edges / N_s``) under its ``degree_law``;
a relation with fewer edges than source nodes gives one edge each to a
uniform random subset of ``num_edges`` sources.  Neighbour ids are
uniform over ``[0, N_t)``.  Each relation named in ``reverse`` also
gets its transpose ``(t, rev_rel, s)``: the same edges, each row's
neighbours in ascending order.  Features are standard normal rows of
``feature_dtype`` per node type; labels are uniform over the classes on
the target type; the train split is the first ``train_share`` of a
random permutation of the target type's nodes.  Every draw comes from
one ``torch.Generator`` on the device, in a fixed order, so the same
seed gives the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from . import gen

EdgeType = Tuple[str, str, str]

# Rows of features drawn in one call (bounds a call's element count).
_ROWS_PER_CALL = 1 << 18


@dataclass
class HeteroGraphData:
    """The benchmark's own copy of a generated hetero graph and its data.

    ``csr``: ``edge type -> (indptr, indices)`` host int32 arrays (out-edge
    CSR over the source type's nodes); ``tables``: ``node type -> [N_t,
    d]`` rows on the device; ``labels``: the target type's ``[N]`` int32
    labels on the device; ``train_idx``: host int64 target ids."""
    num_nodes: Dict[str, int]
    csr: Dict[EdgeType, Tuple[np.ndarray, np.ndarray]]
    tables: Dict[str, torch.Tensor]
    labels: torch.Tensor
    train_idx: np.ndarray
    target: str


def reverse_name(rel: str) -> str:
    return rel[4:] if rel.startswith("rev_") else "rev_" + rel


def _degrees(n: int, e: int, law: dict, g: torch.Generator,
             dev: torch.device) -> torch.Tensor:
    if e >= n:
        return gen.powerlaw_degrees(n, e, law, g, dev)
    deg = torch.zeros(n, dtype=torch.int64, device=dev)
    pick = torch.randperm(n, generator=g, device=dev)[:e]
    deg[pick] = 1
    return deg


def _csr(deg: torch.Tensor) -> torch.Tensor:
    indptr = torch.zeros(deg.shape[0] + 1, dtype=torch.int64,
                         device=deg.device)
    torch.cumsum(deg, 0, out=indptr[1:])
    return indptr


def _transpose(indptr: torch.Tensor, indices: torch.Tensor, n_dst: int):
    """The reverse CSR over ``n_dst`` rows, each row's neighbours (the
    forward sources) ascending."""
    n_src = indptr.shape[0] - 1
    src = torch.repeat_interleave(
        torch.arange(n_src, dtype=torch.int32, device=indptr.device),
        indptr[1:] - indptr[:-1])
    order = torch.sort(indices.long(), stable=True).indices
    rev_indices = src[order]
    del src, order
    deg = torch.bincount(indices.long(), minlength=n_dst)
    return _csr(deg), rev_indices


def make_hetero(graph_cfg: dict, seed: int, device: torch.device
                ) -> HeteroGraphData:
    """The configuration's graph, features, labels and train split."""
    counts = {t: int(n) for t, n in graph_cfg["node_types"].items()}
    d = int(graph_cfg["feature_dim"])
    classes = int(graph_cfg["num_classes"])
    target = graph_cfg["target_type"]
    dtype = getattr(torch, graph_cfg.get("feature_dtype", "float32"))
    reverse = set(graph_cfg.get("reverse", ()))
    g = gen.generator(seed, device)
    csr = {}
    for rel in graph_cfg["relations"]:
        s, r, t = rel["edge_type"]
        e = int(rel["num_edges"])
        deg = _degrees(counts[s], e, rel["degree_law"], g, device)
        indptr = _csr(deg)
        del deg
        indices = torch.randint(0, counts[t], (e,), generator=g,
                                device=device, dtype=torch.int32)
        csr[(s, r, t)] = (indptr.to(torch.int32).cpu().numpy(),
                          indices.cpu().numpy())
        if r in reverse:
            rptr, rind = _transpose(indptr, indices, counts[t])
            csr[(t, reverse_name(r), s)] = (
                rptr.to(torch.int32).cpu().numpy(), rind.cpu().numpy())
            del rptr, rind
        del indptr, indices
    tables = {}
    for t in sorted(counts):
        n = counts[t]
        table = torch.empty((n, d), dtype=dtype, device=device)
        for lo in range(0, n, _ROWS_PER_CALL):
            table[lo: lo + _ROWS_PER_CALL].normal_(generator=g)
        tables[t] = table
    labels = torch.randint(0, classes, (counts[target],), generator=g,
                           device=device, dtype=torch.int32)
    perm = torch.randperm(counts[target], generator=g, device=device)
    n_train = int(float(graph_cfg["train_share"]) * counts[target])
    train_idx = perm[:n_train].cpu().numpy().astype(np.int64)
    del perm
    return HeteroGraphData(counts, csr, tables, labels, train_idx, target)
