"""Graphs, features and labels made from ``--seed``, on the device.

The degree law is ``benchmarks/graph_gen.py``'s, rewritten in torch at
the published sizes: a Pareto tail (``1 + Lomax(alpha)``) capped at
``dmax``, scaled so its mean is the published ``E / N``, floored, held in
``[1, dmax]``, then moved by one edge at a time on nodes drawn at random
until it sums to exactly ``E``.  Neighbour ids are drawn uniformly from
``[0, N)``; features are standard normal rows; labels are uniform over
the classes; the train split is the first ``train_nodes`` of a random
permutation.  Every draw comes from one ``torch.Generator`` on the
device, in a few large calls, so the same seed gives the same arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Rows of features drawn in one call (bounds a call's element count).
_ROWS_PER_CALL = 1 << 22


@dataclass
class GraphData:
    """The benchmark's own copy of a generated graph and its data.

    ``indptr``/``indices`` are host int32 arrays (the program's
    ``CSRTopo`` takes host arrays); ``table``, ``labels`` live on the
    device; ``train_idx`` is a host int64 array."""
    num_nodes: int
    num_edges: int
    indptr: np.ndarray
    indices: np.ndarray
    table: torch.Tensor
    labels: torch.Tensor
    train_idx: np.ndarray


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def powerlaw_degrees(n: int, e: int, law: dict, g: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """``[n]`` int64 out-degrees, each in ``[1, dmax]``, summing to ``e``."""
    alpha, dmax = float(law["alpha"]), int(law["dmax"])
    if not n <= e <= n * dmax:
        raise ValueError(f"{e} edges cannot spread over {n} nodes with "
                         f"degrees in [1, {dmax}]")
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    raw = torch.clamp((1.0 - u).pow(-1.0 / alpha), max=float(dmax))
    deg = torch.floor(raw * (e / n / raw.mean())).to(torch.int64)
    deg = deg.clamp_(1, dmax)
    diff = e - int(deg.sum())
    while diff != 0:
        step = 1 if diff > 0 else -1
        room = deg < dmax if step > 0 else deg > 1
        cand = torch.nonzero(room).reshape(-1)
        pick = cand[torch.randperm(cand.shape[0], generator=g,
                                   device=device)[:abs(diff)]]
        deg[pick] += step
        diff -= step * int(pick.shape[0])
    return deg


def make_graph(graph_cfg: dict, seed: int, device: torch.device,
               num_nodes: Optional[int] = None,
               num_edges: Optional[int] = None) -> GraphData:
    """The configuration's graph, features, labels and train split."""
    n = int(num_nodes or graph_cfg["num_nodes"])
    e = int(num_edges or graph_cfg["num_edges"])
    d = int(graph_cfg["feature_dim"])
    classes = int(graph_cfg["num_classes"])
    t = int(graph_cfg["train_nodes"])
    g = generator(seed, device)
    deg = powerlaw_degrees(n, e, graph_cfg["degree_law"], g, device)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])
    del deg
    indptr_h = indptr.to(torch.int32).cpu().numpy()
    del indptr
    indices = torch.randint(0, n, (e,), generator=g, device=device,
                            dtype=torch.int32)
    indices_h = indices.cpu().numpy()
    del indices
    table = torch.empty((n, d), dtype=torch.float32, device=device)
    for lo in range(0, n, _ROWS_PER_CALL):
        table[lo: lo + _ROWS_PER_CALL].normal_(generator=g)
    labels = torch.randint(0, classes, (n,), generator=g, device=device,
                           dtype=torch.int32)
    perm = torch.randperm(n, generator=g, device=device)
    train_idx = perm[:t].cpu().numpy().astype(np.int64)
    del perm
    return GraphData(n, e, indptr_h, indices_h, table, labels, train_idx)
