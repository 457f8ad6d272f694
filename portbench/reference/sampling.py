"""The sampled subgraph worked out again, and the checks of a batch.

A multi-hop sample around ``seeds`` with fanouts ``f_0..f_{L-1}``,
without replacement, under a threefry ``key``, as the program states it
(``jax.random``'s draw; :mod:`.threefry`):

* level 0 is the seeds, each once, in order; hop ``k`` draws for every
  node ``j`` of level ``k`` (its slot in the hop) positions in its CSR
  row: all of them, in order, when its degree ``d <= f_k``; else Floyd's
  k-subset, whose step ``i`` draws ``t_i = randint(split(split(key,
  L)[k], f_k)[i], (W,), 0, d - f_k + i + 1)[j]`` and keeps it unless an
  earlier step chose it, taking ``d - f_k + i`` then;
* level ``k + 1`` is, in order, the first occurrence of the hop's
  neighbours not reached before, in emission order (slot, then draw);
* a node buffer of ``capacity`` slots keeps the first ``capacity``
  nodes; edges to nodes past it are masked and the batch flagged.

:func:`sample` builds that sample; :func:`compare_sample` counts where
the program's batch differs from it, slot by slot, in the program's
static layout (hop ``k`` holds ``W_k x f_k`` edge slots, ``W_0`` the
batch size and ``W_{k+1} = W_k f_k``).  :func:`check_gather` compares
the gathered rows and labels with the table.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from . import threefry


class Sample(NamedTuple):
    nodes: torch.Tensor       # [n] every node reached, in order (uncut)
    levels: List[int]         # nodes new at each level
    hops: list                # per hop: (neighbour local [m, f], valid [m, f])


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """The distinct values of ``ids`` in order of first appearance."""
    if ids.numel() == 0:
        return ids
    uniq, inv = torch.unique(ids, return_inverse=True)
    pos = torch.arange(ids.shape[0], device=ids.device)
    first = torch.full((uniq.shape[0],), ids.shape[0], dtype=torch.long,
                       device=ids.device).scatter_reduce_(
                           0, inv, pos, "amin")
    return ids[torch.sort(first).values]


def draw(deg: torch.Tensor, fanout: int, key: torch.Tensor):
    """``(pos [n, f], valid [n, f])``: the CSR positions drawn for rows of
    degree ``deg`` (int64) under the hop's key, row ``j`` in slot ``j``."""
    n = deg.shape[0]
    steps = threefry.split(key, fanout)
    chosen = torch.empty((n, fanout), dtype=torch.int64, device=deg.device)
    for i in range(fanout):
        t = threefry.randint(steps[i], (deg - fanout + i + 1).clamp(min=1))
        dup = (chosen[:, :i] == t[:, None]).any(dim=1)
        chosen[:, i] = torch.where(dup, deg - fanout + i, t)
    slots = torch.arange(fanout, device=deg.device)
    pos = torch.where((deg > fanout)[:, None], chosen, slots[None, :])
    return pos, slots[None, :] < deg.clamp(max=fanout)[:, None]


def sample(indptr: torch.Tensor, indices: torch.Tensor, seeds: torch.Tensor,
           fanouts: Sequence[int], key: torch.Tensor) -> Sample:
    """The sample the specification gives (``indptr`` int64; ``seeds``
    -1 padded; ``key`` ``[2]`` int64)."""
    seeds = seeds.long()
    nodes = _first_occurrence(seeds[seeds >= 0])
    levels = [int(nodes.shape[0])]
    hop_keys = threefry.split(key, len(fanouts))
    drawn = []
    lo = 0
    for k, f in enumerate(fanouts):
        front = nodes[lo: lo + levels[k]]
        start = indptr[front]
        pos, valid = draw(indptr[front + 1] - start, int(f), hop_keys[k])
        nbr = torch.where(valid, indices[torch.where(
            valid, start[:, None] + pos, 0)].long(), -1)
        fresh = _first_occurrence(nbr[valid])
        fresh = fresh[~torch.isin(fresh, nodes)]
        lo += levels[k]
        nodes = torch.cat([nodes, fresh])
        levels.append(int(fresh.shape[0]))
        drawn.append((nbr, valid))
    order = torch.argsort(nodes)
    ranked = nodes[order]
    hops = []
    for nbr, valid in drawn:
        at = torch.searchsorted(ranked, nbr.clamp(min=0))
        local = order[at.clamp(max=ranked.shape[0] - 1)]
        hops.append((torch.where(valid, local, -1), valid))
    return Sample(nodes, levels, hops)


def edges(ref: Sample, capacity: Optional[int] = None):
    """``(src, dst)`` local ids of the valid edges in emission order
    (``src`` the neighbour, ``dst`` the node of the level before), and
    the nodes a buffer of ``capacity`` keeps."""
    cap = ref.nodes.shape[0] if capacity is None else capacity
    src, dst = [], []
    lo = 0
    for k, (local, valid) in enumerate(ref.hops):
        keep = valid & (local < cap)
        m, f = local.shape
        own = (lo + torch.arange(m, device=local.device))[:, None].expand(m, f)
        src.append(local[keep])
        dst.append(own[keep])
        lo += ref.levels[k]
    return torch.cat(src), torch.cat(dst), ref.nodes[:cap]


def compare_sample(ref: Sample, batch_size: int, fanouts: Sequence[int],
                   node: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                   edge_mask: torch.Tensor, node_mask: torch.Tensor,
                   per_hop_nodes: torch.Tensor,
                   overflow: Optional[bool]) -> Dict[str, int]:
    """Slots where one program batch differs from ``ref``: ``bad_nodes``
    (level sizes, node ids, node mask, overflow flag) and ``bad_edges``
    (edge mask, and the two ends of every valid edge)."""
    cap = node.shape[0]
    total = int(ref.nodes.shape[0])
    kept = min(total, cap)
    got_levels = [int(c) for c in per_hop_nodes.tolist()]
    bad_nodes = sum(a != b for a, b in zip(got_levels, ref.levels))
    bad_nodes += abs(len(got_levels) - len(ref.levels))
    bad_nodes += int((node[:kept].long() != ref.nodes[:kept]).sum())
    slots = torch.arange(cap, device=node.device)
    bad_nodes += int((node_mask.bool() != (slots < kept)).sum())
    if overflow is not None:
        bad_nodes += int(bool(overflow) != (total > cap))
    bad_edges = 0
    width, lo_e, lo_n = batch_size, 0, 0
    for k, f in enumerate(fanouts):
        local, valid = ref.hops[k]
        m = local.shape[0]
        size = width * f
        want = torch.zeros((width, f), dtype=torch.bool, device=node.device)
        want[:m] = valid & (local < cap)
        dst = torch.full((width, f), -1, dtype=torch.long, device=node.device)
        dst[:m] = local
        own = (lo_n + torch.arange(width, device=node.device))[:, None]
        got = edge_mask[lo_e: lo_e + size].reshape(width, f).bool()
        r = row[lo_e: lo_e + size].reshape(width, f).long()
        c = col[lo_e: lo_e + size].reshape(width, f).long()
        bad_edges += int((got != want).sum())
        bad_edges += int((((r != dst) | (c != own)) & got & want).sum())
        lo_e += size
        lo_n += ref.levels[k]
        width = size
    bad_edges += abs(int(edge_mask.shape[0]) - lo_e)
    return {"bad_nodes": int(bad_nodes), "bad_edges": int(bad_edges)}


def check_gather(table: torch.Tensor, labels: torch.Tensor,
                 node: torch.Tensor, node_mask: torch.Tensor,
                 x: torch.Tensor, y: torch.Tensor) -> Dict[str, float]:
    """The largest feature difference and the wrong labels of a batch's
    gather, reference rows ``table[node]``."""
    count = int(node_mask.sum())
    ids = node[:count].long()
    diff = 0.0
    if count:
        diff = float((x[:count].float() - table[ids].float()).abs().max())
    if x.shape[0] > count:
        diff = max(diff, float(x[count:].float().abs().max()))
    bad = int((y[:count].long() != labels[ids].long()).sum())
    bad += int((y[count:] != -1).sum())
    return {"x_max_diff": diff, "bad_labels": bad}
