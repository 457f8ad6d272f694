"""The heterogeneous sample worked out again, and the check of a batch.

A multi-hop sample of seeds of one node type over several edge types,
as the program states it (``glt_tpu_torch.sampler.HeteroNeighborSampler``
with calibrated widths ``W[h][t]``, level 0 the seeds):

* the key of hop ``h`` and edge type ``i`` (the edge types sorted) is
  ``split(key, H * types)[h * types + i]``; the edge type ``(s, r, t)``
  samples at hop ``h`` when its fanout there is positive and ``s`` has a
  hop-``h`` frontier, drawing for frontier slot ``j`` as
  :func:`.sampling.draw` does (row ``j`` in slot ``j``) over ``W[h][s]``
  slots;
* per node type ``t`` (sorted), the hop's candidates of the edge types
  ending at ``t`` (in sorted order, each row by row) extend ``t``'s
  cumulative list of first occurrences; the nodes new at the hop are
  level ``h + 1``;
* the type's buffer keeps the first ``C[t] = max(sum_h W[h][t], 1)``
  nodes of its list: edges to nodes past it are masked;
* the hop-``h + 1`` frontier of ``t`` is the first ``W[h + 1][t]`` kept
  nodes of level ``h + 1`` (a kept node past it expands no further hop);
* the batch overflows when a level's count, over the kept count before
  it, exceeds its width.

Edges come out under the reversed edge type, ``row`` the neighbour and
``col`` the frontier node, each hop ``W[h][s] x f`` slots.
:func:`compare` counts where the program's batch differs, slot by slot.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import threefry
from .sampling import _first_occurrence, draw

EdgeType = Tuple[str, str, str]


class HeteroSample(NamedTuple):
    nodes: Dict[str, torch.Tensor]   # every node reached, in order (uncut)
    levels: Dict[str, List[int]]     # kept nodes new at each level
    cap: Dict[str, int]              # each type's buffer
    hops: Dict[EdgeType, list]       # (start, width, local [n, f], kept)
    overflow: bool


def reverse(et: EdgeType) -> EdgeType:
    """The reversed edge type, as the program names it."""
    s, r, t = et
    if s != t:
        r = r[4:] if r.startswith("rev_") else "rev_" + r
    return (t, r, s)


def sample(csr: Dict[EdgeType, Tuple[torch.Tensor, torch.Tensor]],
           seeds: torch.Tensor, input_type: str,
           fanouts: Dict[EdgeType, Sequence[int]],
           widths: Sequence[Dict[str, int]], key: torch.Tensor
           ) -> HeteroSample:
    """``csr``: edge type -> (indptr int64, indices) on one device;
    ``seeds`` -1 padded; ``widths``: levels ``0..H``."""
    ets = sorted(csr)
    types = sorted({et[0] for et in ets} | {et[2] for et in ets}
                   | {input_type})
    hops_n = len(widths) - 1
    dev = seeds.device
    cap = {t: max(sum(int(w.get(t, 0)) for w in widths), 1)
           for t in types}
    keys = threefry.split(key, hops_n * len(ets))
    seeds = seeds.long()
    nodes = {t: torch.zeros(0, dtype=torch.long, device=dev) for t in types}
    nodes[input_type] = _first_occurrence(seeds[seeds >= 0])
    kept = {t: min(nodes[t].shape[0], cap[t]) for t in types}
    levels = {t: [kept[t]] for t in types}
    frontier: Dict[str, Optional[Tuple[int, torch.Tensor]]] = {
        t: None for t in types}
    frontier[input_type] = (0, nodes[input_type][: widths[0][input_type]])
    hops = {et: [] for et in ets}
    overflow = False
    for h in range(hops_n):
        drawn = {}
        for i, et in enumerate(ets):
            s, _, t = et
            fo = fanouts[et]
            f = int(fo[h]) if h < len(fo) else 0
            w = int(widths[h].get(s, 0))
            if f <= 0 or w <= 0 or frontier[s] is None:
                continue
            start, front = frontier[s]
            indptr, indices = csr[et]
            lo = indptr[front]
            pos, valid = draw(indptr[front + 1] - lo, f,
                              keys[h * len(ets) + i])
            nbr = torch.where(valid, indices[torch.where(
                valid, lo[:, None] + pos, 0)].long(), -1)
            drawn[et] = (start, w, nbr, valid)
        nxt = {}
        for t in types:
            into = [et for et in drawn if et[2] == t]
            if not into:
                levels[t].append(0)
                continue
            old = kept[t]
            cands = torch.cat([drawn[et][2][drawn[et][3]] for et in into])
            fresh = _first_occurrence(cands)
            fresh = fresh[~torch.isin(fresh, nodes[t])]
            nodes[t] = torch.cat([nodes[t], fresh])
            total = nodes[t].shape[0]
            w_next = int(widths[h + 1].get(t, 0))
            overflow |= total - old > w_next
            kept[t] = min(total, cap[t])
            levels[t].append(kept[t] - old)
            if h + 1 < hops_n and w_next > 0:
                nxt[t] = (old, nodes[t][old: kept[t]][:w_next])
        for t in types:
            frontier[t] = nxt.get(t)
        for et, (start, w, nbr, valid) in drawn.items():
            t = et[2]
            order = torch.argsort(nodes[t])
            ranked = nodes[t][order]
            at = torch.searchsorted(ranked, nbr.clamp(min=0))
            local = order[at.clamp(max=max(ranked.shape[0] - 1, 0))]
            local = torch.where(valid, local, -1)
            hops[et].append((start, w, local, valid & (local < cap[t])))
    return HeteroSample(nodes, levels, cap, hops, bool(overflow))


def edges(ref: HeteroSample) -> Dict[EdgeType, Tuple[torch.Tensor,
                                                     torch.Tensor]]:
    """Per reversed edge type ``(src, dst)``: local ids of the kept edges
    in emission order (``src`` the neighbour, ``dst`` the frontier
    node)."""
    out = {}
    for et, parts in ref.hops.items():
        src, dst = [], []
        for start, _, local, keep in parts:
            n, f = local.shape
            own = (start + torch.arange(n, device=local.device))[:, None]
            src.append(local[keep])
            dst.append(own.expand(n, f)[keep])
        if src:
            out[reverse(et)] = (torch.cat(src), torch.cat(dst))
    return out


def kept_nodes(ref: HeteroSample) -> Dict[str, torch.Tensor]:
    return {t: v[: ref.cap[t]] for t, v in ref.nodes.items()}


def compare(ref: HeteroSample, out, overflow: Optional[bool]
            ) -> Dict[str, int]:
    """Slots where the program's batch ``out`` (a ``HeteroSamplerOutput``)
    differs from ``ref``: ``bad_nodes`` (each type's level counts, ids
    and mask, and the overflow flag) and ``bad_edges`` (each reversed
    edge type's mask and the two ends of every kept edge, and a slot
    count that differs)."""
    bad_nodes = 0
    for t, want in ref.nodes.items():
        node = out.node[t]
        kept = min(int(want.shape[0]), ref.cap[t])
        got = [int(c) for c in out.num_sampled_nodes[t].tolist()]
        bad_nodes += sum(a != b for a, b in zip(got, ref.levels[t]))
        bad_nodes += abs(len(got) - len(ref.levels[t]))
        bad_nodes += int((node[:kept].long() != want[:kept]).sum())
        slots = torch.arange(node.shape[0], device=node.device)
        bad_nodes += int((out.node_mask[t].bool() != (slots < kept)).sum())
    if overflow is not None:
        bad_nodes += int(bool(overflow) != ref.overflow)
    bad_edges = 0
    for et, parts in ref.hops.items():
        rev = reverse(et)
        mask, row, col = out.edge_mask[rev], out.row[rev], out.col[rev]
        lo = 0
        for start, w, local, keep in parts:
            n, f = local.shape
            dev = mask.device
            want = torch.zeros((w, f), dtype=torch.bool, device=dev)
            want[:n] = keep
            dst = torch.full((w, f), -1, dtype=torch.long, device=dev)
            dst[:n] = local
            own = (start + torch.arange(w, device=dev))[:, None]
            got = mask[lo: lo + w * f].reshape(w, f).bool()
            r = row[lo: lo + w * f].reshape(w, f).long()
            c = col[lo: lo + w * f].reshape(w, f).long()
            bad_edges += int((got != want).sum())
            bad_edges += int((((r != dst) | (c != own)) & got & want).sum())
            lo += w * f
        bad_edges += abs(int(mask.shape[0]) - lo)
    return {"bad_nodes": int(bad_nodes), "bad_edges": int(bad_edges)}
