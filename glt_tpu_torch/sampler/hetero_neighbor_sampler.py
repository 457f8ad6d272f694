"""Heterogeneous multi-hop neighbor sampling with static shapes (cf.
``glt_tpu/sampler/hetero_neighbor_sampler.py``).

Per hop, every edge type whose source type has a frontier samples it
(kernel B1 on the card, once per (hop, edge type) with a nonzero
width); then, per destination type, the hop's candidates of every edge
type ending there are folded into that type's cumulative
first-occurrence node list, whose newly discovered slice is the type's
next frontier.  Widths per (hop, node type) follow from the fanouts
(:func:`hetero_hop_widths`), so every shape is static and the counts
that vary travel as device tensors.  Edges come out under the
*reversed* edge type, ``row`` = neighbor, ``col`` = seed side.

Per node type the inducer is the dense scatter map when the type's
node count is known and its map fits, else the sort-based unique; the
final hop may skip dedup (``last_hop_dedup=False``) and write a leaf
block.  The key of hop ``h`` and edge type ``i`` (the **sorted** edge
types) is ``split(key, hops * types)[h * types + i]``, so a skipped
edge type still owns its key, as in ``glt_tpu``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..data.graph import Graph
from ..ops.negative_sample import sample_negative_edges, weighted_draw
from ..ops.neighbor_sample import sample_neighbors
from ..ops.unique import (
    dense_induce,
    dense_induce_final,
    dense_induce_init,
    dense_map_fits,
    relabel_by_reference,
    unique_first_occurrence,
)
from ..typing import EdgeType, NodeType, PADDING_ID, reverse_edge_type
from .base import EdgeSamplerInput, HeteroSamplerOutput, NodeSamplerInput
from .neighbor_sampler import _pad, _pad_ids


def hetero_hop_widths(
    edge_types: Sequence[EdgeType],
    num_neighbors: Dict[EdgeType, List[int]],
    seed_widths: Dict[NodeType, int],
    num_hops: int,
    frontier_cap: Optional[int] = None,
) -> Tuple[List[Dict[NodeType, int]], Dict[NodeType, int]]:
    """Static frontier width per (hop, node type) and the total capacity
    per type.

    The hop-``i`` frontier of type ``t`` holds every node of type ``t``
    first discovered at hop ``i - 1`` across all edge types ending in
    ``t``; ``seed_widths`` gives the hop-0 frontiers.  ``frontier_cap``
    bounds each (hop, type) frontier; nodes discovered beyond it stay
    in the node set but expand no further hop.
    """
    ntypes = sorted({et[0] for et in edge_types} | {et[2] for et in edge_types}
                    | set(seed_widths))
    widths: List[Dict[NodeType, int]] = [
        {t: seed_widths.get(t, 0) for t in ntypes}]
    for hop in range(num_hops):
        nxt = {t: 0 for t in ntypes}
        for et in edge_types:
            fanouts = num_neighbors[et]
            if hop < len(fanouts) and fanouts[hop] > 0:
                nxt[et[2]] += widths[hop][et[0]] * fanouts[hop]
        if frontier_cap is not None:
            nxt = {t: min(w, frontier_cap) for t, w in nxt.items()}
        widths.append(nxt)
    capacity = {t: sum(w[t] for w in widths) for t in ntypes}
    return widths, capacity


def _node_mask(buf: torch.Tensor, count: torch.Tensor, fast) -> torch.Tensor:
    """Validity mask of a per-type node buffer: its compact prefix, or
    (interior prefix | leaf-region mask) when the final hop wrote the
    no-dedup leaf block."""
    idx = torch.arange(buf.shape[0], dtype=torch.int32, device=buf.device)
    if fast is None:
        return idx < count
    leaf_off, leaf_region, interior = fast
    return (idx < interior.clamp(max=leaf_off)) | leaf_region


def drive_steps(steps, one_hop):
    """Run a :meth:`HeteroNeighborSampler._sample_steps` generator,
    answering each request with ``one_hop(edge type, frontier, fanout,
    key)``; returns the generator's result."""
    try:
        req = next(steps)
        while True:
            req = steps.send(one_hop(*req))
    except StopIteration as done:
        return done.value


def _cat_or_empty(parts: List[torch.Tensor], dtype, fill, device
                  ) -> torch.Tensor:
    if parts:
        return torch.cat(parts)
    return torch.full((0,), fill, dtype=dtype, device=device)


class HeteroNeighborSampler:
    """Fixed-fanout sampler over per-edge-type
    :class:`~glt_tpu_torch.data.graph.Graph` s (out-edge CSR each, all
    on one device; sampling runs there).

    Args:
      graphs: dict ``EdgeType -> Graph``.
      num_neighbors: per-hop fanouts, a list (every edge type) or a dict
        keyed by edge type.
      input_type: node type of the seeds.
      batch_size: static seed width (callers pad).
      frontier_cap: optional cap on each (hop, node type) frontier.
      seed: base key seed; each sample without an explicit key folds in
        a call counter.
      last_hop_dedup: when False, a type's final-hop candidates skip the
        inducer and land in a leaf block (duplicates allowed), where its
        width allows.
    """

    def __init__(self, graphs: Dict[EdgeType, Graph], num_neighbors,
                 input_type: NodeType, batch_size: int = 512,
                 frontier_cap: Optional[int] = None, seed: int = 0,
                 last_hop_dedup: bool = True):
        self.graphs = graphs
        self.edge_types = sorted(graphs.keys())
        self.device = graphs[self.edge_types[0]].device
        if isinstance(num_neighbors, dict):
            self.num_neighbors = {et: list(v)
                                  for et, v in num_neighbors.items()}
        else:
            self.num_neighbors = {et: list(num_neighbors)
                                  for et in self.edge_types}
        self.num_hops = max(len(v) for v in self.num_neighbors.values())
        self.input_type = input_type
        self.batch_size = int(batch_size)
        self.last_hop_dedup = bool(last_hop_dedup)
        self.frontier_cap = frontier_cap
        self._base_key = trandom.PRNGKey(seed, device=self.device)
        self._call_count = 0
        self._widths, self._capacity = hetero_hop_widths(
            self.edge_types, self.num_neighbors,
            {input_type: self.batch_size}, self.num_hops,
            frontier_cap=frontier_cap)
        self.node_types = sorted(self._capacity.keys())
        # A type's id space covers both of its roles: its CSR row count
        # where it is a source, and the largest destination id arriving
        # from other edge types.  Read once from the host topologies;
        # a type with neither falls back to the sort-based inducer.
        self._num_nodes_by_type: Dict[NodeType, int] = {}
        for et, g in graphs.items():
            src_t, _, dst_t = et
            self._num_nodes_by_type[src_t] = max(
                self._num_nodes_by_type.get(src_t, 0), g.num_nodes)
            idx = np.asarray(g.topo.indices)
            if idx.size:
                self._num_nodes_by_type[dst_t] = max(
                    self._num_nodes_by_type.get(dst_t, 0),
                    int(idx.max()) + 1)
        self._edge_plans = {}

    @property
    def node_capacity(self) -> Dict[NodeType, int]:
        """Static per-node-type unique-node capacity."""
        return dict(self._capacity)

    @property
    def hop_widths(self) -> List[Dict[NodeType, int]]:
        """Per-hop per-node-type frontier widths (static shapes)."""
        return [dict(w) for w in self._widths]

    def graph_arrays(self):
        """``edge_type -> (indptr, indices, edge ids or None)`` for
        :meth:`_sample_impl`."""
        return {et: (g.indptr, g.indices, g.gather_edge_ids)
                for et, g in self.graphs.items()}

    def _next_key(self) -> torch.Tensor:
        key = trandom.fold_in(self._base_key, self._call_count)
        self._call_count += 1
        return key

    # -- the multi-hop sample ------------------------------------------------
    def _sample_impl(self, widths, cap, graph_arrays, seeds_dict, key
                     ) -> HeteroSamplerOutput:
        """One multi-hop sample.  ``seeds_dict``: node type -> padded
        ``[w]`` int32 seed tensor (the hop-0 frontiers) on the graphs'
        device; each hop request of :meth:`_sample_steps` answered by
        :func:`~glt_tpu_torch.ops.sample_neighbors` on ``graph_arrays``."""
        def one_hop(et, frontier, fanout, hop_key):
            indptr, indices, edge_ids = graph_arrays[et]
            return sample_neighbors(indptr, indices, frontier, fanout,
                                    hop_key, edge_ids=edge_ids)

        return drive_steps(
            self._sample_steps(widths, cap, seeds_dict, key), one_hop)

    def _sample_steps(self, widths, cap, seeds_dict, key):
        """The multi-hop body as a generator: it yields each one-hop
        request ``(edge type, frontier [w], fanout, key)`` and takes its
        :class:`~glt_tpu_torch.ops.neighbor_sample.NeighborOutput` back
        (``send``); its return value is the
        :class:`~glt_tpu_torch.sampler.base.HeteroSamplerOutput`.  The
        requests' order and shapes are static, the same for every seed
        batch, so the distributed sampler runs one generator a shard in
        lockstep and answers each round with one exchange over all
        shards (``glt_tpu``'s ``one_hop=`` override under
        ``shard_map``)."""
        node_types = sorted(cap.keys())
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)

        dense_state = {}
        for t in node_types:
            n_t = self._num_nodes_by_type.get(t)
            if n_t is not None and dense_map_fits(n_t):
                dense_state[t] = dense_induce_init(n_t, max(cap[t], 1),
                                                   device=dev)
        node_buf = {
            t: (dense_state[t].node_buf[: max(cap[t], 1)]
                if t in dense_state
                else torch.full((max(cap[t], 1),), PADDING_ID, **i32))
            for t in node_types}
        count = {t: torch.zeros((), **i32) for t in node_types}
        frontier = {t: None for t in node_types}
        frontier_start = {t: torch.zeros((), **i32) for t in node_types}

        for t0, seeds in seeds_dict.items():
            buflen0 = node_buf[t0].shape[0]
            if t0 in dense_state:
                dense_state[t0], _ = dense_induce(dense_state[t0], seeds)
                node_buf[t0] = dense_state[t0].node_buf[:buflen0]
                count[t0] = dense_state[t0].count.clamp(max=buflen0)
                # A copy: later hops append to the dense buffer in place.
                frontier[t0] = dense_state[t0].node_buf[: seeds.shape[0]
                                                        ].clone()
            else:
                u0 = unique_first_occurrence(seeds)
                buf = node_buf[t0].clone()
                buf[: seeds.shape[0]] = u0.uniques
                node_buf[t0] = buf
                count[t0] = u0.count
                frontier[t0] = u0.uniques

        rows = {et: [] for et in self.edge_types}
        cols = {et: [] for et in self.edge_types}
        eids = {et: [] for et in self.edge_types}
        emasks = {et: [] for et in self.edge_types}
        counts_hist = {t: [count[t]] for t in node_types}
        # t -> (leaf_off, leaf-region mask, interior count) for the types
        # whose final hop wrote the no-dedup leaf block.
        fast_leaf = {}
        # Worst-case interior uniques per type: seeds plus every RAW
        # candidate of the hops before the last.  With a frontier_cap
        # the interior can outgrow the space below the leaf block; the
        # leaf block stays off for such a type.
        raw_interior = {t: widths[0].get(t, 0) for t in node_types}
        for h in range(self.num_hops - 1):
            for et in self.edge_types:
                fo = self.num_neighbors[et]
                f = fo[h] if h < len(fo) else 0
                if f > 0:
                    raw_interior[et[2]] += widths[h][et[0]] * f

        n_et = len(self.edge_types)
        keys = trandom.split(key, self.num_hops * n_et)

        for hop in range(self.num_hops):
            last = hop + 1 == self.num_hops
            # 1) sample every active edge type from its source frontier
            hop_out = {}
            for ei_idx, et in enumerate(self.edge_types):
                fanouts = self.num_neighbors[et]
                f = fanouts[hop] if hop < len(fanouts) else 0
                w = widths[hop][et[0]]
                if f <= 0 or w <= 0 or frontier[et[0]] is None:
                    continue
                out = yield (et, frontier[et[0]], f,
                             keys[hop * n_et + ei_idx])
                src_local = frontier_start[et[0]] + torch.arange(w, **i32)
                src_local = torch.where(frontier[et[0]] >= 0, src_local,
                                        PADDING_ID)
                hop_out[et] = (out, src_local, w, f)

            # 2) per destination type: fold the candidates into its list
            new_frontier = {}
            for t in node_types:
                ets = [et for et in hop_out if et[2] == t]
                if not ets:
                    continue
                cands = torch.cat([hop_out[et][0].nbrs.reshape(-1)
                                   for et in ets])
                buflen = node_buf[t].shape[0]
                total_wf = sum(hop_out[et][2] * hop_out[et][3] for et in ets)
                if (last and not self.last_hop_dedup
                        and widths[hop + 1][t] >= total_wf
                        and raw_interior[t] <= buflen - widths[hop + 1][t]):
                    # The leaf block: the candidates at static offsets.
                    leaf_off = buflen - widths[hop + 1][t]
                    cmask = torch.cat([hop_out[et][0].mask.reshape(-1)
                                       for et in ets])
                    uniques_src = node_buf[t].clone()
                    uniques_src[leaf_off: leaf_off + total_wf] = torch.where(
                        cmask, cands, PADDING_ID)
                    merged_count = count[t] + cmask.sum(dtype=torch.int32)
                    inverse_tail = torch.where(
                        cmask, leaf_off + torch.arange(total_wf, **i32),
                        PADDING_ID)
                    off = 0
                    leaf_region = torch.zeros(buflen, dtype=torch.bool,
                                              device=dev)
                    leaf_region[leaf_off: leaf_off + total_wf] = cmask
                    fast_leaf[t] = (leaf_off, leaf_region, count[t])
                elif t in dense_state:
                    # The final hop skips the commit scatter: nothing
                    # reads the map afterwards.
                    induce = dense_induce_final if last else dense_induce
                    dense_state[t], locs = induce(dense_state[t], cands)
                    uniques_src = dense_state[t].node_buf
                    merged_count = dense_state[t].count
                    inverse_tail = locs
                    off = 0
                else:
                    merged = unique_first_occurrence(
                        torch.cat([node_buf[t], cands]))
                    uniques_src = merged.uniques
                    merged_count = merged.count
                    inverse_tail = merged.inverse
                    off = buflen
                for et in ets:
                    out, src_local, w, f = hop_out[et]
                    nbr_local = inverse_tail[off: off + w * f].reshape(w, f)
                    off += w * f
                    # Under a frontier_cap the list can fill before every
                    # candidate lands: mask edges to dropped nodes.
                    ok = out.mask & (nbr_local >= 0) & (nbr_local < buflen)
                    nbr_local = torch.where(ok, nbr_local, PADDING_ID)
                    rows[et].append(nbr_local.reshape(-1))
                    cols[et].append(src_local[:, None].expand(w, f)
                                    .reshape(-1))
                    eids[et].append(out.eids.reshape(-1))
                    emasks[et].append(ok.reshape(-1))

                old_count = count[t]
                nw = widths[hop + 1][t]
                if nw > 0 and not last:
                    # The nodes new at this hop, strictly inside the
                    # list (overflow and the dump slot never expand).
                    start = old_count.clamp(0, buflen).long()
                    at = start + torch.arange(nw, device=dev)
                    new_frontier[t] = _pad(uniques_src[:buflen], nw)[at]
                node_buf[t] = uniques_src[:buflen]
                count[t] = merged_count.clamp(max=buflen)
                frontier_start[t] = old_count

            for t in node_types:
                counts_hist[t].append(count[t])
                frontier[t] = new_frontier.get(t)

        rev = {et: reverse_edge_type(et) for et in self.edge_types}

        def cat(parts, dtype=torch.int32, fill=PADDING_ID):
            return _cat_or_empty(parts, dtype, fill, dev)

        return HeteroSamplerOutput(
            node={t: node_buf[t] for t in node_types},
            row={rev[et]: cat(rows[et]) for et in self.edge_types},
            col={rev[et]: cat(cols[et]) for et in self.edge_types},
            edge={rev[et]: cat(eids[et]) for et in self.edge_types},
            batch=dict(seeds_dict),
            node_mask={t: _node_mask(node_buf[t], count[t], fast_leaf.get(t))
                       for t in node_types},
            edge_mask={rev[et]: cat(emasks[et], torch.bool, False)
                       for et in self.edge_types},
            num_sampled_nodes={
                t: torch.stack(
                    [counts_hist[t][0]]
                    + [counts_hist[t][i + 1] - counts_hist[t][i]
                       for i in range(len(counts_hist[t]) - 1)])
                for t in node_types},
            input_type=self.input_type,
        )

    def _seed_tensor(self, ids) -> torch.Tensor:
        """``[batch_size]`` int32 ids on the graphs' device from host ids
        (padded here) or an already padded tensor."""
        if (isinstance(ids, torch.Tensor)
                and tuple(ids.shape) == (self.batch_size,)):
            return ids.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(_pad_ids(np.asarray(ids),
                                         self.batch_size)).to(self.device)

    def sample_from_nodes(self, inputs: NodeSamplerInput,
                          key: Optional[torch.Tensor] = None
                          ) -> HeteroSamplerOutput:
        """Sample around ``inputs.node`` (seeds of ``input_type``)."""
        seeds = self._seed_tensor(inputs.node)
        if key is None:
            key = self._next_key()
        return self._sample_impl(self._widths, self._capacity,
                                 self.graph_arrays(),
                                 {self.input_type: seeds}, key)

    # -- the link path -------------------------------------------------------
    def sample_from_edges(self, inputs: EdgeSamplerInput,
                          key: Optional[torch.Tensor] = None
                          ) -> HeteroSamplerOutput:
        """Seed edges of ``inputs.input_type`` with optional binary or
        triplet negatives, then the multi-hop sample of the endpoints.

        Binary negatives are strict: drawn against the seed edge type's
        CSR (its sorted view) with the padding fallback; an optional
        ``NegativeSampling.weight`` biases the draws over the
        destination type.  Metadata as in
        :meth:`~glt_tpu_torch.sampler.NeighborSampler.sample_from_edges`
        (``edge_label_index`` and ``edge_label``, or the triplet
        indices), without ``num_pos``.
        """
        et = inputs.input_type
        if et is None:
            raise ValueError("hetero EdgeSamplerInput needs input_type")
        neg = inputs.neg_sampling
        q = self.batch_size
        dev = self.device
        src = self._seed_tensor(inputs.row)
        dst = self._seed_tensor(inputs.col)
        if key is None:
            key = self._next_key()
        mode = None if neg is None else neg.mode
        amount = 0 if neg is None else int(round(neg.amount))
        cdf = None if neg is None else neg.cdf(dev)
        out = self._sample_edges(et, mode, amount, src, dst, cdf, key)
        if mode == "binary":
            pos_label = (torch.ones(q, dtype=torch.int32, device=dev)
                         if inputs.label is None
                         else self._seed_tensor(inputs.label) + 1)
            out.metadata["edge_label"] = torch.cat([
                torch.where(src >= 0, pos_label, PADDING_ID),
                torch.zeros(q * amount, dtype=torch.int32, device=dev)])
        elif mode is None and inputs.label is not None:
            out.metadata["edge_label"] = torch.where(
                src >= 0, self._seed_tensor(inputs.label), PADDING_ID)
        return out

    def _edge_plan(self, et, mode, amount):
        """Static widths and node counts of one (edge type, mode,
        amount), computed once."""
        k = (et, mode, amount)
        if k not in self._edge_plans:
            src_t, _, dst_t = et
            q = self.batch_size
            if mode == "binary":
                sw, dw = q * (1 + amount), q * (1 + amount)
            elif mode == "triplet":
                sw, dw = q, q * (1 + amount)
            else:
                sw, dw = q, q
            seed_widths = ({src_t: sw + dw} if src_t == dst_t
                           else {src_t: sw, dst_t: dw})
            widths, cap = hetero_hop_widths(
                self.edge_types, self.num_neighbors, seed_widths,
                self.num_hops, frontier_cap=self.frontier_cap)
            # An edge type's CSR rows are its source type's nodes.
            dst_rows = [e for e in self.edge_types if e[0] == dst_t]
            if not dst_rows:
                raise ValueError(
                    f"cannot size negatives: no edge type has source type "
                    f"{dst_t!r} (needed for its node count)")
            self._edge_plans[k] = (widths, cap, sw, dw,
                                   self.graphs[et].num_nodes,
                                   self.graphs[dst_rows[0]].num_nodes)
        return self._edge_plans[k]

    def _sample_edges(self, et, mode, amount, src, dst, cdf, key):
        src_t, _, dst_t = et
        q = self.batch_size
        widths, cap, sw, dw, n_src, n_dst = self._edge_plan(et, mode, amount)
        ks = trandom.split(key)
        kneg, ksample = ks[0], ks[1]
        if mode == "binary":
            g = self.graphs[et]
            negs = sample_negative_edges(
                g.indptr, g.sorted_indices, q * amount, kneg, n_src,
                num_dst_nodes=n_dst, dst_cdf=cdf, edge_keys=g.edge_keys)
            srcs = torch.cat([src, negs.src])
            dsts = torch.cat([dst, negs.dst])
        elif mode == "triplet":
            if cdf is not None:
                neg_dst = weighted_draw(kneg, cdf, (q * amount,))
            else:
                neg_dst = trandom.randint(kneg, (q * amount,), 0, n_dst)
            neg_dst = torch.where((src >= 0).repeat_interleave(amount),
                                  neg_dst, PADDING_ID)
            srcs, dsts = src, torch.cat([dst, neg_dst])
        else:
            srcs, dsts = src, dst
        if src_t == dst_t:
            seeds_dict = {src_t: torch.cat([srcs, dsts])}
        else:
            seeds_dict = {src_t: srcs, dst_t: dsts}
        out = self._sample_impl(widths, cap, self.graph_arrays(),
                                seeds_dict, ksample)
        # Seeds first occur within the hop-0 prefix of their type's list;
        # relabel against that slice only (a leaf block may hold copies).
        if src_t == dst_t:
            src_ref = dst_ref = out.node[src_t][: sw + dw]
        else:
            src_ref = out.node[src_t][:sw]
            dst_ref = out.node[dst_t][:dw]
        meta = {}
        if mode == "binary":
            meta["edge_label_index"] = torch.stack([
                relabel_by_reference(src_ref, srcs),
                relabel_by_reference(dst_ref, dsts)])
        elif mode == "triplet":
            meta["src_index"] = relabel_by_reference(src_ref, src)
            meta["dst_pos_index"] = relabel_by_reference(dst_ref, dst)
            meta["dst_neg_index"] = relabel_by_reference(
                dst_ref, neg_dst).reshape(q, amount)
        else:
            meta["edge_label_index"] = torch.stack([
                relabel_by_reference(src_ref, src),
                relabel_by_reference(dst_ref, dst)])
        out.metadata = meta
        return out
