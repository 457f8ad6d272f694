"""Multi-hop neighbor sampler with static shapes (cf.
``glt_tpu/sampler/neighbor_sampler.py``).

Per hop: the threefry draw and the neighbor read
(:func:`~glt_tpu_torch.ops.neighbor_sample.sample_neighbors`, kernel B1 on
the card), then the inducer folds the hop's neighbors into the
cumulative first-occurrence node list, whose newly discovered slice is
the next hop's frontier.  Every shape is fixed by ``(batch_size,
fanouts)``; the counts that vary travel as device tensors, so a whole
sample runs without waiting for the host.

Edge direction is transposed on output to PyG's dst<-src convention:
``row`` = neighbor, ``col`` = seed side.

Both dedup modes ('dense' scatter map, 'sort' unique), both final-hop
modes (``last_hop_dedup``) and the occupancy-capped node buffer
(``node_capacity``, with its ``metadata["overflow"]`` flag and
:func:`calibrate_node_capacity`) are ported, and so are the link path
(:meth:`NeighborSampler.sample_from_edges`, with binary or triplet
negatives, uniform or weighted), the induced subgraph
(:meth:`NeighborSampler.subgraph`), the one-hop primitive and the
batched node entry point (:meth:`NeighborSampler.sample_from_nodes_batched`:
``G`` batches in one CUDA graph on the card, a loop on the CPU) and
the hotness estimate of the frequency partitioner
(:meth:`NeighborSampler.sample_prob`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..data.graph import Graph
from ..obs import compilewatch
from ..ops.negative_sample import sample_negative_edges, weighted_draw
from ..ops.neighbor_sample import sample_neighbors
from ..ops.subgraph import node_subgraph
from ..ops.unique import (
    dense_induce,
    dense_induce_final,
    dense_induce_init,
    dense_map_fits,
    relabel_by_reference,
    unique_first_occurrence,
)
from ..typing import PADDING_ID
from ..utils.graphs import CapturedProgram
from .base import (
    EdgeSamplerInput,
    NegativeSampling,
    NodeSamplerInput,
    SamplerOutput,
)


def _pad_ids(ids, size: int) -> np.ndarray:
    """Right-pad a host id array with PADDING_ID to a static length."""
    ids = np.asarray(ids).astype(np.int32).ravel()
    if ids.shape[0] > size:
        raise ValueError(f"batch of {ids.shape[0]} exceeds static size {size}")
    out = np.full((size,), PADDING_ID, np.int32)
    out[: ids.shape[0]] = ids
    return out


def hop_widths(batch_size: int, fanouts: Sequence[int],
               frontier_cap: Optional[int] = None) -> List[int]:
    """Static frontier width per hop: B, B*f0, B*f0*f1, ... (capped)."""
    widths = [batch_size]
    for f in fanouts[:-1]:
        w = widths[-1] * f
        if frontier_cap is not None:
            w = min(w, frontier_cap)
        widths.append(w)
    return widths


def max_sampled_nodes(batch_size: int, fanouts: Sequence[int],
                      frontier_cap: Optional[int] = None) -> int:
    """Padded node capacity: the zero-dedup worst case."""
    widths = hop_widths(batch_size, fanouts, frontier_cap)
    return widths[0] + sum(w * f for w, f in zip(widths, fanouts))


def measure_occupancy(sampler: "NeighborSampler", seed_batches) -> np.ndarray:
    """Unique-node counts per seed batch, fetched to the host in ONE copy.

    In leaf-block mode (``last_hop_dedup=False``) the final hop's width
    is static, so only interior hops are counted.
    """
    counts = []
    for seeds in seed_batches:
        out = sampler.sample_from_nodes(NodeSamplerInput(seeds))
        n = out.num_sampled_nodes
        if not sampler.last_hop_dedup:
            n = n[:-1]
        counts.append(n.sum(dtype=torch.int32))
    if not counts:
        return np.zeros((0,), np.int32)
    return torch.stack(counts).cpu().numpy()


def calibrate_node_capacity(sampler: "NeighborSampler", seed_batches=None,
                            pct: float = 99.0, margin: float = 1.05,
                            multiple: int = 256,
                            counts: Optional[np.ndarray] = None) -> int:
    """Occupancy-sized static node capacity: the ``pct`` percentile of
    the interior-unique counts of ``seed_batches`` (sampled through
    ``sampler``, typically uncapped) times ``margin``, rounded up to
    ``multiple`` rows, plus the static leaf block in leaf mode; never
    below the frontier floor nor above the full capacity.  Feed it to
    ``NeighborSampler(node_capacity=...)``."""
    if counts is None:
        counts = measure_occupancy(sampler, seed_batches)
    interior = float(np.percentile(counts, pct)) * margin
    cap = int(np.ceil(interior / multiple) * multiple) + sampler._leaf_width
    return min(max(cap, sampler._floor_capacity),
               sampler.full_node_capacity)


def _clone(v):
    """A copy of a tensor, or of each tensor in a dict, out of a
    graph's static buffers."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _clone(t) for k, t in v.items()}
    return v


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, torch.full((n,), PADDING_ID, dtype=torch.int32,
                                    device=x.device)])


class NeighborSampler:
    """Fixed-fanout multi-hop sampler over a
    :class:`~glt_tpu_torch.data.graph.Graph`.

    Args:
      graph: CSR graph; sampling runs on its device.
      num_neighbors: per-hop fanouts, e.g. ``[15, 10, 5]``.
      batch_size: static seed-batch width (callers pad).
      frontier_cap: optional cap on per-hop frontier width.
      with_edge: emit global edge ids.
      seed: base key seed; each ``sample_from_nodes`` call folds in a
        call counter, so batches are independent yet reproducible.
      dedup: 'dense' (scatter-map inducer), 'sort' (unique by sorting, no
        O(N) state) or 'auto' (dense unless the map would exceed ~1 GB).
      last_hop_dedup: when False, final-hop neighbors skip the inducer
        and land in a leaf block of the node list (duplicates allowed).
      node_capacity: optional occupancy-sized node buffer (see
        :func:`calibrate_node_capacity`).  Nodes discovered past it
        overflow: their edges are masked and the batch is flagged in
        ``metadata["overflow"]``.  Default: the zero-dedup worst case.
    """

    def __init__(self, graph: Graph, num_neighbors: Sequence[int],
                 batch_size: int = 512, frontier_cap: Optional[int] = None,
                 with_edge: bool = True, seed: int = 0, dedup: str = "auto",
                 last_hop_dedup: bool = True,
                 node_capacity: Optional[int] = None):
        self.graph = graph
        self.device = graph.device
        self.num_neighbors = list(num_neighbors)
        self.batch_size = int(batch_size)
        self.frontier_cap = frontier_cap
        self.with_edge = with_edge
        self.last_hop_dedup = bool(last_hop_dedup)
        self._base_key = trandom.PRNGKey(seed, device=self.device)
        self._call_count = 0
        if dedup not in ("auto", "dense", "sort"):
            raise ValueError(f"dedup must be auto|dense|sort, got {dedup!r}")
        if dedup == "auto":
            dedup = "dense" if dense_map_fits(graph.num_nodes) else "sort"
        self.dedup = dedup
        self._widths = hop_widths(self.batch_size, self.num_neighbors,
                                  frontier_cap)
        self.full_node_capacity = max_sampled_nodes(
            self.batch_size, self.num_neighbors, frontier_cap)
        # The static leaf block (last_hop_dedup=False) and the least
        # capacity that holds every hop's frontier plus that block.
        self._leaf_width = (0 if self.last_hop_dedup
                            else self._widths[-1] * self.num_neighbors[-1])
        self._floor_capacity = sum(self._widths) + self._leaf_width
        if node_capacity is None:
            self.node_capacity = self.full_node_capacity
        else:
            nc = int(node_capacity)
            if nc < self._floor_capacity:
                raise ValueError(
                    f"node_capacity {nc} below the frontier floor "
                    f"{self._floor_capacity} (sum of hop widths + leaf "
                    f"block)")
            self.node_capacity = min(nc, self.full_node_capacity)
        self.capped = self.node_capacity < self.full_node_capacity
        self.edge_capacity = sum(
            w * f for w, f in zip(self._widths, self.num_neighbors))
        self._full_sibling: Optional["NeighborSampler"] = None
        self._union_siblings = {}
        self._batched_programs = {}     # G -> CapturedProgram (CUDA)

    def full_capacity_sibling(self) -> "NeighborSampler":
        """Uncapped twin (same graph, fanouts and modes, its own key
        counter from seed 0, as in ``glt_tpu``) for exact re-sampling of
        overflow-flagged batches."""
        if not self.capped:
            return self
        if self._full_sibling is None:
            self._full_sibling = NeighborSampler(
                self.graph, self.num_neighbors, self.batch_size,
                frontier_cap=self.frontier_cap, with_edge=self.with_edge,
                dedup=self.dedup, last_hop_dedup=self.last_hop_dedup)
        return self._full_sibling

    def _union_sibling(self, width: int) -> "NeighborSampler":
        """Uncapped twin at batch width ``width``: the link path samples
        its seed union (positives and negatives) at that width and its
        full capacity; an occupancy cap of the node path does not carry
        over to another width."""
        if width not in self._union_siblings:
            self._union_siblings[width] = NeighborSampler(
                self.graph, self.num_neighbors, width,
                frontier_cap=self.frontier_cap, with_edge=self.with_edge,
                dedup=self.dedup, last_hop_dedup=self.last_hop_dedup)
        return self._union_siblings[width]

    # -- key management ----------------------------------------------------
    def _next_key(self) -> torch.Tensor:
        key = trandom.fold_in(self._base_key, self._call_count)
        self._call_count += 1
        return key

    # -- the multi-hop sample ------------------------------------------------
    def _sample_impl(self, indptr, indices, edge_ids, seeds, key
                     ) -> SamplerOutput:
        """One multi-hop sample.  ``seeds``: ``[batch_size]`` int32, -1
        padded, on the graph's device."""
        fanouts = self.num_neighbors
        widths = self._widths
        cap = self.node_capacity
        dense = self.dedup == "dense"
        dev = seeds.device

        if dense:
            state = dense_induce_init(self.graph.num_nodes, cap, device=dev)
            state, _ = dense_induce(state, seeds)
            node_buf, count = state.node_buf, state.count
            frontier = node_buf[: widths[0]]
        else:
            u0 = unique_first_occurrence(seeds)
            node_buf, count = u0.uniques, u0.count
            frontier = u0.uniques
        frontier_start = torch.zeros((), dtype=torch.int32, device=dev)

        rows, cols, eids, emasks = [], [], [], []
        counts_per_hop = [count]
        edges_per_hop = []
        keys = trandom.split(key, len(fanouts))
        leaf_off = cap - widths[-1] * fanouts[-1]
        leaf_mask = None
        capped = self.capped
        # Under an occupancy cap, nodes given locals past `interior_cap`
        # are overflow: their edges are masked and the batch flagged.
        interior_cap = cap if self.last_hop_dedup else leaf_off

        for i, f in enumerate(fanouts):
            w = widths[i]
            last = i + 1 == len(fanouts)
            out = sample_neighbors(indptr, indices, frontier, f, keys[i],
                                   edge_ids=edge_ids,
                                   with_edge=self.with_edge)
            src_local = frontier_start + torch.arange(
                w, dtype=torch.int32, device=dev)
            src_local = torch.where(frontier >= 0, src_local, PADDING_ID)
            emask = out.mask
            if capped:
                # Frontier slots past the cap hold garbage on overflow
                # batches; mask every edge they source.
                src_local = torch.where(src_local < interior_cap, src_local,
                                        PADDING_ID)
                emask = emask & (src_local >= 0)[:, None]

            cand = out.nbrs.reshape(-1)                       # [w*f]
            if last and not self.last_hop_dedup:
                # Leaf block: no inducer at the widest frontier; local
                # ids are static offsets.
                leaf_mask = emask.reshape(-1)
                leaf_ids = torch.where(leaf_mask, cand, PADDING_ID)
                nbr_local = (leaf_off + torch.arange(
                    w * f, dtype=torch.int32, device=dev)).reshape(w, f)
                if dense:
                    node_buf[leaf_off: leaf_off + w * f] = leaf_ids
                elif capped:
                    # The sort path's interior buffer is full width;
                    # cut it at leaf_off so the leaf block lands where
                    # nbr_local points.
                    node_buf = torch.cat([node_buf[:leaf_off], leaf_ids])
                else:
                    node_buf = torch.cat([node_buf, leaf_ids])
                new_count = count + leaf_mask.sum(dtype=torch.int32)
            elif dense:
                induce = dense_induce_final if last else dense_induce
                state, nbr_local = induce(state, cand)
                node_buf, new_count = state.node_buf, state.count
                nbr_local = nbr_local.reshape(w, f)
            else:
                buflen = node_buf.shape[0]
                merged = unique_first_occurrence(torch.cat([node_buf, cand]))
                node_buf, new_count = merged.uniques, merged.count
                nbr_local = merged.inverse[buflen:].reshape(w, f)
            nbr_local = torch.where(emask, nbr_local, PADDING_ID)
            if capped and not (last and not self.last_hop_dedup):
                # Induced locals past the cap point at dropped nodes (the
                # dense inducer's dump slot, the sort path's cut).
                nbr_local = torch.where(nbr_local < interior_cap, nbr_local,
                                        PADDING_ID)
                emask = emask & (nbr_local >= 0)

            rows.append(nbr_local.reshape(-1))
            cols.append(src_local[:, None].expand(w, f).reshape(-1))
            if self.with_edge:
                eids.append(out.eids.reshape(-1))
            emasks.append(emask.reshape(-1))
            edges_per_hop.append(emask.sum(dtype=torch.int32))

            if not last:
                # The next frontier: the `nw` slots from `count` on (the
                # nodes new at this hop), read past the end as padding.
                nw = widths[i + 1]
                start = count.clamp(0, node_buf.shape[0]).long()
                at = start + torch.arange(nw, device=dev)
                frontier = _pad(node_buf, nw)[at]
                frontier_start = count
            count = new_count
            counts_per_hop.append(count)

        if node_buf.shape[0] < cap:
            node_buf = _pad(node_buf, cap - node_buf.shape[0])
        node_buf = node_buf[:cap]
        count = count.clamp(max=cap)
        slots = torch.arange(cap, dtype=torch.int32, device=dev)
        if leaf_mask is None:
            node_mask = slots < count
        else:
            # Interior prefix is compact; the leaf block keeps its own
            # validity mask.
            interior = (count - edges_per_hop[-1]).clamp(max=leaf_off)
            node_mask = (slots < interior) | torch.cat([
                torch.zeros(leaf_off, dtype=torch.bool, device=dev),
                leaf_mask])

        num_sampled_nodes = torch.stack(
            [counts_per_hop[0]]
            + [counts_per_hop[i + 1] - counts_per_hop[i]
               for i in range(len(fanouts))])
        metadata = None
        if capped:
            # The unclamped counts keep counting past the cap (the dense
            # inducer's dump slot absorbs the writes), so overflow is
            # exactly "more uniques than the buffer holds".
            if self.last_hop_dedup:
                overflow = counts_per_hop[-1] > cap
            else:
                overflow = counts_per_hop[len(fanouts) - 1] > leaf_off
            metadata = {"overflow": overflow}
        return SamplerOutput(
            node=node_buf,
            row=torch.cat(rows),
            col=torch.cat(cols),
            edge=torch.cat(eids) if self.with_edge else None,
            batch=seeds,
            node_mask=node_mask,
            edge_mask=torch.cat(emasks),
            num_sampled_nodes=num_sampled_nodes,
            num_sampled_edges=torch.stack(edges_per_hop),
            metadata=metadata,
        )

    # -- public API ----------------------------------------------------------
    def _seed_tensor(self, ids) -> torch.Tensor:
        if (isinstance(ids, torch.Tensor)
                and tuple(ids.shape) == (self.batch_size,)):
            return ids.to(device=self.device, dtype=torch.int32)
        return torch.from_numpy(
            _pad_ids(np.asarray(ids), self.batch_size)).to(self.device)

    def sample_from_nodes(self, inputs: NodeSamplerInput,
                          key: Optional[torch.Tensor] = None
                          ) -> SamplerOutput:
        """Sample around ``inputs.node`` (host ids, padded here, or a
        ``[batch_size]`` int32 tensor already padded)."""
        seeds = self._seed_tensor(inputs.node)
        if key is None:
            key = self._next_key()
        g = self.graph
        return self._sample_impl(g.indptr, g.indices, g.gather_edge_ids,
                                 seeds, key)

    def _sample_many(self, seeds: torch.Tensor, key: torch.Tensor
                     ) -> SamplerOutput:
        """``G`` samples of ``seeds [G, batch_size]``, batch ``g`` under
        ``split(key, G)[g]``, stacked on a leading axis."""
        g = self.graph
        keys = trandom.split(key, seeds.shape[0])
        outs = [self._sample_impl(g.indptr, g.indices, g.gather_edge_ids,
                                  seeds[i], keys[i])
                for i in range(seeds.shape[0])]

        def stacked(name):
            return torch.stack([getattr(o, name) for o in outs])

        return SamplerOutput(
            node=stacked("node"), row=stacked("row"), col=stacked("col"),
            edge=stacked("edge") if self.with_edge else None,
            batch=stacked("batch"), node_mask=stacked("node_mask"),
            edge_mask=stacked("edge_mask"),
            num_sampled_nodes=stacked("num_sampled_nodes"),
            num_sampled_edges=stacked("num_sampled_edges"),
            metadata=({"overflow": torch.stack(
                [o.metadata["overflow"] for o in outs])}
                if self.capped else None))

    def sample_from_nodes_batched(self, seeds,
                                  key: Optional[torch.Tensor] = None
                                  ) -> SamplerOutput:
        """Sample ``G`` seed batches in one device program (cf.
        ``glt_tpu``'s ``sample_from_nodes_batched``).

        ``seeds``: ``[G, batch_size]`` ids, -1 padded (a host array or a
        tensor).  Batch ``g`` samples with ``split(key, G)[g]``, so it
        equals ``sample_from_nodes`` of ``seeds[g]`` under that key; the
        result is a :class:`SamplerOutput` stacked on a leading axis
        ``G``.  ``key=None`` takes the next key of the call counter, as
        one ``sample_from_nodes`` call does.

        On the card the ``G`` samples are one CUDA graph per ``G``,
        captured at the first call (after one eager warm-up under the
        same explicit key, which leaves the counter alone) and replayed
        over static seed and key buffers; the outputs are copied out of
        the graph's buffers.  On the CPU the batches run in a loop.
        """
        if isinstance(seeds, torch.Tensor):
            blk = seeds.to(device=self.device, dtype=torch.int32)
        else:
            blk = np.ascontiguousarray(np.asarray(seeds), dtype=np.int32)
        if blk.ndim != 2 or blk.shape[1] != self.batch_size:
            raise ValueError(f"expected [G, {self.batch_size}] seeds, got "
                             f"{tuple(blk.shape)}")
        if key is None:
            key = self._next_key()
        if self.device.type != "cuda":
            return self._sample_many(torch.as_tensor(blk), key)
        g = int(blk.shape[0])
        prog = self._batched_programs.get(g)
        if prog is None:
            buf = torch.empty(tuple(blk.shape), dtype=torch.int32,
                              device=self.device)
            buf.copy_(torch.as_tensor(blk))
            with compilewatch.label(f"sample_from_nodes_batched_{g}"):
                prog = CapturedProgram(self._sample_many, [buf, key.clone()])
            self._batched_programs[g] = prog
            out = prog.replay()
        else:
            out = prog(blk, key)
        return SamplerOutput(**{
            f.name: _clone(getattr(out, f.name))
            for f in dataclasses.fields(SamplerOutput)})

    def sample_one_hop(self, srcs, fanout: int,
                       key: Optional[torch.Tensor] = None):
        """One hop around ``srcs`` (a tensor or host array of ids, -1
        padded): the primitive of the distributed sampler."""
        if key is None:
            key = self._next_key()
        g = self.graph
        if not isinstance(srcs, torch.Tensor):
            srcs = torch.from_numpy(np.asarray(srcs, np.int32))
        srcs = srcs.to(self.device)
        return sample_neighbors(g.indptr, g.indices, srcs, fanout, key,
                                edge_ids=g.gather_edge_ids,
                                with_edge=self.with_edge)

    # -- link path -----------------------------------------------------------
    def sample_from_edges(self, inputs: EdgeSamplerInput,
                          key: Optional[torch.Tensor] = None
                          ) -> SamplerOutput:
        """Sample around seed edges ``(inputs.row, inputs.col)`` (host
        ids, at most ``batch_size`` of them) and, per
        ``inputs.neg_sampling``, their negatives: the batch of
        :meth:`sample_from_edge_tensors`, with ``metadata["num_pos"]``
        the number of seed edges.  ``inputs.input_type`` is ignored, as
        in ``glt_tpu`` (hetero seed edges go to
        :class:`~glt_tpu_torch.sampler.HeteroNeighborSampler`).
        """
        q = self.batch_size
        dev = self.device
        src = torch.from_numpy(_pad_ids(inputs.row, q)).to(dev)
        dst = torch.from_numpy(_pad_ids(inputs.col, q)).to(dev)
        label = (None if inputs.label is None
                 else torch.from_numpy(_pad_ids(inputs.label, q)).to(dev))
        if key is None:
            key = self._next_key()
        out = self.sample_from_edge_tensors(src, dst, inputs.neg_sampling,
                                            key, label)
        out.metadata["num_pos"] = torch.tensor(len(inputs), dtype=torch.int32,
                                               device=dev)
        return out

    def sample_from_edge_tensors(self, src: torch.Tensor, dst: torch.Tensor,
                                 neg_sampling: Optional[NegativeSampling],
                                 key: torch.Tensor,
                                 label: Optional[torch.Tensor] = None
                                 ) -> SamplerOutput:
        """Negatives, then the multi-hop sample of the seed union.

        ``src``/``dst``/``label`` are ``[batch_size]`` int32 on the
        graph's device, -1 padded.  The seeds are the union of the
        positive endpoints and the negatives, sampled at that union's
        own width.  Metadata: binary mode ``edge_label_index`` ``[2,
        q(1 + amount)]`` (local ids of positives then negatives) and
        ``edge_label`` (``label + 1``, or 1 without labels, on
        positives; 0 on negatives; -1 on padded positives); triplet mode
        ``src_index``, ``dst_pos_index`` ``[q]`` and ``dst_neg_index``
        ``[q, amount]``; no negatives: ``edge_label_index`` and, with
        labels, ``edge_label`` as given.  The key splits into the
        negatives' and the sample's, in that order.
        """
        neg = neg_sampling
        mode = None if neg is None else neg.mode
        amount = 0 if neg is None else int(round(neg.amount))
        q = self.batch_size
        dev = self.device
        g = self.graph
        cdf = None if neg is None else neg.cdf(dev)
        keys = trandom.split(key)
        kneg, ksample = keys[0], keys[1]
        num_nodes = g.num_nodes
        if mode == "binary":
            negs = sample_negative_edges(
                g.indptr, g.sorted_indices, q * amount, kneg, num_nodes,
                src_cdf=cdf, dst_cdf=cdf, edge_keys=g.edge_keys)
            seed_ids = torch.cat([src, dst, negs.src, negs.dst])
        elif mode == "triplet":
            if cdf is not None:
                neg_dst = weighted_draw(kneg, cdf, (q * amount,))
            else:
                neg_dst = trandom.randint(kneg, (q * amount,), 0, num_nodes)
            # Each positive's validity over its `amount` slots: a view
            # and a copy, no host sync (a CUDA graph captures it).
            pos_ok = (src >= 0)[:, None].expand(q, amount).reshape(-1)
            neg_dst = torch.where(pos_ok, neg_dst, PADDING_ID)
            seed_ids = torch.cat([src, dst, neg_dst])
        else:
            seed_ids = torch.cat([src, dst])

        width = seed_ids.shape[0]
        out = self._union_sibling(width)._sample_impl(
            g.indptr, g.indices, g.gather_edge_ids, seed_ids, ksample)
        meta = dict(out.metadata or {})
        # Every seed first occurs in the hop-0 prefix of the node list;
        # relabel against that slice only (a leaf copy of a seed, with
        # last_hop_dedup=False, has no deep embedding).
        ref = out.node[:width]
        if mode == "binary":
            meta["edge_label_index"] = torch.stack([
                relabel_by_reference(ref, torch.cat([src, negs.src])),
                relabel_by_reference(ref, torch.cat([dst, negs.dst]))])
            pos_label = (torch.ones(q, dtype=torch.int32, device=dev)
                         if label is None else label + 1)
            meta["edge_label"] = torch.cat([
                torch.where(src >= 0, pos_label, PADDING_ID),
                torch.zeros(q * amount, dtype=torch.int32, device=dev)])
        elif mode == "triplet":
            meta["src_index"] = relabel_by_reference(ref, src)
            meta["dst_pos_index"] = relabel_by_reference(ref, dst)
            meta["dst_neg_index"] = relabel_by_reference(
                ref, neg_dst).reshape(q, amount)
        else:
            meta["edge_label_index"] = torch.stack([
                relabel_by_reference(ref, src),
                relabel_by_reference(ref, dst)])
            if label is not None:
                # The caller's labels pass through, with no +1.
                meta["edge_label"] = torch.where(src >= 0, label, PADDING_ID)
        out.metadata = meta
        return out

    # -- hotness estimation ----------------------------------------------------
    def sample_prob(self, seed_ids, node_count: int) -> torch.Tensor:
        """Per-node probability of being touched by sampling from
        ``seed_ids`` (``[num_nodes]`` f32 on the sampler's device, zero
        padded to ``node_count``).

        One whole-graph sparse propagation per hop: an edge ``u -> v``
        adds ``p_u * min(fanout / deg_u, 1)`` to ``p_v``; the hops'
        results are union-bounded into a cumulative visit probability.
        The frequency partitioner's hotness scores.  The edge weight is a
        tensor divided by a tensor, one correctly rounded division as in
        ``glt_tpu`` (a Python number over a tensor would round a
        reciprocal and then a product).  On the CPU the result equals
        ``glt_tpu``'s bit for bit; on the card ``index_add_`` adds by
        atomics, so the sums agree with ``segment_sum``'s to f32
        round-off.
        """
        g = self.graph
        indptr, indices = g.indptr, g.indices
        dev = indptr.device
        num_nodes = int(indptr.shape[0]) - 1
        edge_src = torch.searchsorted(
            indptr, torch.arange(indices.shape[0], dtype=indptr.dtype,
                                 device=dev), right=True) - 1
        deg = (indptr[1:] - indptr[:-1]).to(torch.float32)

        prob = torch.zeros(num_nodes, dtype=torch.float32, device=dev)
        seeds = torch.as_tensor(np.asarray(seed_ids, np.int64)).to(dev)
        prob[seeds] = 1.0
        total = prob
        for f in self.num_neighbors:
            w = torch.clamp(torch.full_like(deg, float(f))
                            / deg.clamp(min=1.0), max=1.0)
            contrib = prob[edge_src] * w[edge_src]
            nxt = torch.zeros(num_nodes, dtype=torch.float32,
                              device=dev).index_add_(0, indices.long(),
                                                     contrib)
            prob = nxt.clamp(max=1.0)
            total = (total + prob).clamp(max=1.0)
        if node_count > num_nodes:
            total = torch.cat([total, torch.zeros(
                node_count - num_nodes, dtype=torch.float32, device=dev)])
        return total

    # -- induced subgraph ----------------------------------------------------
    def subgraph(self, inputs: NodeSamplerInput, max_degree: int = 64,
                 key: Optional[torch.Tensor] = None) -> SamplerOutput:
        """Hop expansion from ``inputs.node``, then the subgraph induced
        by the sampled node set.

        Unlike :meth:`sample_from_nodes`, the edges keep graph direction
        (``row`` = CSR source, ``col`` = destination) with their real
        edge ids, scanning at most ``max_degree`` entries of each node's
        row.  ``metadata["mapping"]`` is ``arange(batch_size)``.
        """
        if not self.last_hop_dedup:
            raise ValueError(
                "subgraph() requires last_hop_dedup=True: the induced "
                "extract relabels against a unique node set")
        seeds = self._seed_tensor(inputs.node)
        if key is None:
            key = self._next_key()
        g = self.graph
        base = self._sample_impl(g.indptr, g.indices, g.gather_edge_ids,
                                 seeds, key)
        sub = node_subgraph(g.indptr, g.indices, base.node, int(max_degree),
                            edge_ids=g.edge_ids)
        return SamplerOutput(
            node=base.node, row=sub.rows, col=sub.cols, edge=sub.eids,
            batch=base.batch, node_mask=base.node_mask, edge_mask=sub.mask,
            num_sampled_nodes=base.num_sampled_nodes,
            metadata={"mapping": torch.arange(self.batch_size,
                                              dtype=torch.int32,
                                              device=self.device),
                      **(base.metadata or {})})
