"""Distributed heterogeneous neighbor sampling over a mesh of shards (cf.
``glt_tpu/parallel/dist_hetero_sampler.py``).

Every edge type's CSR is sharded by its **source type's** contiguous node
ranges (:func:`shard_hetero_graph`), and the hetero multi-hop body of
:class:`~glt_tpu_torch.sampler.HeteroNeighborSampler` runs once per
shard with its one-hop primitive swapped for the exchange of
:func:`~glt_tpu_torch.parallel.dist_sampler.exchange_one_hop`, per edge
type, over the same mesh.  ``glt_tpu`` runs that body per shard under
``shard_map``; here the body is a generator
(:meth:`~glt_tpu_torch.sampler.HeteroNeighborSampler._sample_steps`), one
per shard, driven in lockstep: every round each shard yields the same
``(edge type, fanout)`` request over its own frontier, and one exchange
over all shards answers the round.  On a mesh that spans processes
each process drives its own shards' generators, and each round's
exchange crosses processes (every process yields the same rounds in
the same order).  On the card each round is one launch
of kernel B1 per shard for the served requests (two with
``exchange_load_factor``, which samples the locally owned ids apart).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .. import random as trandom
from ..data.topology import CSRTopo
from ..ops.neighbor_sample import NeighborOutput
from ..sampler.base import HeteroSamplerOutput
from ..sampler.hetero_neighbor_sampler import (HeteroNeighborSampler,
                                               hetero_hop_widths)
from ..typing import EdgeType, NodeType
from ..utils.device import DeviceLike
from .dist_sampler import (_route_choice, _shards, autotune_routing,
                           bounded_remote_cap, exchange_one_hop,
                           seeds_on_mesh)
from .multihost import Mesh, mesh_axis_sizes, resolve_mesh_axes
from .sharding import ShardedGraph, check_on_mesh, shard_graph

__all__ = ["DistHeteroNeighborSampler", "shard_hetero_graph"]


def shard_hetero_graph(topos: Dict[EdgeType, CSRTopo], num_shards: int,
                       device: DeviceLike = None
                       ) -> Dict[EdgeType, ShardedGraph]:
    """Shard every edge type's CSR by its source type's node ranges, on
    ``device`` (default ``"cuda"``)."""
    return {et: shard_graph(t, num_shards, device=device)
            for et, t in topos.items()}


def _lockstep(steps: list, one_hop) -> list:
    """Run one ``_sample_steps`` generator a shard together: each round
    every shard yields ``(edge type, frontier, fanout, key)``, the same
    edge type and fanout on every shard, and ``one_hop(edge type,
    frontiers, fanout, keys)`` answers all of them at once.  Returns the
    generators' results."""
    results = [None] * len(steps)
    answers = [None] * len(steps)
    while True:
        reqs = []
        for i, gen in enumerate(steps):
            try:
                reqs.append(gen.send(answers[i]))
            except StopIteration as done:
                results[i] = done.value
        if not reqs:
            return results
        et, fanout = reqs[0][0], reqs[0][2]
        if len(reqs) != len(steps) or any(
                (r[0], r[2]) != (et, fanout) for r in reqs):
            raise RuntimeError("the shards' hop requests fell out of "
                               "lockstep")
        answers = one_hop(et, [r[1] for r in reqs], fanout,
                          [r[3] for r in reqs])


def _stack_hetero(outs: Sequence[HeteroSamplerOutput]) -> HeteroSamplerOutput:
    """Per-shard outputs as one whose tensors lead with the shard axis."""
    def stack(name):
        first = getattr(outs[0], name)
        if first is None:
            return None
        return {k: torch.stack([getattr(o, name)[k] for o in outs])
                for k in first}

    return HeteroSamplerOutput(
        node=stack("node"), row=stack("row"), col=stack("col"),
        edge=stack("edge"), batch=stack("batch"),
        node_mask=stack("node_mask"), edge_mask=stack("edge_mask"),
        num_sampled_nodes=stack("num_sampled_nodes"),
        num_sampled_edges=stack("num_sampled_edges"),
        input_type=outs[0].input_type, metadata=stack("metadata"))


class DistHeteroNeighborSampler:
    """Multi-hop distributed hetero sampler.

    Args:
      sharded: ``EdgeType -> ShardedGraph`` (from
        :func:`shard_hetero_graph`), every one over the mesh's shards.
      mesh / axis_name: the mesh to sample over (None: its own axes).
      num_neighbors / input_type / batch_size / frontier_cap /
        last_hop_dedup: as :class:`~glt_tpu_torch.sampler.HeteroNeighborSampler`.
      seed: base key; each call without a key folds in a call counter.
      exchange_load_factor: bounds each hop's per-owner buckets of one
        edge type at ``ceil(α * width / S)`` remote ids; the drops,
        summed over hops and edge types, come back per shard in
        ``metadata['exchange_dropped']``, on the device.
      route / fused / hier_load_factor: as
        :class:`~glt_tpu_torch.parallel.DistNeighborSampler` (on a 2-D
        mesh each edge type's hops take the hierarchical route where the
        topology resolves it).

    Shard ``s`` samples under ``fold_in(key, s)``; hop ``h`` of edge type
    ``i`` (sorted) uses ``split(that key, hops * types)[h * types + i]``.
    The dense inducer of a node type is sized by its global count
    (``nodes_per_shard * S`` of the first edge type it is the source
    of), one map a shard.
    """

    def __init__(self, sharded: Dict[EdgeType, ShardedGraph], mesh: Mesh,
                 num_neighbors, input_type: NodeType,
                 batch_size: int = 512, axis_name: Optional[str] = None,
                 frontier_cap: Optional[int] = None, seed: int = 0,
                 last_hop_dedup: bool = True,
                 exchange_load_factor: Optional[float] = None,
                 route: str = "auto", fused: Optional[bool] = None,
                 hier_load_factor: Optional[float] = None):
        num_shards = {g.num_shards for g in sharded.values()}
        if num_shards != {mesh.size}:
            raise ValueError(f"graphs of {sorted(num_shards)} shards on a "
                             f"mesh of {mesh.size}")
        for et, g in sharded.items():
            check_on_mesh(mesh, indptr=g.indptr, indices=g.indices,
                          edge_ids=g.edge_ids)
        self.sharded = sharded
        self.mesh = mesh
        self.device = mesh.device
        self.num_shards = mesh.size
        self.axis_name = resolve_mesh_axes(mesh, axis_name)
        self.mesh_shape = mesh_axis_sizes(mesh, self.axis_name)
        self.exchange_load_factor = exchange_load_factor
        self.hier_load_factor = hier_load_factor
        self.fused = fused
        self.input_type = input_type
        self.batch_size = int(batch_size)
        self.last_hop_dedup = bool(last_hop_dedup)
        # The single-device sampler's planning and multi-hop body; its
        # graphs are never read (the exchange answers every hop).
        p = self._planner = HeteroNeighborSampler.__new__(
            HeteroNeighborSampler)
        p.graphs = {et: None for et in sharded}
        p.edge_types = sorted(sharded)
        p.device = mesh.device
        if isinstance(num_neighbors, dict):
            p.num_neighbors = {et: list(v) for et, v in num_neighbors.items()}
        else:
            p.num_neighbors = {et: list(num_neighbors)
                               for et in p.edge_types}
        p.num_hops = max(len(v) for v in p.num_neighbors.values())
        p.input_type = input_type
        p.batch_size = self.batch_size
        p.last_hop_dedup = self.last_hop_dedup
        p.frontier_cap = frontier_cap
        # Global per-type counts (ids are global across shards), so the
        # dense inducer engages where the map fits.
        p._num_nodes_by_type = {}
        for et, g in sharded.items():
            p._num_nodes_by_type.setdefault(
                et[0], g.nodes_per_shard * g.num_shards)
        self._widths, self._capacity = hetero_hop_widths(
            p.edge_types, p.num_neighbors, {input_type: self.batch_size},
            p.num_hops, frontier_cap=frontier_cap)
        p._widths, p._capacity = self._widths, self._capacity
        # 'auto' resolves once, through the autotuner at the widest
        # per-type frontier (timed on the card, the heuristic on the CPU).
        widest = max(max(w.values()) for w in self._widths)
        if route == "auto":
            self.route = autotune_routing(widest, self.num_shards,
                                          mesh_shape=self.mesh_shape,
                                          mesh=mesh)
        else:
            _route_choice(widest, self.num_shards, widest, route)
            self.route = route
        self._base_key = trandom.PRNGKey(seed, device=mesh.device)
        self._call_count = 0

    @property
    def edge_types(self) -> List[EdgeType]:
        return list(self._planner.edge_types)

    @property
    def num_neighbors(self) -> Dict[EdgeType, List[int]]:
        return {et: list(v) for et, v in self._planner.num_neighbors.items()}

    @property
    def node_capacity(self) -> Dict[NodeType, int]:
        """Static per-node-type unique-node capacity of one shard's
        sample."""
        return dict(self._capacity)

    @property
    def hop_widths(self) -> List[Dict[NodeType, int]]:
        """Per-hop per-node-type frontier widths (static shapes)."""
        return [dict(w) for w in self._widths]

    def _next_key(self) -> torch.Tensor:
        key = trandom.fold_in(self._base_key, self._call_count)
        self._call_count += 1
        return key

    def _one_hop(self, et, frontiers, fanout, keys, dropped):
        g = self.sharded[et]
        remote_cap = (None if self.exchange_load_factor is None
                      else bounded_remote_cap(frontiers[0].shape[0],
                                              self.exchange_load_factor,
                                              g.num_shards))
        outs = exchange_one_hop(
            frontiers, g.indptr, g.indices, g.edge_ids, g.nodes_per_shard,
            g.num_shards, fanout, keys, remote_cap=remote_cap,
            route=self.route, fused=self.fused, mesh_shape=self.mesh_shape,
            hier_load_factor=self.hier_load_factor, axis_name=self.axis_name)
        if self.exchange_load_factor is not None:
            for j, o in enumerate(outs):
                dropped[j].append(o[3])
        return [NeighborOutput(nbrs=n, eids=e, mask=m) for n, e, m, _ in outs]

    def local_sample(self, seeds: Sequence[torch.Tensor],
                     keys: Sequence[torch.Tensor]
                     ) -> List[HeteroSamplerOutput]:
        """Every shard's multi-hop hetero sample, in lockstep: ``seeds``
        per shard the ``[batch_size]`` global ids of ``input_type`` (-1
        padded), ``keys`` per shard its key (already folded with the
        shard index).  The seam of the fused train steps
        (:func:`~glt_tpu_torch.parallel.dist_train.make_hetero_dist_train_step`).
        With ``exchange_load_factor`` each output's metadata holds
        ``exchange_dropped``, summed over hops and edge types."""
        S = self.num_shards
        seeds, keys = _shards(seeds, S), _shards(keys, S)
        p = self._planner
        dropped = [[] for _ in seeds]
        steps = [p._sample_steps(self._widths, self._capacity,
                                 {self.input_type: x.to(torch.int32)}, k)
                 for x, k in zip(seeds, keys)]
        outs = _lockstep(steps, lambda et, fr, fo, ks: self._one_hop(
            et, fr, fo, ks, dropped))
        for out, d in zip(outs, dropped):
            if d:
                out.metadata = {"exchange_dropped": torch.stack(d).sum(
                    0, dtype=torch.int32), **(out.metadata or {})}
        return outs

    def sample_from_nodes(self, seeds_per_shard,
                          key: Optional[torch.Tensor] = None
                          ) -> HeteroSamplerOutput:
        """``seeds_per_shard``: ``[S, batch_size]`` global ids of the
        input type, -1 padded (a host array or a tensor).  Returns one
        :class:`~glt_tpu_torch.sampler.base.HeteroSamplerOutput` whose
        tensors lead with the shard axis."""
        if key is None:
            key = self._next_key()
        seeds = seeds_on_mesh(seeds_per_shard, self.mesh)
        return _stack_hetero(self.local_sample(
            list(seeds), [trandom.fold_in(key, s) for s in self.mesh.local]))
