"""The distributed training step: sample, gather and update over a mesh
of shards (cf. ``glt_tpu/parallel/dist_train.py``).

Per step every shard samples its own seed batch through the all-to-all
exchange (:func:`~glt_tpu_torch.parallel.dist_sampler.dist_sample_multi_hop`),
gathers its features and labels in one more exchange
(:func:`~glt_tpu_torch.parallel.dist_feature.exchange_gather_xy`) and
runs the model.  All shards share one set of parameters: the step takes
the backward of the mean of the per-shard losses, which is ``glt_tpu``'s
mean of the per-shard gradients (its ``pmean``) summed in another order,
then one optimizer step.

A fully padded batch leaves the parameters and the optimizer's state as
they were, decided on the device: the update runs and a ``where`` on
the batch's validity keeps or drops it, so no host branch reads a
device value.  The host step counter advances from the host seed array.

The scanned step (:func:`make_scanned_dist_train_step`) trains ``G``
such batches a call over a host ``[G, S, B]`` block
(:func:`dist_seed_blocks`, :func:`run_scanned_dist_epoch`); it skips a
slot with no real seed on the host, and on the card the block is one
CUDA graph per real-slot pattern, the counterpart of ``glt_tpu``'s one
``shard_map`` program over a ``lax.scan``.

The tiered path trains a graph whose features outgrow the card
(:func:`make_tiered_train_step`, :class:`TieredTrainPipeline`): each
shard keeps its hottest rows on the device and the rest in host memory
(:class:`~glt_tpu_torch.parallel.dist_feature.TieredShardedFeature`).
A batch runs in two stages, sample + cold routing, then train, and a
staging thread gathers batch ``k``'s cold rows on the host and copies
them to the card while batch ``k - 1`` trains.  On the card each stage
is one CUDA graph a step.

Heterogeneous graphs train the same way (:func:`make_hetero_dist_train_step`,
one CUDA graph a step on the card; :func:`make_hetero_tiered_train_step`
and :class:`HeteroTieredTrainPipeline` with some node types tiered).  On
a 2-D ``(host, chip)`` mesh every step takes the route its ``route``
resolves to, flat or hierarchical, with the same batches either way;
``step.collective_bytes`` splits the static bytes by fabric.
"""
from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..models.train import (OptimizerFactory, TrainState, _backward_and_step,
                            _check_model, _ScannedBlocks, create_train_state,
                            hetero_init_shapes, seed_cross_entropy)
from ..obs import compilewatch as _compilewatch
from ..obs import metrics as _metrics
from ..ops.unique import unique_first_occurrence
from ..sampler.base import HeteroSamplerOutput, SamplerOutput
from ..sampler.neighbor_sampler import hop_widths, max_sampled_nodes
from ..typing import PADDING_ID
from ..utils.graphs import CapturedProgram
from .dist_feature import (HostColdStore, TieredShardedFeature,
                           _dedup_scatter_back, compact_cold_requests,
                           exchange_gather, exchange_gather_hot,
                           exchange_gather_xy, route_cold_requests)
from .dist_sampler import (DistNeighborSampler, _topology_choice,
                           dist_sample_multi_hop, exchange_byte_model,
                           hier_request_cap, seeds_on_mesh)
from .multihost import (Mesh, local_shard_range, mesh_axis_sizes,
                        resolve_mesh_axes)
from .sharding import (ShardedFeature, ShardedGraph, check_on_mesh,
                       torch_dtype)


def dist_step_byte_model(nodes_per_shard, num_shards, num_neighbors,
                         batch_size, frontier_cap, feature_dim, axis_name,
                         mesh_shape, route="auto", hier_load_factor=None,
                         elem_bytes=4):
    """Static per-device collective bytes of ONE distributed train step:
    :func:`~glt_tpu_torch.parallel.dist_sampler.exchange_byte_model` of
    each sampling hop (id request + fanout neighbor/edge-id payload)
    plus the feature+label exchange over the node capacity, split by
    fabric.  Returns ``{"ici": bytes, "dcn": bytes, "topology": 'flat' |
    'hier'}``; a 1-D mesh puts every byte under ICI (within a host).  The
    ``glt.dist.collective_bytes{axis=}`` counters add these per step."""
    topo = _topology_choice(route, axis_name, mesh_shape)
    if isinstance(axis_name, str) or mesh_shape is None:
        h, c = 1, int(num_shards)
    else:
        h, c = int(mesh_shape[0]), int(mesh_shape[1])
    widths = hop_widths(batch_size, list(num_neighbors), frontier_cap)
    node_cap = max_sampled_nodes(batch_size, list(num_neighbors),
                                 frontier_cap)
    ici = dcn = 0
    for w, fo in zip(widths, num_neighbors):
        hc = hier_request_cap(w, c, nodes_per_shard, hier_load_factor)
        i, d = exchange_byte_model(topo, h, c, w, 2 * fo, hier_cap=hc,
                                   elem_bytes=elem_bytes)
        ici += i
        dcn += d
    hc = hier_request_cap(node_cap, c, nodes_per_shard, hier_load_factor)
    i, d = exchange_byte_model(topo, h, c, node_cap, feature_dim + 1,
                               hier_cap=hc, elem_bytes=elem_bytes)
    return {"ici": ici + i, "dcn": dcn + d, "topology": topo}


def _byte_counters(byte_model):
    """The per-axis collective byte counters a step adds to per call."""
    help_ = ("static per-device collective bytes moved by dist train "
             "steps, split by fabric (from the routing plan's shapes)")
    c_ici = _metrics.counter("glt.dist.collective_bytes", help_,
                             labels={"axis": "ici"})
    c_dcn = _metrics.counter("glt.dist.collective_bytes", help_,
                             labels={"axis": "dcn"})

    def record(steps=1):
        c_ici.inc(float(byte_model["ici"] * steps))
        c_dcn.inc(float(byte_model["dcn"] * steps))
    return record


def _gather_xy_local(node, rows, labels_blk, f, g, dedup_gather, route,
                     fused, fuse_xy, fused_frontier=False, mesh_shape=None,
                     hier_load_factor=None
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every shard's feature+label gather for its sampled node list: one
    routing plan and one payload collective when the id spaces agree
    (``fuse_xy``), else a feature and a label exchange, over one unique
    pass with ``dedup_gather``.  ``fused_frontier`` serves the FEATURE
    rows through kernel B3 (a label column is 1-wide);
    ``mesh_shape``/``hier_load_factor`` pick the 2-D mesh's
    hierarchical route (the same rows).  Returns, per shard, ``(x, y)``
    with ``y = -1`` at padding."""
    S = g.num_shards
    hkw = dict(mesh_shape=mesh_shape, hier_load_factor=hier_load_factor)
    if fuse_xy:
        xy = exchange_gather_xy(node, rows, labels_blk, f.nodes_per_shard,
                                f.num_shards, dedup=dedup_gather,
                                route=route, fused=fused,
                                fused_frontier=fused_frontier, **hkw)
    else:
        lab = [labels_blk[s][:, None].to(torch.int32) for s in range(S)]
        if dedup_gather:
            # ONE unique pass feeds both exchanges.
            un = [unique_first_occurrence(n) for n in node]
            uniq = [u.uniques for u in un]
            ux = exchange_gather(uniq, rows, f.nodes_per_shard,
                                 f.num_shards, route=route,
                                 fused_frontier=fused_frontier, **hkw)
            uy = exchange_gather(uniq, lab, g.nodes_per_shard, S,
                                 route=route, **hkw)
            xy = [(_dedup_scatter_back(ux[s], un[s].inverse),
                   _dedup_scatter_back(uy[s], un[s].inverse)[:, 0])
                  for s in range(S)]
        else:
            x = exchange_gather(node, rows, f.nodes_per_shard, f.num_shards,
                                route=route, fused_frontier=fused_frontier,
                                **hkw)
            y = exchange_gather(node, lab, g.nodes_per_shard, S,
                                route=route, **hkw)
            xy = [(x[s], y[s][:, 0]) for s in range(S)]
    return [(x, torch.where(n >= 0, y, PADDING_ID))
            for (x, y), n in zip(xy, node)]


def _masked_step(opt: torch.optim.Optimizer, real: torch.Tensor) -> None:
    """``opt.step()`` kept where the device bool ``real`` holds and
    dropped where it does not: the parameters and every state tensor
    (a state the step created starts from zeros, Adam's fresh state)
    are selected on the device."""
    params = [p for grp in opt.param_groups for p in grp["params"]]
    before = {p: {k: v.clone() for k, v in opt.state[p].items()
                  if isinstance(v, torch.Tensor)}
              for p in params if p in opt.state}
    saved = [p.detach().clone() for p in params]
    opt.step()
    with torch.no_grad():
        for p, old in zip(params, saved):
            p.copy_(torch.where(real, p, old))
        for p in params:
            prev = before.get(p, {})
            for k, v in opt.state[p].items():
                if isinstance(v, torch.Tensor):
                    old = prev.get(k)
                    v.copy_(torch.where(real, v, torch.zeros_like(v)
                                        if old is None else old))


def _host_seeds(seeds) -> np.ndarray:
    if isinstance(seeds, torch.Tensor):
        if seeds.device.type != "cpu":
            raise TypeError("seeds must be a host array: the step counter "
                            "advances on the host")
        seeds = seeds.numpy()
    return np.asarray(seeds)


def sample_and_gather(g: ShardedGraph, f: ShardedFeature,
                      labels: torch.Tensor, seeds: torch.Tensor,
                      key: torch.Tensor, num_neighbors: Sequence[int],
                      frontier_cap: Optional[int] = None,
                      last_hop_dedup: bool = True,
                      exchange_load_factor: Optional[float] = None,
                      dedup_gather: bool = False, route: str = "auto",
                      fused: Optional[bool] = None,
                      fused_frontier: bool = False,
                      axis_name=None, mesh_shape: Optional[tuple] = None,
                      hier_load_factor: Optional[float] = None):
    """The data half of one distributed step: shard ``s`` samples its
    row of ``seeds`` (``[S, B]`` on the mesh's device) with ``fold_in(
    key, s)``, then every shard gathers its node list's features and
    labels (on a 2-D mesh both over the route ``route`` resolves to).
    Returns ``(keys, outs, xy)``, per shard: the key, the
    :class:`~glt_tpu_torch.sampler.base.SamplerOutput` and ``(x, y)``."""
    S = g.num_shards
    keys = [trandom.fold_in(key, s) for s in range(S)]
    outs = dist_sample_multi_hop(
        g.indptr, g.indices, g.edge_ids, seeds, keys, num_neighbors,
        g.nodes_per_shard, S, frontier_cap, last_hop_dedup=last_hop_dedup,
        exchange_load_factor=exchange_load_factor, route=route,
        fused=fused, mesh_shape=mesh_shape,
        hier_load_factor=hier_load_factor, axis_name=axis_name)
    # Features and labels share one exchange when their id spaces agree
    # (always, for shard_graph/shard_feature over one node set).
    fuse_xy = (f.nodes_per_shard == g.nodes_per_shard
               and f.num_shards == S)
    xy = _gather_xy_local([o.node for o in outs], f.rows, labels, f, g,
                          dedup_gather, route, fused, fuse_xy,
                          fused_frontier, mesh_shape, hier_load_factor)
    return keys, outs, xy


def _mesh_loss(model, g: ShardedGraph, f: ShardedFeature,
               labels: torch.Tensor, seeds: torch.Tensor, key: torch.Tensor,
               num_neighbors: Sequence[int], batch_size: int, skw: dict):
    """One batch of every shard (``seeds [S, B]`` on the mesh's device):
    sample and gather (:func:`sample_and_gather`, the knobs in ``skw``),
    each shard's forward with its own key as the dropout key, and the
    means over the shards of the seed losses and accuracies."""
    keys, outs, xy = sample_and_gather(g, f, labels, seeds, key,
                                       num_neighbors, **skw)
    losses, accs = [], []
    for s, (out, (x, y)) in enumerate(zip(outs, xy)):
        logits = model(x, torch.stack([out.row, out.col]), out.edge_mask,
                       dropout_key=keys[s])
        loss_s, acc_s = seed_cross_entropy(logits, y, batch_size,
                                           out.node_mask)
        losses.append(loss_s)
        accs.append(acc_s.to(torch.float32))
    return torch.stack(losses).mean(), torch.stack(accs).mean()


def _check_step_args(g: ShardedGraph, f, labels: torch.Tensor, mesh: Mesh,
                     axis_name):
    """The mesh and its axes, checked as the steps need them: a mesh of
    as many shards as the graph, every array on the mesh's device (of a
    tiered feature, its hot tier).  Returns ``(axis_name, mesh_shape)``:
    the resolved axes and, on a 2-D mesh, its ``(H, C)``."""
    axis_name = resolve_mesh_axes(mesh, axis_name)
    mesh_shape = mesh_axis_sizes(mesh, axis_name)
    if g.num_shards != mesh.size:
        raise ValueError(f"a graph of {g.num_shards} shards on a mesh of "
                         f"{mesh.size}")
    check_on_mesh(mesh, indptr=g.indptr, indices=g.indices,
                  edge_ids=g.edge_ids, rows=_device_rows(f), labels=labels)
    return axis_name, mesh_shape


def _device_rows(f) -> torch.Tensor:
    """The device rows of a :class:`ShardedFeature` or the hot tier of a
    :class:`TieredShardedFeature`."""
    return f.hot if isinstance(f, TieredShardedFeature) else f.rows


def make_dist_train_step(
    g: ShardedGraph,
    f: ShardedFeature,
    labels: torch.Tensor,          # [S, nodes_per_shard] int labels
    mesh: Mesh,
    num_neighbors: Sequence[int],
    batch_size: int,
    axis_name: Optional[str] = None,
    frontier_cap: Optional[int] = None,
    last_hop_dedup: bool = True,
    exchange_load_factor: Optional[float] = None,
    dedup_gather: bool = False,
    route: str = "auto",
    fused: Optional[bool] = None,
    fused_frontier: bool = False,
    hier_load_factor: Optional[float] = None,
):
    """Build ``step(state, seeds [S, B], key) -> (state, loss, acc)``.

    ``seeds`` holds one seed batch per shard (a host array, -1 padded;
    :meth:`~glt_tpu_torch.distributed.DistDataset.split_seeds` gives
    them); shard ``s`` samples with ``fold_in(key, s)``.  ``loss`` and
    ``acc`` are the means over the shards, on the device.  The model and
    optimizer of ``state`` must live on the mesh's device.

    ``last_hop_dedup=False`` selects the leaf-block final hop (the loss
    reads seed rows only, so the objective is unchanged).
    ``exchange_load_factor`` bounds the sampler's buckets (see
    :func:`~glt_tpu_torch.parallel.dist_sampler.dist_sample_multi_hop`).
    ``dedup_gather`` sends each unique node id through the feature and
    label exchange once and expands the rows back (the same batch).
    ``route`` / ``fused`` pick the bucketing and the fused collectives;
    features and labels ride one plan and one payload collective.
    ``fused_frontier`` serves each shard's feature requests through
    kernel B3.  On a 2-D mesh (``axis_name=None`` takes the mesh's
    ``("host", "chip")`` pair) both hops and the gather take the
    hierarchical route where ``route`` resolves 'hier' (the same batch
    as 'flat'); ``hier_load_factor`` bounds its cross-host leg.  The
    step carries its static byte model as ``step.collective_bytes`` and
    adds it to the ``glt.dist.collective_bytes{axis=}`` counters per
    call.
    """
    axis_name, mesh_shape = _check_step_args(g, f, labels, mesh, axis_name)
    dev = mesh.device
    byte_model = dist_step_byte_model(
        g.nodes_per_shard, g.num_shards, num_neighbors, batch_size,
        frontier_cap, f.rows.shape[-1], axis_name, mesh_shape, route=route,
        hier_load_factor=hier_load_factor)
    record_bytes = _byte_counters(byte_model)
    skw = dict(frontier_cap=frontier_cap, last_hop_dedup=last_hop_dedup,
               exchange_load_factor=exchange_load_factor,
               dedup_gather=dedup_gather, route=route, fused=fused,
               fused_frontier=fused_frontier, axis_name=axis_name,
               mesh_shape=mesh_shape, hier_load_factor=hier_load_factor)

    def step(state: TrainState, seeds, key: torch.Tensor):
        record_bytes()
        _check_model(state, dev)
        host = _host_seeds(seeds)
        seeds_dev = seeds_on_mesh(host, mesh)
        model, opt = state.model, state.optimizer
        loss, acc = _mesh_loss(model, g, f, labels, seeds_dev, key,
                               num_neighbors, batch_size, skw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        _masked_step(opt, (seeds_dev >= 0).any())
        real = bool((host >= 0).any())
        return (TrainState(model, opt, state.step + int(real)),
                loss.detach(), acc)

    step.collective_bytes = byte_model
    return step


def make_scanned_dist_train_step(
    g: ShardedGraph,
    f: ShardedFeature,
    labels: torch.Tensor,          # [S, nodes_per_shard] int labels
    mesh: Mesh,
    num_neighbors: Sequence[int],
    batch_size: int,
    axis_name: Optional[str] = None,
    frontier_cap: Optional[int] = None,
    last_hop_dedup: bool = True,
    exchange_load_factor: Optional[float] = None,
    dedup_gather: bool = False,
    route: str = "auto",
    fused: Optional[bool] = None,
    fused_frontier: bool = False,
    hier_load_factor: Optional[float] = None,
):
    """Train ``G`` consecutive distributed batches per call (cf.
    ``glt_tpu``'s ``make_scanned_dist_train_step``).

    Returns ``step(state, seeds_blk [G, S, B], key) -> (state, losses
    [G], accs [G])``: ``seeds_blk`` is a HOST block (-1 padded;
    :func:`dist_seed_blocks`), slot ``g`` takes ``split(key, G)[g]`` and
    shard ``s`` within it ``fold_in`` of that key with ``s``, for its
    sample and its dropout, as :func:`make_dist_train_step` does per
    call.  Losses and accuracies are the slots' means over the shards,
    on the device.  A slot with no real seed on any shard is skipped on
    the host (``glt_tpu``'s global ``lax.cond``): the parameters, the
    optimizer's state and the step counter hold, and its loss and
    accuracy are 0; the counter advances by the real slots.  The other
    arguments mean what they mean for :func:`make_dist_train_step`.

    On the card the block is one CUDA graph per real-slot pattern, over
    a static ``[G, S, B]`` seed buffer filled through pinned memory and
    a key buffer: the first call at a pattern runs eagerly (it creates
    Adam's state), the next captures the block, and every later call
    replays it; captures count under the compilewatch label
    ``scanned_dist_step``.  The byte counters add ``G`` steps a call on
    the host, outside the graph.  On the CPU every call runs eagerly.
    """
    axis_name, mesh_shape = _check_step_args(g, f, labels, mesh, axis_name)
    dev = mesh.device
    S = g.num_shards
    byte_model = dist_step_byte_model(
        g.nodes_per_shard, S, num_neighbors, batch_size, frontier_cap,
        f.rows.shape[-1], axis_name, mesh_shape, route=route,
        hier_load_factor=hier_load_factor)
    record_bytes = _byte_counters(byte_model)
    skw = dict(frontier_cap=frontier_cap, last_hop_dedup=last_hop_dedup,
               exchange_load_factor=exchange_load_factor,
               dedup_gather=dedup_gather, route=route, fused=fused,
               fused_frontier=fused_frontier, axis_name=axis_name,
               mesh_shape=mesh_shape, hier_load_factor=hier_load_factor)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)

    def block(model, opt, blocks, key, real):
        seeds, = blocks
        keys = trandom.split(key, len(real))
        losses, accs = [], []
        for i, is_real in enumerate(real):
            if not is_real:
                losses.append(zero_f)
                accs.append(zero_f)
                continue
            loss, acc = _mesh_loss(model, g, f, labels, seeds[i], keys[i],
                                   num_neighbors, batch_size, skw)
            _backward_and_step(opt, loss)
            losses.append(loss.detach())
            accs.append(acc)
        return torch.stack(losses), torch.stack(accs)

    blocks = _ScannedBlocks(dev, block, None, "scanned_dist_step")

    def step(state: TrainState, seeds_blk, key: torch.Tensor):
        blk = _host_seeds(seeds_blk)
        if blk.ndim != 3 or blk.shape[1:] != (S, batch_size):
            raise ValueError(f"expected [G, {S}, {batch_size}] seeds, got "
                             f"{tuple(blk.shape)}")
        record_bytes(int(blk.shape[0]))
        return blocks(state, blk, key)

    step.collective_bytes = byte_model
    return step


def dist_seed_blocks(train_idx, num_shards: int, batch_size: int,
                     group: int, rng):
    """Shuffled ``[G, S, B]`` seed blocks, -1 padded: the epoch feed of
    :func:`make_scanned_dist_train_step` (each slot one disjoint seed
    batch per shard; trailing slots may be fully padded no-ops)."""
    ids = np.asarray(train_idx)[rng.permutation(len(train_idx))]
    per_block = batch_size * num_shards * group
    for lo in range(0, len(ids), per_block):
        blk = np.full((group, num_shards, batch_size), -1, np.int64)
        chunk = ids[lo: lo + per_block]
        blk.reshape(-1)[: chunk.shape[0]] = chunk
        yield blk


def run_scanned_dist_epoch(step, state: TrainState, train_idx,
                           num_shards: int, batch_size: int, group: int,
                           rng, base_key: torch.Tensor, start_block: int = 0,
                           on_block=None):
    """One epoch through :func:`make_scanned_dist_train_step`.

    Shuffles ``train_idx`` into ``[G, S, B]`` blocks
    (:func:`dist_seed_blocks`) and drives ``step`` once per block under
    ``fold_in(base_key, i)``; the losses and accuracies come back in ONE
    device->host copy at the end.  Returns ``(state, losses [n_real],
    accs [n_real])`` as host numpy; ``n_real`` counts the real slots.
    ``start_block``/``on_block`` are the resume seam of
    :func:`~glt_tpu_torch.models.run_scanned_epoch`: the first
    ``start_block`` blocks are skipped without moving the key schedule,
    and ``on_block(state, i)`` fires after block ``i``'s device work has
    finished.
    """
    blocks = list(dist_seed_blocks(train_idx, num_shards, batch_size,
                                   group, rng))
    n_real = -(-len(train_idx) // (batch_size * num_shards))
    n_real = max(0, n_real - int(start_block) * group)
    losses, accs = [], []
    for i, blk in enumerate(blocks):
        if i < start_block:
            continue
        state, ls, acs = step(state, blk, trandom.fold_in(base_key, i))
        losses.append(ls)
        accs.append(acs)
        if on_block is not None:
            # The hook may checkpoint: the block's device work finishes
            # first, so the state it captures is post-block.
            if ls.is_cuda:
                torch.cuda.synchronize(ls.device)
            on_block(state, i)
    if not losses:
        empty = np.zeros((0,), np.float32)
        return state, empty, empty
    n = sum(ls.shape[0] for ls in losses)
    host = torch.cat(losses + accs).cpu().numpy()
    return state, host[:n][:n_real], host[n:][:n_real]


class _Graphed:
    """``fn(*inputs)`` (device tensors in, a tuple of tensors out) as one
    CUDA graph per pattern of input shapes on the card: the first call
    at a pattern, or after the storage ``held()`` names moved, runs
    eagerly (it creates Adam's state); the next captures, under the
    compilewatch label ``label``; every later call copies its inputs
    into the graph's and replays it.  Returned tensors are the caller's
    own (a replay rewrites the graph's outputs).  On the CPU every call
    runs eagerly."""

    def __init__(self, fn: Callable, label: str,
                 held: Callable[[], tuple] = tuple):
        self.fn = fn
        self.label = label
        self.held = held
        self._programs = {}  # pattern -> (CapturedProgram, storage)
        self._warm = {}      # pattern -> storage of its eager call

    def _storage(self) -> tuple:
        return tuple(t.data_ptr() for t in self.held())

    def __call__(self, *inputs) -> tuple:
        if not inputs[0].is_cuda:
            return self.fn(*inputs)
        pattern = tuple((tuple(t.shape), t.dtype) for t in inputs)
        now = self._storage()
        entry = self._programs.get(pattern)
        if entry is not None and entry[1] == now:
            outs = entry[0](*inputs)
        elif self._warm.get(pattern) == now:
            with _compilewatch.label(self.label):
                prog = CapturedProgram(self.fn, [t.clone() for t in inputs],
                                       warmup=0)
            self._programs[pattern] = (prog, now)
            outs = prog.replay()
        else:
            self._programs.pop(pattern, None)
            outs = self.fn(*inputs)
            self._warm[pattern] = self._storage()
            return outs
        return tuple(t.clone() for t in outs)


def _state_tensors(state: TrainState) -> tuple:
    """The tensors a captured train step reads and writes in place."""
    return tuple(state.model.parameters()) + tuple(
        t for st in state.optimizer.state.values() for t in st.values()
        if isinstance(t, torch.Tensor))


def make_tiered_train_step(
    g: ShardedGraph,
    f: TieredShardedFeature,
    labels: torch.Tensor,          # [S, nodes_per_shard] int labels
    mesh: Mesh,
    batch_size: int,
    axis_name: Optional[str] = None,
    dedup_gather: bool = False,
    route: str = "auto",
    fused: Optional[bool] = None,
    fused_frontier: bool = False,
    hier_load_factor: Optional[float] = None,
):
    """The train half of the tiered two-stage pipeline.

    Returns ``train(state, out, staged, key) -> (state, loss, acc)``:
    ``out`` is the sample stage's :class:`SamplerOutput` (fields lead
    with the shard axis) and ``staged = (rows [S, cold_cap, d], slots
    [S, cold_cap])`` the compact cold staging of every serving shard
    (:func:`route_cold_requests`, :func:`compact_cold_requests`, a cold
    store's gather).  Hot rows ride the exchange; the staged cold rows
    are scattered into its response leg.  Features and labels share one
    plan and one payload collective when the graph's and the feature's
    id spaces agree (:func:`exchange_gather_xy` with ``hot_per_shard``),
    else the hot gather (:func:`exchange_gather_hot`) and a label
    exchange.  ``dedup_gather`` must match the pipeline's: the staged
    slots index the (possibly deduped) request layout.  Shard ``s``
    drops out under ``fold_in(key, s)``; the update always runs, as in
    ``glt_tpu``.  ``fused_frontier`` serves the hot rows through kernel
    B3.

    On the card the step is one CUDA graph per input shape (captured
    on the second call, under the compilewatch label
    ``tiered_train_step``; see :class:`_Graphed`).
    """
    _, mesh_shape = _check_step_args(g, f, labels, mesh, axis_name)
    hkw = dict(mesh_shape=mesh_shape, hier_load_factor=hier_load_factor)
    S = g.num_shards
    c, h = f.nodes_per_shard, f.hot_per_shard
    fuse_xy = f.nodes_per_shard == g.nodes_per_shard and f.num_shards == S
    cur = {}

    def body(node, row, col, edge_mask, node_mask, rows, slots, key):
        model, opt = cur["state"].model, cur["state"].optimizer
        if fuse_xy:
            xy = exchange_gather_xy(node, f.hot, labels, c, f.num_shards,
                                    hot_per_shard=h, staged_rows=rows,
                                    staged_slots=slots, dedup=dedup_gather,
                                    route=route, fused=fused,
                                    fused_frontier=fused_frontier, **hkw)
        else:
            x = exchange_gather_hot(node, f.hot, c, h, f.num_shards,
                                    staged_rows=rows, staged_slots=slots,
                                    dedup=dedup_gather, route=route,
                                    fused_frontier=fused_frontier, **hkw)
            y = exchange_gather(node, [labels[s][:, None].to(torch.int32)
                                       for s in range(S)],
                                g.nodes_per_shard, S, dedup=dedup_gather,
                                route=route, **hkw)
            xy = [(x[s], y[s][:, 0]) for s in range(S)]
        losses, accs = [], []
        for s, (x, y) in enumerate(xy):
            y = torch.where(node[s] >= 0, y, PADDING_ID)
            logits = model(x, torch.stack([row[s], col[s]]), edge_mask[s],
                           dropout_key=trandom.fold_in(key, s))
            loss_s, acc_s = seed_cross_entropy(logits, y, batch_size,
                                               node_mask[s])
            losses.append(loss_s)
            accs.append(acc_s.to(torch.float32))
        loss = torch.stack(losses).mean()
        _backward_and_step(opt, loss)
        return loss.detach(), torch.stack(accs).mean()

    graphed = _Graphed(body, "tiered_train_step",
                       lambda: _state_tensors(cur["state"]))

    def train(state: TrainState, out: SamplerOutput, staged,
              key: torch.Tensor):
        _check_model(state, mesh.device)
        rows, slots = staged
        cur["state"] = state
        try:
            loss, acc = graphed(out.node, out.row, out.col, out.edge_mask,
                                out.node_mask, rows, slots, key)
        finally:
            cur.clear()
        return TrainState(state.model, state.optimizer, state.step + 1), \
            loss, acc

    return train


class _ColdStagePipeline:
    """The core of the two-stage (sample -> host cold gather -> train)
    pipeline: the staging thread and gather pool, the lazily reduced
    drop counters, the double-buffered epoch loop and shutdown.  A
    subclass provides ``_sample_and_stage(seeds, key) -> (out, future)``
    and ``_train_staged(state, out, staged, key)``.

    Batch ``k``'s cold gather runs on the staging thread while the main
    thread trains batch ``k - 1``, so a step takes about ``max(device,
    host gather)`` rather than their sum.  A thread carries the overlap,
    so it holds on the CPU as on the card.
    """

    def _init_pools(self, stage_threads: Optional[int], name: str) -> None:
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"{name}-stage")
        # Gather workers: (shard, row chunk) work items; numpy fancy
        # indexing releases the GIL, so the chunks use the host's cores.
        self.stage_threads = (max(1, os.cpu_count() or 1)
                              if stage_threads is None
                              else max(1, int(stage_threads)))
        self._gather_pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=self.stage_threads,
            thread_name_prefix=f"{name}-gather")
            if self.stage_threads > 1 else None)
        self._pending_dropped = []   # unreduced per-batch device counts
        self.dropped_total = 0       # host sum over all staged batches
        self._drop_lock = threading.Lock()  # staging thread vs caller

    def _record_dropped(self, dropped: torch.Tensor) -> None:
        # Kept on the device and reduced in flush_dropped: no host sync a
        # batch on the main thread.
        with self._drop_lock:
            self._pending_dropped.append(dropped)

    def _maybe_flush_on_stage_thread(self) -> None:
        # The periodic reduction rides the staging thread, which waits
        # for the device anyway.
        if len(self._pending_dropped) >= 64:
            self.flush_dropped()

    def flush_dropped(self) -> int:
        """Reduce the pending per-batch drop counters into
        ``dropped_total`` (cold requests past ``cold_cap``, served as
        zero rows: raise ``cold_cap`` if it is ever nonzero)."""
        with self._drop_lock:
            pending, self._pending_dropped = self._pending_dropped, []
        total = int(torch.stack(pending).sum()) if pending else 0
        with self._drop_lock:
            self.dropped_total += total
        return self.dropped_total

    def run_epoch(self, state: TrainState, seed_batches, key: torch.Tensor,
                  start_batch: int = 0, on_batch=None, supervisor=None):
        """One epoch; ``seed_batches``: iterable of ``[S, B]`` seeds.

        Returns ``(state, losses, accs)``, lists of device scalars (no
        sync).  Batch ``i`` samples under ``fold_in(fold_in(key, i), 1)``
        and trains under ``fold_in(fold_in(key, i + 1), 2)``, as
        ``glt_tpu``'s pipeline: a pure function of its position, so
        ``start_batch=k`` (skip the first ``k`` batches of the same
        schedule) resumes the same stream.  ``on_batch(state, i)`` fires
        after batch ``i`` trained, its device work finished.  Check
        :meth:`flush_dropped` after the epoch.  ``supervisor`` needs
        ``distributed/supervisor.py``, which is not ported (ROADMAP
        queue A item 8): anything but None raises.
        """
        if supervisor is not None:
            raise NotImplementedError(
                "run_epoch(supervisor=...) needs distributed/supervisor.py,"
                " which is not ported yet (ROADMAP queue A item 8)")
        losses, accs = [], []
        pending = None  # (idx, out, staged future)
        n = 0

        def train(pend, k):
            nonlocal state
            i, out, fut = pend
            state, loss, acc = self._train_staged(state, out, fut.result(),
                                                  k)
            losses.append(loss)
            accs.append(acc)
            if on_batch is not None:
                if loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
                on_batch(state, i)

        for i, seeds in enumerate(seed_batches):
            if i < start_batch:
                continue
            kb = trandom.fold_in(key, i)
            out, fut = self._sample_and_stage(seeds, trandom.fold_in(kb, 1))
            if pending is not None:
                train(pending, trandom.fold_in(kb, 2))
            pending = (i, out, fut)
            n = i + 1
        if pending is not None:
            train(pending, trandom.fold_in(trandom.fold_in(key, n), 2))
        # The epoch boundary of a tier-aware cold store (DiskColdStore
        # publishes its glt.store.* gauges here).
        pub = getattr(getattr(self, "cold_store", None),
                      "publish_epoch_stats", None)
        if pub is not None:
            pub()
        return state, losses, accs

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        if self._gather_pool is not None:
            self._gather_pool.shutdown(wait=False)
        closer = getattr(getattr(self, "cold_store", None), "close", None)
        if closer is not None:
            closer()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TieredTrainPipeline(_ColdStagePipeline):
    """The homogeneous two-stage pipeline over a
    :class:`~glt_tpu_torch.parallel.dist_feature.TieredShardedFeature`
    (see :class:`_ColdStagePipeline`).

    Stage 1 samples every shard's batch (``sampler``) and routes its
    node list's cold requests, compacted to ``cold_cap`` slots a serving
    shard (default twice the node capacity; past it a request trains on
    a zero row and counts in ``flush_dropped``).  The staging thread
    gathers those rows from ``cold_store`` (a :class:`HostColdStore` over
    ``f.cold`` by default, or a
    :class:`~glt_tpu_torch.store.stager.DiskColdStore`, which a feature
    from ``shard_feature_tiered_from_store`` must get) through a
    two-deep ring of host buffers, while ``train_step`` (from
    :func:`make_tiered_train_step`, the same ``dedup_gather``) trains
    the previous batch.  ``max_cold_rows`` is the largest cold count a
    serving shard saw, to size ``cold_cap`` by.

    On the card stage 1 is one CUDA graph a step (label
    ``tiered_stage``), and no host sync sits on the main thread: an
    event after the route lets a side stream copy the cold ids to pinned
    memory; the staging thread waits for that copy alone, gathers into a
    pinned ring slot (first waiting for that slot's previous
    host->device copy) and copies the rows to the card on a copy
    stream; the main stream waits for that copy's event before the
    train step, and the copy into a ring slot waits for the train that
    last read it.  The train step copies the staged rows into its
    graph's input on the main stream.
    """

    def __init__(self, sampler: DistNeighborSampler, train_step,
                 f: TieredShardedFeature, mesh: Mesh,
                 axis_name: Optional[str] = None,
                 cold_store: Optional[HostColdStore] = None,
                 cold_cap: Optional[int] = None,
                 stage_threads: Optional[int] = None,
                 dedup_gather: bool = False,
                 route: str = "auto",
                 hier_load_factor: Optional[float] = None):
        self.sampler = sampler
        self.train_step = train_step
        self.f = f
        self.mesh = mesh
        self.axis_name = resolve_mesh_axes(mesh, axis_name)
        self.mesh_shape = mesh_axis_sizes(mesh, self.axis_name)
        self.hier_load_factor = hier_load_factor
        self.cold_cap = (2 * sampler.node_capacity if cold_cap is None
                         else int(cold_cap))
        self._local = local_shard_range(mesh, self.axis_name)
        if (cold_store is None and f.cold.shape[1] == 0
                and f.nodes_per_shard > f.hot_per_shard):
            # A zero-row placeholder (shard_feature_tiered_from_store):
            # a defaulted HostColdStore would serve zero rows for every
            # cold request.
            raise ValueError(
                "TieredShardedFeature has an empty host cold tier but "
                f"{f.nodes_per_shard - f.hot_per_shard} cold rows per "
                "shard — pass the DiskColdStore backing it as cold_store=")
        self.cold_store = cold_store or HostColdStore(
            f, shard_ids=self._local)
        self._init_pools(stage_threads, "glt-cold")
        self.last_dropped = None     # [S] device counts, latest batch
        self.max_cold_rows = 0
        self.dedup_gather = bool(dedup_gather)
        self.route = route
        self._stage_prog = _Graphed(self._stage_body, "tiered_stage")
        dev = mesh.device
        self._cuda = dev.type == "cuda"
        shape = (len(self._local), self.cold_cap, self.cold_store.dim)
        self._flip = 0
        if self._cuda:
            dt = torch_dtype(self.cold_store.dtype)
            self._ids_host = [torch.empty(
                (len(self._local), self.cold_cap), dtype=torch.int32,
                pin_memory=True) for _ in range(2)]
            self._rows_host = [torch.empty(shape, dtype=dt, pin_memory=True)
                               for _ in range(2)]
            self._rows_dev = [torch.empty(shape, dtype=dt, device=dev)
                              for _ in range(2)]
            self._h2d_done = [None, None]   # the ring slot's last H2D copy
            self._consumed = [None, None]   # the train that last read it
            self._fetch_stream = torch.cuda.Stream(dev)
            self._copy_stream = torch.cuda.Stream(dev)

    def _stage_body(self, seeds: torch.Tensor, key: torch.Tensor) -> tuple:
        """Stage 1: sample, then route and compact the cold requests."""
        f = self.f
        out = self.sampler.sample_from_nodes(seeds, key=key)
        req = route_cold_requests(list(out.node), f.nodes_per_shard,
                                  f.hot_per_shard, f.num_shards,
                                  dedup=self.dedup_gather, route=self.route,
                                  mesh_shape=self.mesh_shape,
                                  hier_load_factor=self.hier_load_factor)
        comp = [compact_cold_requests(r, self.cold_cap) for r in req]
        slots, ids, dropped = (torch.stack(t) for t in zip(*comp))
        meta = out.metadata or {}
        return (out.node, out.row, out.col, out.edge, out.batch,
                out.node_mask, out.edge_mask, out.num_sampled_nodes,
                out.num_sampled_edges, slots, ids, dropped) + tuple(
                    meta[k] for k in sorted(meta))

    def _sample_and_stage(self, seeds, key: torch.Tensor):
        seeds = seeds_on_mesh(seeds, self.mesh)
        res = self._stage_prog(seeds, key)
        meta = self.sampler.exchange_load_factor is not None
        out = SamplerOutput(
            node=res[0], row=res[1], col=res[2], edge=res[3], batch=res[4],
            node_mask=res[5], edge_mask=res[6], num_sampled_nodes=res[7],
            num_sampled_edges=res[8],
            metadata={"exchange_dropped": res[12]} if meta else None)
        slots, ids, dropped = res[9:12]
        self.last_dropped = dropped
        self._record_dropped(dropped)
        return out, self._stage_cold_async(ids, slots)

    def _stage_cold_async(self, ids: torch.Tensor, slots: torch.Tensor):
        """Submit the host gather of ``ids`` (``[S, cold_cap]`` local
        cold ids, -1 padded); the future gives ``(rows, slots, copied,
        ring slot)``."""
        flip = self._flip
        self._flip ^= 1
        local = ids[self._local.start:self._local.stop]
        if self._cuda:
            routed = torch.cuda.Event()
            routed.record()
            with torch.cuda.stream(self._fetch_stream):
                self._fetch_stream.wait_event(routed)
                self._ids_host[flip].copy_(local, non_blocking=True)
                local.record_stream(self._fetch_stream)
                fetched = torch.cuda.Event()
                fetched.record(self._fetch_stream)

        def work():
            if self._cuda:
                fetched.synchronize()
                req = self._ids_host[flip].numpy()
                if self._h2d_done[flip] is not None:
                    self._h2d_done[flip].synchronize()
                staged = self._rows_host[flip].numpy()
            else:
                req = local.numpy()
                # A fresh buffer a batch: torch.from_numpy aliases it.
                staged = np.empty((len(self._local), self.cold_cap,
                                   self.cold_store.dim),
                                  self.cold_store.dtype)
            self.max_cold_rows = max(self.max_cold_rows,
                                     int((req >= 0).sum(axis=1).max()))
            futs = []
            for j, s in enumerate(self._local):
                futs += self.cold_store.serve_into(
                    staged[j], s, req[j], pool=self._gather_pool)
            for fu in futs:
                fu.result()
            self._maybe_flush_on_stage_thread()
            if not self._cuda:
                return torch.from_numpy(staged), slots, None, flip
            with torch.cuda.device(self.mesh.device), torch.cuda.stream(
                    self._copy_stream):
                if self._consumed[flip] is not None:
                    self._copy_stream.wait_event(self._consumed[flip])
                self._rows_dev[flip].copy_(self._rows_host[flip],
                                           non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            self._h2d_done[flip] = copied
            return self._rows_dev[flip], slots, copied, flip
        return self._pool.submit(work)

    def _train_staged(self, state: TrainState, out: SamplerOutput, staged,
                      key: torch.Tensor):
        rows, slots, copied, flip = staged
        if copied is not None:
            torch.cuda.current_stream(rows.device).wait_event(copied)
        res = self.train_step(state, out, (rows, slots), key)
        if copied is not None:
            consumed = torch.cuda.Event()
            consumed.record()
            self._consumed[flip] = consumed
        return res


def init_dist_state(model: torch.nn.Module, tx: OptimizerFactory,
                    g: ShardedGraph, f,
                    num_neighbors: Sequence[int], batch_size: int,
                    frontier_cap: Optional[int] = None) -> TrainState:
    """State at step 0 for ``model`` (built and placed on the mesh's
    device by the caller; the parameters are shared by every shard):
    one forward over zero inputs of the step's static shapes checks the
    model against the feature width, then the optimizer ``tx`` is
    built over the parameters.  ``f`` is a :class:`ShardedFeature` or a
    :class:`~glt_tpu_torch.parallel.dist_feature.TieredShardedFeature`
    (shapes from its hot tier)."""
    cap = max_sampled_nodes(batch_size, list(num_neighbors), frontier_cap)
    widths = hop_widths(batch_size, list(num_neighbors), frontier_cap)
    ecap = sum(w * fo for w, fo in zip(widths, num_neighbors))
    rows = _device_rows(f)
    dev = rows.device
    x = torch.zeros((cap, rows.shape[-1]), dtype=rows.dtype, device=dev)
    ei = torch.full((2, ecap), PADDING_ID, dtype=torch.int32, device=dev)
    with torch.no_grad():
        model(x, ei, torch.zeros(ecap, dtype=torch.bool, device=dev))
    return create_train_state(model, tx)


# -- heterogeneous graphs across shards --------------------------------------
def _hetero_xy(nodes, rows, meta, labels, tgt, fuse_xy, fused, staged, hkw):
    """Every shard's per-type features and target labels for its sampled
    node lists (``nodes``: type -> per-shard lists; ``rows``: type ->
    ``[S, n, d]`` device rows, a tiered type's hot tier; ``meta``: type
    -> ``(nodes_per_shard, rows served from the device, shards)``;
    ``staged``: tiered type -> compact cold staging).  The target type's
    rows and labels ride one exchange when their id spaces agree
    (``fuse_xy``); a tiered type scatters its staged cold rows into its
    exchange's response.  Returns per shard ``(x dict, y)``, ``y = -1``
    at padding."""
    S = len(nodes[tgt])
    xs = [{} for _ in range(S)]
    ys = None
    for t in rows:
        c, h, n_sh = meta[t]
        srows, sslots = staged.get(t, (None, None))
        if t == tgt and fuse_xy:
            got = exchange_gather_xy(nodes[t], rows[t], labels, c, n_sh,
                                     hot_per_shard=h, staged_rows=srows,
                                     staged_slots=sslots, fused=fused,
                                     **hkw)
            ys = [y for _, y in got]
            got = [x for x, _ in got]
        elif srows is not None:
            got = exchange_gather_hot(nodes[t], rows[t], c, h, n_sh,
                                      staged_rows=srows, staged_slots=sslots,
                                      **hkw)
        else:
            got = exchange_gather(nodes[t], rows[t], c, n_sh, **hkw)
        for s in range(S):
            xs[s][t] = got[s]
    if ys is None:
        ys = [y[:, 0] for y in exchange_gather(
            nodes[tgt], [labels[s][:, None].to(torch.int32)
                         for s in range(S)], int(labels.shape[1]), S,
            **hkw)]
    return [(x, torch.where(n >= 0, y, PADDING_ID))
            for x, y, n in zip(xs, ys, nodes[tgt])]


def _hetero_loss(model, outs, xy, keys, tgt, batch_size):
    """The mean over the shards of the seed loss and accuracy of each
    shard's forward (``outs``: per-shard hetero outputs, ``keys``: each
    shard's dropout key)."""
    losses, accs = [], []
    for out, (x, y), k in zip(outs, xy, keys):
        edge_index = {et: torch.stack([out.row[et], out.col[et]])
                      for et in out.row}
        logits = model(x, edge_index, out.edge_mask, dropout_key=k)
        loss, acc = seed_cross_entropy(logits, y, batch_size,
                                       out.node_mask[tgt])
        losses.append(loss)
        accs.append(acc.to(torch.float32))
    return torch.stack(losses).mean(), torch.stack(accs).mean()


def _hetero_meta(sampler, feats, labels, mesh: Mesh, axis_name):
    """The checks and static facts both hetero steps need: the mesh's
    axes and shape, each type's ``(nodes_per_shard, device rows,
    shards)`` and whether the target's rows and labels share one id
    space."""
    axis_name = resolve_mesh_axes(mesh, axis_name)
    mesh_shape = mesh_axis_sizes(mesh, axis_name)
    S = sampler.num_shards
    if S != mesh.size:
        raise ValueError(f"a sampler of {S} shards on a mesh of {mesh.size}")
    check_on_mesh(mesh, labels=labels, **{
        f"rows of {t}": _device_rows(f) for t, f in feats.items()})
    meta = {t: (f.nodes_per_shard,
                (f.hot_per_shard if isinstance(f, TieredShardedFeature)
                 else f.nodes_per_shard), f.num_shards)
            for t, f in feats.items()}
    tgt = sampler.input_type
    fuse_xy = meta[tgt][0] == int(labels.shape[1]) and meta[tgt][2] == S
    return mesh_shape, meta, fuse_xy


def make_hetero_dist_train_step(
    sampler,                      # DistHeteroNeighborSampler
    feats,                        # Dict[NodeType, ShardedFeature]
    labels: torch.Tensor,         # [S, c_target] target-type labels
    mesh: Mesh,
    batch_size: int,
    axis_name: Optional[str] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    hier_load_factor: Optional[float] = None,
):
    """The hetero counterpart of :func:`make_dist_train_step` (cf.
    ``glt_tpu``'s, the reference's igbh distributed R-GAT): the hetero
    multi-hop exchange sampling
    (:class:`~glt_tpu_torch.parallel.dist_hetero_sampler.DistHeteroNeighborSampler`),
    each node type's feature exchange, R-GAT forward and backward of the
    shards' mean loss, one optimizer step.

    Returns ``step(state, seeds [S, B], key) -> (state, loss, acc)``:
    ``seeds`` a host array (-1 padded); shard ``s`` splits ``fold_in(key,
    s)`` into its dropout key and its sample key.  The model's edge
    types are the sampler's reversed output keys and its
    ``target_type`` the sampler's ``input_type``.  The target type's
    rows and labels ride one exchange
    (:func:`~glt_tpu_torch.parallel.dist_feature.exchange_gather_xy`)
    when their id spaces agree.  A fully padded batch leaves the
    parameters and Adam's state as they were, decided on the device;
    the host counter advances by the real batches.  ``route``,
    ``fused`` and ``hier_load_factor`` mean what they mean for
    :func:`make_dist_train_step` (on a 2-D mesh both the sample and
    the gathers take the route ``route`` resolves).

    On the card the step is one CUDA graph (captured on the second call
    under the compilewatch label ``hetero_dist_step``; see
    :class:`_Graphed`); on the CPU it runs eagerly.
    """
    mesh_shape, meta, fuse_xy = _hetero_meta(sampler, feats, labels, mesh,
                                             axis_name)
    tgt = sampler.input_type
    S = sampler.num_shards
    rows = {t: f.rows for t, f in feats.items()}
    hkw = dict(route=route, mesh_shape=mesh_shape,
               hier_load_factor=hier_load_factor)
    cur = {}

    def body(seeds, key):
        model, opt = cur["state"].model, cur["state"].optimizer
        keys = [trandom.split(trandom.fold_in(key, s)) for s in range(S)]
        outs = sampler.local_sample(list(seeds), [k[1] for k in keys])
        xy = _hetero_xy({t: [o.node[t] for o in outs] for t in outs[0].node},
                        rows, meta, labels, tgt, fuse_xy, fused, {}, hkw)
        loss, acc = _hetero_loss(model, outs, xy, [k[0] for k in keys], tgt,
                                 batch_size)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        _masked_step(opt, (seeds >= 0).any())
        return loss.detach(), acc

    graphed = _Graphed(body, "hetero_dist_step",
                       lambda: _state_tensors(cur["state"]))

    def step(state: TrainState, seeds, key: torch.Tensor):
        _check_model(state, mesh.device)
        host = _host_seeds(seeds)
        cur["state"] = state
        try:
            loss, acc = graphed(seeds_on_mesh(host, mesh), key)
        finally:
            cur.clear()
        real = bool((host >= 0).any())
        return (TrainState(state.model, state.optimizer,
                           state.step + int(real)), loss, acc)

    return step


def make_hetero_tiered_train_step(
    sampler,                      # DistHeteroNeighborSampler
    feats,                        # Dict[NodeType, Sharded|TieredSharded]
    labels: torch.Tensor,         # [S, c_target] target-type labels
    mesh: Mesh,
    batch_size: int,
    axis_name: Optional[str] = None,
    route: str = "auto",
    fused: Optional[bool] = None,
    hier_load_factor: Optional[float] = None,
):
    """The hetero counterpart of :func:`make_tiered_train_step`: node
    types whose feature is a :class:`TieredShardedFeature` gather their
    hot tier over the exchange and take their staged cold rows, the
    others the plain exchange; the sample happens outside (see
    :class:`HeteroTieredTrainPipeline`).

    Returns ``train(state, out, staged, key) -> (state, loss, acc)``:
    ``out`` the sampler's output (fields lead with the shard axis),
    ``staged`` a dict ``{node type: (rows [S, cold_cap, d], slots [S,
    cold_cap])}`` of the tiered types only; shard ``s`` drops out under
    ``fold_in(key, s)``, and the update always runs, as in ``glt_tpu``.
    On the card the step is one CUDA graph per pattern of input shapes,
    every type's staged buffers among them (label
    ``hetero_tiered_train_step``; see :class:`_Graphed`).
    """
    mesh_shape, meta, fuse_xy = _hetero_meta(sampler, feats, labels, mesh,
                                             axis_name)
    tgt = sampler.input_type
    S = sampler.num_shards
    rows = {t: _device_rows(f) for t, f in feats.items()}
    tiered = sorted(t for t, f in feats.items()
                    if isinstance(f, TieredShardedFeature))
    hkw = dict(route=route, mesh_shape=mesh_shape,
               hier_load_factor=hier_load_factor)
    cur = {}

    def body(*ins):
        model, opt = cur["state"].model, cur["state"].optimizer
        types, ets = cur["types"], cur["ets"]
        it = iter(ins)
        node = {t: next(it) for t in types}
        mask = next(it)
        coo = {et: (next(it), next(it), next(it)) for et in ets}
        staged = {t: (next(it), next(it)) for t in tiered}
        key = next(it)
        outs = [HeteroSamplerOutput(
            node={t: node[t][s] for t in types},
            row={et: coo[et][0][s] for et in ets},
            col={et: coo[et][1][s] for et in ets}, edge={},
            node_mask={tgt: mask[s]},
            edge_mask={et: coo[et][2][s] for et in ets}) for s in range(S)]
        xy = _hetero_xy({t: list(node[t]) for t in types}, rows, meta,
                        labels, tgt, fuse_xy, fused, staged, hkw)
        loss, acc = _hetero_loss(model, outs, xy,
                                 [trandom.fold_in(key, s) for s in range(S)],
                                 tgt, batch_size)
        _backward_and_step(opt, loss)
        return loss.detach(), acc

    graphed = _Graphed(body, "hetero_tiered_train_step",
                       lambda: _state_tensors(cur["state"]))

    def train(state: TrainState, out: HeteroSamplerOutput, staged,
              key: torch.Tensor):
        _check_model(state, mesh.device)
        types, ets = sorted(out.node), sorted(out.row)
        ins = ([out.node[t] for t in types] + [out.node_mask[tgt]]
               + [x for et in ets for x in (out.row[et], out.col[et],
                                            out.edge_mask[et])]
               + [x for t in tiered for x in staged[t]] + [key])
        cur.update(state=state, types=types, ets=ets)
        try:
            loss, acc = graphed(*ins)
        finally:
            cur.clear()
        return TrainState(state.model, state.optimizer, state.step + 1), \
            loss, acc

    return train


def _flatten_hetero(out: HeteroSamplerOutput):
    """A hetero output's tensors in a fixed order, and the spec that
    :func:`_unflatten_hetero` rebuilds it from."""
    spec, flat = [], []
    for name in ("node", "row", "col", "edge", "batch", "node_mask",
                 "edge_mask", "num_sampled_nodes", "num_sampled_edges",
                 "metadata"):
        d = getattr(out, name)
        keys = None if d is None else sorted(d)
        spec.append((name, keys))
        flat += [] if d is None else [d[k] for k in keys]
    return flat, (tuple(spec), out.input_type)


def _unflatten_hetero(flat, spec) -> HeteroSamplerOutput:
    fields, input_type = spec
    it = iter(flat)
    kw = {name: None if keys is None else {k: next(it) for k in keys}
          for name, keys in fields}
    return HeteroSamplerOutput(input_type=input_type, **kw)


class HeteroTieredTrainPipeline(_ColdStagePipeline):
    """The hetero two-stage pipeline (cf. ``glt_tpu``'s; see
    :class:`_ColdStagePipeline`): sample, then per tiered node type route
    and compact its cold requests (``cold_caps[t]`` slots a serving
    shard, by default twice the sampler's capacity of the type), gather
    them from the type's :class:`HostColdStore` on the staging thread
    while the previous batch trains (``train_step`` from
    :func:`make_hetero_tiered_train_step`).  ``max_cold_rows[t]`` is the
    largest cold count a serving shard saw, ``last_dropped[t]`` the
    latest batch's ``[S]`` drops, and :meth:`flush_dropped` their sum
    over the types and batches.

    On the card the stage is one CUDA graph a step (label
    ``hetero_tiered_stage``) and the main thread never syncs, as in
    :class:`TieredTrainPipeline`: the cold ids of every type go to
    pinned memory on a side stream after one event, the staging thread
    gathers each type into its pinned two-slot ring and copies the slot
    to the card on a copy stream, and the train step waits on that
    copy's event.
    """

    def __init__(self, sampler, train_step, feats, mesh: Mesh,
                 axis_name: Optional[str] = None, cold_caps=None,
                 stage_threads: Optional[int] = None, route: str = "auto",
                 hier_load_factor: Optional[float] = None):
        self.sampler = sampler
        self.train_step = train_step
        self.mesh = mesh
        self.axis_name = resolve_mesh_axes(mesh, axis_name)
        self.mesh_shape = mesh_axis_sizes(mesh, self.axis_name)
        self.route = route
        self.hier_load_factor = hier_load_factor
        self.tiered = {t: f for t, f in feats.items()
                       if isinstance(f, TieredShardedFeature)}
        self.types = sorted(self.tiered)
        cap_by_type = sampler.node_capacity
        self.cold_cap = {
            t: (2 * max(cap_by_type.get(t, 1), 1)
                if not cold_caps or t not in cold_caps
                else int(cold_caps[t])) for t in self.types}
        self._local = local_shard_range(mesh, self.axis_name)
        self.stores = {t: HostColdStore(f, shard_ids=self._local)
                       for t, f in self.tiered.items()}
        self._init_pools(stage_threads, "glt-hcold")
        self.max_cold_rows = {t: 0 for t in self.types}
        self.last_dropped = None
        self._spec = None
        self._stage_prog = _Graphed(self._stage_body, "hetero_tiered_stage")
        dev = mesh.device
        self._cuda = dev.type == "cuda"
        self._flip = 0
        if self._cuda:
            n = len(self._local)
            shape = {t: (n, self.cold_cap[t], self.stores[t].dim)
                     for t in self.types}
            dt = {t: torch_dtype(self.stores[t].dtype) for t in self.types}
            self._ids_host = {t: [torch.empty(
                (n, self.cold_cap[t]), dtype=torch.int32, pin_memory=True)
                for _ in range(2)] for t in self.types}
            self._rows_host = {t: [torch.empty(shape[t], dtype=dt[t],
                                               pin_memory=True)
                                   for _ in range(2)] for t in self.types}
            self._rows_dev = {t: [torch.empty(shape[t], dtype=dt[t],
                                              device=dev)
                                  for _ in range(2)] for t in self.types}
            self._h2d_done = [None, None]   # the ring slot's last H2D copy
            self._consumed = [None, None]   # the train that last read it
            self._fetch_stream = torch.cuda.Stream(dev)
            self._copy_stream = torch.cuda.Stream(dev)

    def _stage_body(self, seeds: torch.Tensor, key: torch.Tensor) -> tuple:
        """Stage 1: sample, then route and compact every tiered type's
        cold requests."""
        out = self.sampler.sample_from_nodes(seeds, key=key)
        flat, self._spec = _flatten_hetero(out)
        for t in self.types:
            f = self.tiered[t]
            req = route_cold_requests(
                list(out.node[t]), f.nodes_per_shard, f.hot_per_shard,
                f.num_shards, route=self.route, mesh_shape=self.mesh_shape,
                hier_load_factor=self.hier_load_factor)
            comp = [compact_cold_requests(r, self.cold_cap[t]) for r in req]
            flat += [torch.stack(x) for x in zip(*comp)]
        return tuple(flat)

    def _sample_and_stage(self, seeds, key: torch.Tensor):
        res = self._stage_prog(seeds_on_mesh(seeds, self.mesh), key)
        n = len(res) - 3 * len(self.types)
        out = _unflatten_hetero(res[:n], self._spec)
        slots, ids, dropped = {}, {}, {}
        for i, t in enumerate(self.types):
            slots[t], ids[t], dropped[t] = res[n + 3 * i: n + 3 * i + 3]
        self.last_dropped = dropped
        if dropped:
            self._record_dropped(torch.stack(list(dropped.values())).sum(0))
        return out, self._stage_cold_async(ids, slots)

    def _stage_cold_async(self, ids: dict, slots: dict):
        """Submit the host gather of every tiered type's ``ids``; the
        future gives ``(staged, copied, ring slot)``, ``staged`` the
        train step's ``{type: (rows, slots)}``."""
        flip = self._flip
        self._flip ^= 1
        lo, hi = self._local.start, self._local.stop
        local = {t: ids[t][lo:hi] for t in self.types}
        if self._cuda:
            routed = torch.cuda.Event()
            routed.record()
            with torch.cuda.stream(self._fetch_stream):
                self._fetch_stream.wait_event(routed)
                for t in self.types:
                    self._ids_host[t][flip].copy_(local[t], non_blocking=True)
                    local[t].record_stream(self._fetch_stream)
                fetched = torch.cuda.Event()
                fetched.record(self._fetch_stream)

        def work():
            if self._cuda:
                fetched.synchronize()
                if self._h2d_done[flip] is not None:
                    self._h2d_done[flip].synchronize()
            arrs, futs = {}, []
            for t in self.types:
                st = self.stores[t]
                if self._cuda:
                    req = self._ids_host[t][flip].numpy()
                    arr = self._rows_host[t][flip].numpy()
                else:
                    req = local[t].numpy()
                    # A fresh buffer a batch: torch.from_numpy aliases it.
                    arr = np.empty((len(self._local), self.cold_cap[t],
                                    st.dim), st.dtype)
                self.max_cold_rows[t] = max(
                    self.max_cold_rows[t], int((req >= 0).sum(axis=1).max()))
                for j, s in enumerate(self._local):
                    futs += st.serve_into(arr[j], s, req[j],
                                          pool=self._gather_pool)
                arrs[t] = arr
            for fu in futs:
                fu.result()
            self._maybe_flush_on_stage_thread()
            if not self._cuda:
                return ({t: (torch.from_numpy(arrs[t]), slots[t])
                         for t in self.types}, None, flip)
            with torch.cuda.device(self.mesh.device), torch.cuda.stream(
                    self._copy_stream):
                if self._consumed[flip] is not None:
                    self._copy_stream.wait_event(self._consumed[flip])
                for t in self.types:
                    self._rows_dev[t][flip].copy_(self._rows_host[t][flip],
                                                  non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            self._h2d_done[flip] = copied
            return ({t: (self._rows_dev[t][flip], slots[t])
                     for t in self.types}, copied, flip)
        return self._pool.submit(work)

    def _train_staged(self, state: TrainState, out, staged,
                      key: torch.Tensor):
        staged, copied, flip = staged
        if copied is not None:
            torch.cuda.current_stream(self.mesh.device).wait_event(copied)
        res = self.train_step(state, out, staged, key)
        if copied is not None:
            consumed = torch.cuda.Event()
            consumed.record()
            self._consumed[flip] = consumed
        return res


def init_hetero_dist_state(model: torch.nn.Module, tx: OptimizerFactory,
                           sampler, feats) -> TrainState:
    """State at step 0 for a hetero model (built and placed on the
    mesh's device by the caller; its parameters are shared by every
    shard) whose per-type input widths (``model.in_features``) must
    match ``feats`` (``node type -> ShardedFeature |
    TieredShardedFeature``, widths of the hot tier); the sampler's
    static shapes (:func:`~glt_tpu_torch.models.hetero_init_shapes`)
    are checked against them, then ``tx`` is built over the
    parameters."""
    x, _, _ = hetero_init_shapes(sampler, feats, _device_rows)
    widths = {t: int(v.shape[-1]) for t, v in x.items()}
    if widths != dict(model.in_features):
        raise ValueError(f"the model takes per-type widths "
                         f"{dict(model.in_features)}, the features have "
                         f"{widths}")
    return create_train_state(model, tx)
