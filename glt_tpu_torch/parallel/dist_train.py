"""The distributed training step: sample, gather and update over a mesh
of shards (cf. ``glt_tpu/parallel/dist_train.py``, the serial step
without tiers).

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

Left for later slices (ROADMAP queue A item 7): the tiered step and its
pipeline; the hetero steps.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..models.train import (OptimizerFactory, TrainState, _backward_and_step,
                            _check_model, _ScannedBlocks, create_train_state,
                            seed_cross_entropy)
from ..obs import metrics as _metrics
from ..ops.unique import unique_first_occurrence
from ..sampler.neighbor_sampler import hop_widths, max_sampled_nodes
from ..typing import PADDING_ID
from .dist_feature import (_dedup_scatter_back, exchange_gather,
                           exchange_gather_xy)
from .dist_sampler import (_LATER, dist_sample_multi_hop,
                           exchange_byte_model, seeds_on_mesh)
from .multihost import Mesh, mesh_axis_sizes, resolve_mesh_axes
from .sharding import ShardedFeature, ShardedGraph, check_on_mesh


def dist_step_byte_model(nodes_per_shard, num_shards, num_neighbors,
                         batch_size, frontier_cap, feature_dim, axis_name,
                         mesh_shape, route="auto", hier_load_factor=None,
                         elem_bytes=4):
    """Static per-device collective bytes of ONE distributed train step:
    :func:`~glt_tpu_torch.parallel.dist_sampler.exchange_byte_model` of
    each sampling hop (id request + fanout neighbor/edge-id payload)
    plus the feature+label exchange over the node capacity.  Returns
    ``{"ici": bytes, "dcn": bytes, "topology": "flat"}``; a 1-D mesh
    puts every byte under ICI (within a host).  The
    ``glt.dist.collective_bytes{axis=}`` counters add these per step.
    ``nodes_per_shard``, ``route``, ``mesh_shape`` and
    ``hier_load_factor`` size the 2-D mesh's hierarchical legs, which
    are not ported."""
    del nodes_per_shard, route, mesh_shape
    if not isinstance(axis_name, str) or hier_load_factor is not None:
        raise NotImplementedError(f"the 2-D mesh's byte model {_LATER}")
    h, c = 1, int(num_shards)
    widths = hop_widths(batch_size, list(num_neighbors), frontier_cap)
    node_cap = max_sampled_nodes(batch_size, list(num_neighbors),
                                 frontier_cap)
    ici = dcn = 0
    for w, fo in zip(widths, num_neighbors):
        i, d = exchange_byte_model("flat", h, c, w, 2 * fo,
                                   elem_bytes=elem_bytes)
        ici += i
        dcn += d
    i, d = exchange_byte_model("flat", h, c, node_cap, feature_dim + 1,
                               elem_bytes=elem_bytes)
    return {"ici": ici + i, "dcn": dcn + d, "topology": "flat"}


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
                     fused, fuse_xy, fused_frontier=False
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every shard's feature+label gather for its sampled node list: one
    routing plan and one payload collective when the id spaces agree
    (``fuse_xy``), else a feature and a label exchange, over one unique
    pass with ``dedup_gather``.  ``fused_frontier`` serves the FEATURE
    rows through kernel B3 (a label column is 1-wide).  Returns, per
    shard, ``(x, y)`` with ``y = -1`` at padding."""
    S = g.num_shards
    if fuse_xy:
        xy = exchange_gather_xy(node, rows, labels_blk, f.nodes_per_shard,
                                f.num_shards, dedup=dedup_gather,
                                route=route, fused=fused,
                                fused_frontier=fused_frontier)
    else:
        lab = [labels_blk[s][:, None].to(torch.int32) for s in range(S)]
        if dedup_gather:
            # ONE unique pass feeds both exchanges.
            un = [unique_first_occurrence(n) for n in node]
            uniq = [u.uniques for u in un]
            ux = exchange_gather(uniq, rows, f.nodes_per_shard,
                                 f.num_shards, route=route,
                                 fused_frontier=fused_frontier)
            uy = exchange_gather(uniq, lab, g.nodes_per_shard, S,
                                 route=route)
            xy = [(_dedup_scatter_back(ux[s], un[s].inverse),
                   _dedup_scatter_back(uy[s], un[s].inverse)[:, 0])
                  for s in range(S)]
        else:
            x = exchange_gather(node, rows, f.nodes_per_shard, f.num_shards,
                                route=route, fused_frontier=fused_frontier)
            y = exchange_gather(node, lab, g.nodes_per_shard, S,
                                route=route)
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
                      fused_frontier: bool = False):
    """The data half of one distributed step: shard ``s`` samples its
    row of ``seeds`` (``[S, B]`` on the mesh's device) with ``fold_in(
    key, s)``, then every shard gathers its node list's features and
    labels.  Returns ``(keys, outs, xy)``, per shard: the key, the
    :class:`~glt_tpu_torch.sampler.base.SamplerOutput` and ``(x, y)``."""
    S = g.num_shards
    keys = [trandom.fold_in(key, s) for s in range(S)]
    outs = dist_sample_multi_hop(
        g.indptr, g.indices, g.edge_ids, seeds, keys, num_neighbors,
        g.nodes_per_shard, S, frontier_cap, last_hop_dedup=last_hop_dedup,
        exchange_load_factor=exchange_load_factor, route=route,
        fused=fused)
    # Features and labels share one exchange when their id spaces agree
    # (always, for shard_graph/shard_feature over one node set).
    fuse_xy = (f.nodes_per_shard == g.nodes_per_shard
               and f.num_shards == S)
    xy = _gather_xy_local([o.node for o in outs], f.rows, labels, f, g,
                          dedup_gather, route, fused, fuse_xy,
                          fused_frontier)
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


def _check_step_args(g: ShardedGraph, f: ShardedFeature,
                     labels: torch.Tensor, mesh: Mesh, axis_name,
                     hier_load_factor):
    """The mesh and its axes, checked as the steps need them: a 1-D mesh
    of as many shards as the graph, every array on the mesh's device."""
    axis_name = resolve_mesh_axes(mesh, axis_name)
    mesh_shape = mesh_axis_sizes(mesh, axis_name)
    if hier_load_factor is not None:
        raise NotImplementedError(f"hier_load_factor: the hierarchical "
                                  f"routing {_LATER}")
    if g.num_shards != mesh.size:
        raise ValueError(f"a graph of {g.num_shards} shards on a mesh of "
                         f"{mesh.size}")
    check_on_mesh(mesh, indptr=g.indptr, indices=g.indices,
                  edge_ids=g.edge_ids, rows=f.rows, labels=labels)
    return axis_name, mesh_shape


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
    kernel B3.  The step carries its static byte model as
    ``step.collective_bytes`` and adds it to the
    ``glt.dist.collective_bytes{axis=}`` counters per call.
    """
    axis_name, mesh_shape = _check_step_args(g, f, labels, mesh, axis_name,
                                             hier_load_factor)
    dev = mesh.device
    byte_model = dist_step_byte_model(
        g.nodes_per_shard, g.num_shards, num_neighbors, batch_size,
        frontier_cap, f.rows.shape[-1], axis_name, mesh_shape, route=route)
    record_bytes = _byte_counters(byte_model)
    skw = dict(frontier_cap=frontier_cap, last_hop_dedup=last_hop_dedup,
               exchange_load_factor=exchange_load_factor,
               dedup_gather=dedup_gather, route=route, fused=fused,
               fused_frontier=fused_frontier)

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
    axis_name, mesh_shape = _check_step_args(g, f, labels, mesh, axis_name,
                                             hier_load_factor)
    dev = mesh.device
    S = g.num_shards
    byte_model = dist_step_byte_model(
        g.nodes_per_shard, S, num_neighbors, batch_size, frontier_cap,
        f.rows.shape[-1], axis_name, mesh_shape, route=route)
    record_bytes = _byte_counters(byte_model)
    skw = dict(frontier_cap=frontier_cap, last_hop_dedup=last_hop_dedup,
               exchange_load_factor=exchange_load_factor,
               dedup_gather=dedup_gather, route=route, fused=fused,
               fused_frontier=fused_frontier)
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


def init_dist_state(model: torch.nn.Module, tx: OptimizerFactory,
                    g: ShardedGraph, f: ShardedFeature,
                    num_neighbors: Sequence[int], batch_size: int,
                    frontier_cap: Optional[int] = None) -> TrainState:
    """State at step 0 for ``model`` (built and placed on the mesh's
    device by the caller; the parameters are shared by every shard):
    one forward over zero inputs of the step's static shapes checks the
    model against the feature width, then the optimizer ``tx`` is
    built over the parameters."""
    cap = max_sampled_nodes(batch_size, list(num_neighbors), frontier_cap)
    widths = hop_widths(batch_size, list(num_neighbors), frontier_cap)
    ecap = sum(w * fo for w, fo in zip(widths, num_neighbors))
    dev = f.rows.device
    x = torch.zeros((cap, f.rows.shape[-1]), dtype=f.rows.dtype, device=dev)
    ei = torch.full((2, ecap), PADDING_ID, dtype=torch.int32, device=dev)
    with torch.no_grad():
        model(x, ei, torch.zeros(ecap, dtype=torch.bool, device=dev))
    return create_train_state(model, tx)
