"""Supervised train and eval steps for sampled batches (cf.
``glt_tpu/models/train.py``).

The loss is masked cross-entropy over the **seed rows only**; seeds
occupy ``node[:batch_size]`` by the sampler's first-occurrence contract.

The canonical epoch loop is the *scanned* path
(:func:`make_scanned_node_train_step` + :func:`run_scanned_epoch`): per
block of ``G`` seed batches, sample -> gather -> fwd/bwd -> Adam for each
batch, with the losses, accuracies and overflow flags kept on the device
until the epoch's one host fetch.  Link prediction
(:func:`make_scanned_link_train_step` over :func:`link_seed_blocks`) and
induced-subgraph models (:func:`make_scanned_subgraph_train_step`) take
the same shape: ``G`` seed-edge or seed-node batches per call, the loss
a caller's function of the embeddings.  ``glt_tpu`` compiles the block
as one ``lax.scan`` program.  Here the "scan" is a Python loop over the
block's rows; on the card the node step captures it, once per block
shape, as one CUDA graph (:mod:`glt_tpu_torch.utils.graphs`) and
replays it (the first call at a shape runs eagerly and creates Adam's
state).  The link and subgraph steps run eagerly.

State: :class:`TrainState` holds the ``nn.Module``, its optimizer and a
host ``int`` step counter.  The model and optimizer update in place (a
torch optimizer owns its parameters; on the card :func:`adam` keeps
its step count on the device, ``capturable=True``); the steps return a
new ``TrainState`` with the advanced counter, as ``glt_tpu`` returns new
state.  Dropout draws from the threefry key ``fold_in(PRNGKey(
dropout_seed), step)``, the key ``glt_tpu`` uses; the scanned node step
folds in a device copy of the step counter that the block advances in
place, so a replayed block draws each step's own masks.  The global
torch generator is never used.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..data.feature import Feature
from ..data.feature_cache import FeatureCacheState, cache_gather
from ..loader.transform import Batch
from ..ops.dedup_gather import dedup_gather_rows
from ..ops.fused_frontier import fused_frontier
from ..ops.gather_cuda import gather_rows
from ..ops.unique import relabel_by_reference, unique_first_occurrence
from ..sampler.base import NodeSamplerInput
from ..typing import PADDING_ID
from ..utils.device import same_device
from ..utils.graphs import CapturedProgram

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def adam(learning_rate: float) -> OptimizerFactory:
    """``optax.adam(learning_rate)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8) as a factory: ``adam(lr)(model.parameters())``.
    Parameters on the card get ``capturable=True`` (the step count lives
    on the device), which a CUDA graph of the step needs."""
    def make(params):
        params = list(params)
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                capturable=any(p.is_cuda for p in params))
    return make


def create_train_state(model: nn.Module, tx: OptimizerFactory
                       ) -> TrainState:
    """State at step 0 for ``model`` (already on its device) and the
    optimizer that ``tx`` builds over its parameters."""
    return TrainState(model=model, optimizer=tx(model.parameters()), step=0)


def seed_cross_entropy(logits: torch.Tensor, y: torch.Tensor,
                       batch_size: int, node_mask: torch.Tensor):
    """Mean CE and accuracy over the valid seed rows (the first
    ``batch_size`` slots); 0 and 0 when none is valid."""
    sl = logits[:batch_size]
    sy = y[:batch_size]
    valid = (sy >= 0) & node_mask[:batch_size]
    sy_safe = torch.where(valid, sy, 0).long()
    ce = F.cross_entropy(sl.float(), sy_safe, reduction="none")
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, ce, 0).sum() / n
    acc = (valid & (sl.argmax(-1) == sy_safe)).sum() / n
    return loss, acc


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _backward_and_step(opt: torch.optim.Optimizer,
                       loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def _update(state: TrainState, loss: torch.Tensor) -> TrainState:
    _backward_and_step(state.optimizer, loss)
    return TrainState(state.model, state.optimizer, state.step + 1)


def make_train_step(batch_size: int, dropout_seed: int = 0) -> Callable:
    """``(state, batch) -> (state, loss, acc)``: one fwd/bwd and
    optimizer step on a :class:`~glt_tpu_torch.loader.transform.Batch`."""
    def train_step(state: TrainState, batch: Batch):
        base = trandom.PRNGKey(dropout_seed,
                               device=_model_device(state.model))
        logits = state.model(batch.x, batch.edge_index, batch.edge_mask,
                             dropout_key=trandom.fold_in(base, state.step))
        loss, acc = seed_cross_entropy(logits, batch.y, batch_size,
                                       batch.node_mask)
        return _update(state, loss), loss.detach(), acc

    return train_step


def make_gather_xy(id2index: Optional[torch.Tensor] = None,
                   dedup: bool = False, fused: bool = False) -> Callable:
    """``(rows, labels, out) -> (x, y)`` batch gather.

    ``id2index`` maps feature ROWS only; labels stay indexed by global
    id (``labels=None`` gives ``y = None``).  ``dedup=True`` fetches each
    unique row once and expands it to every position; ``fused=True``
    does the dedup and the gather in one launch of kernel B3
    (:func:`~glt_tpu_torch.ops.fused_frontier.fused_frontier`) and
    subsumes ``dedup``.  All three give the same ``x`` bit for bit.
    """
    def gather_xy(rows: torch.Tensor, labels: torch.Tensor, out):
        ids = out.node
        valid = ids >= 0
        gid = torch.where(valid, ids, 0)
        if fused:
            x = fused_frontier(rows, ids, id2index=id2index).features
        elif dedup:
            x = dedup_gather_rows(rows, ids, id2index=id2index)
        else:
            ridx = gid
            if id2index is not None:
                ridx = id2index[gid.clamp(max=id2index.shape[0] - 1).long()]
            x = gather_rows(rows, ridx.to(torch.int32).contiguous())
            x = torch.where(valid[:, None], x, 0)
        if labels is None:
            return x, None
        lab = labels[gid.clamp(max=labels.shape[0] - 1).long()]
        y = torch.where(valid, lab, PADDING_ID)
        return x, y

    return gather_xy


def make_cached_gather_xy(id2index: Optional[torch.Tensor] = None
                          ) -> Callable:
    """Dedup + cross-batch-cache batch gather: ``(cache, rows, labels,
    out) -> (cache, x, y)`` (cf. ``glt_tpu``'s ``make_cached_gather_xy``).

    The node list goes through one unique pass; the unique ids are
    served by :func:`~glt_tpu_torch.data.feature_cache.cache_gather`
    (hits from the device cache table, misses gathered from ``rows`` and
    inserted; kernel B2 reads both on the card), then the rows expand to
    every batch position.  ``x`` is bit-identical to
    :func:`make_gather_xy`'s as long as ``rows`` is unchanged.  The
    returned cache must feed the next call (its large tensors are
    updated in place; see :mod:`~glt_tpu_torch.data.feature_cache`).
    """
    def gather_xy(cache: FeatureCacheState, rows: torch.Tensor, labels,
                  out):
        ids = out.node.to(torch.int32)
        uniq, inv, _ = unique_first_occurrence(ids)

        def fetch(fids):
            v = fids >= 0
            fidx = torch.where(v, fids, 0)
            if id2index is not None:
                fidx = id2index[fidx.clamp(
                    max=id2index.shape[0] - 1).long()]
            got = gather_rows(rows, fidx.to(torch.int32).contiguous())
            return torch.where(v[:, None], got, 0)

        cache, urows = cache_gather(cache, uniq, fetch)
        x = urows[inv.clamp(0, max(inv.shape[0] - 1, 0)).long()]
        x = torch.where((inv >= 0)[:, None], x, 0)
        if labels is None:
            return cache, x, None
        valid = ids >= 0
        gid = torch.where(valid, ids, 0)
        y = torch.where(valid,
                        labels[gid.clamp(max=labels.shape[0] - 1).long()],
                        PADDING_ID)
        return cache, x, y

    return gather_xy


def _check_cache(feature_cache: FeatureCacheState, rows_dtype, dim: int
                 ) -> None:
    """The cache table's dtype and width must match the feature rows, or
    the cached ``x`` would change dtype against the uncached one."""
    if feature_cache.table.dtype != rows_dtype:
        raise ValueError(
            f"feature_cache dtype {feature_cache.table.dtype} != feature "
            f"rows dtype {rows_dtype}; build it with cache_init(..., "
            f"dtype=rows.dtype)")
    if feature_cache.dim != dim:
        raise ValueError(
            f"feature_cache dim {feature_cache.dim} != feature dim {dim}")


def make_eval_step(batch_size: int) -> Callable:
    """``(model, batch) -> (loss, acc)`` without dropout or gradients."""
    def eval_step(model: nn.Module, batch: Batch):
        with torch.no_grad():
            logits = model(batch.x, batch.edge_index, batch.edge_mask)
            return seed_cross_entropy(logits, batch.y, batch_size,
                                      batch.node_mask)

    return eval_step


def _device_rows(rows, dev: torch.device):
    """``(table, id2index)`` on ``dev`` from a Feature, a tensor or a
    host array; a Feature or tensor elsewhere raises."""
    if isinstance(rows, Feature):
        if not same_device(rows.device, dev):
            raise ValueError(f"features live on {rows.device}, the "
                             f"sampler's graph on {dev}")
        return rows.hot_rows, rows.id2index
    if isinstance(rows, torch.Tensor):
        if not same_device(rows.device, dev):
            raise ValueError(f"feature rows live on {rows.device}, the "
                             f"sampler's graph on {dev}")
        return rows, None
    return Feature(np.asarray(rows), device=dev).hot_rows, None


def _device_labels(labels, dev: torch.device) -> torch.Tensor:
    if isinstance(labels, torch.Tensor):
        if not same_device(labels.device, dev):
            raise ValueError(f"labels live on {labels.device}, the "
                             f"sampler's graph on {dev}")
        return labels.to(torch.int32)
    return torch.from_numpy(np.asarray(labels).astype(np.int32)).to(dev)


def make_scanned_node_train_step(sampler, rows, labels, batch_size: int,
                                 dropout_seed: int = 0, dedup: bool = False,
                                 fused_frontier: bool = False,
                                 feature_cache: Optional[FeatureCacheState]
                                 = None) -> Callable:
    """Train ``G`` consecutive seed batches per call.

    Returns ``step(state, seeds_blk, key) -> (state, losses [G], accs
    [G], overflows [G])`` where ``seeds_blk`` is a HOST ``[G, B]`` int
    array (-1 padded) and ``key`` a threefry key; batch ``g`` samples
    with ``split(key, G)[g]``.  The three outputs stay on the device.  A
    fully padded batch (decided from the host block, so no sync) is a
    no-op: parameters, optimizer state and the step counter do not move,
    and its loss, accuracy and flag are 0, as in ``glt_tpu``.
    ``overflows`` holds each batch's occupancy-cap flag (zeros for an
    uncapped sampler).

    ``dedup`` / ``fused_frontier`` pick the feature gather as in
    :func:`make_gather_xy`.  ``feature_cache`` (a
    :class:`~glt_tpu_torch.data.feature_cache.FeatureCacheState` of the
    rows' dtype and width) routes it through the cross-batch cache of
    :func:`make_cached_gather_xy` instead; the cache wins over
    ``fused_frontier``, as in ``glt_tpu``.  Its state carries across
    batches and blocks: ``step.feature_cache()`` reads it (the held
    tensors, updated in place) and ``step.set_feature_cache(state)``
    replaces it (the checkpoint-restore seam).  ``x`` is bit-identical
    on every route.  The model and optimizer must live on the sampler's
    graph device.

    On the card the block is one CUDA graph per real-batch pattern of
    the block (a ``[G]`` bool tuple), over static seed and key buffers:
    the first call at a pattern, or after the model's, the optimizer's
    or the cache's tensors were replaced, runs eagerly (it creates
    Adam's state); the next captures the block and every later call
    replays it.  On the CPU every call runs eagerly.
    """
    g = sampler.graph
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    labels_dev = _device_labels(labels, dev)
    gather_xy = make_gather_xy(id2index, dedup=dedup, fused=fused_frontier)
    cached_xy = make_cached_gather_xy(id2index)
    if feature_cache is not None:
        _check_cache(feature_cache, hot_rows.dtype, hot_rows.shape[-1])
    holder = {"cache": feature_cache}
    dropout_base = trandom.PRNGKey(dropout_seed, device=dev)
    # The step counter as the block sees it: set from state.step before
    # each call, advanced in place once per real batch.
    step_count = torch.zeros((), dtype=torch.int32, device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    programs = {}    # real pattern -> (CapturedProgram, bound storage)
    warm = {}        # real pattern -> bound storage of its eager call

    def block(model, opt, seeds, key, real):
        keys = trandom.split(key, len(real))
        cache = holder["cache"]
        losses, accs, ovfs = [], [], []
        for i, is_real in enumerate(real):
            if not is_real:
                losses.append(zero_f)
                accs.append(zero_f)
                ovfs.append(zero_i)
                continue
            out = sampler._sample_impl(g.indptr, g.indices,
                                       g.gather_edge_ids, seeds[i], keys[i])
            if cache is None:
                x, y = gather_xy(hot_rows, labels_dev, out)
            else:
                cache, x, y = cached_xy(cache, hot_rows, labels_dev, out)
            logits = model(x, torch.stack([out.row, out.col]),
                           out.edge_mask,
                           dropout_key=trandom.fold_in(dropout_base,
                                                       step_count))
            loss, acc = seed_cross_entropy(logits, y, batch_size,
                                           out.node_mask)
            _backward_and_step(opt, loss)
            step_count.add_(1)
            losses.append(loss.detach())
            accs.append(acc.to(torch.float32))
            ovfs.append(out.metadata["overflow"].to(torch.int32)
                        if out.metadata else zero_i)
        if cache is not None:
            # The new scalars go into the held state, so the next block
            # (or replay) reads them where it read the old ones.
            held = holder["cache"]
            for name in ("clock", "hits", "misses"):
                getattr(held, name).copy_(getattr(cache, name))
        return torch.stack(losses), torch.stack(accs), torch.stack(ovfs)

    def bound(state) -> tuple:
        """The storage a captured block reads and writes in place."""
        ts = list(state.model.parameters()) + [
            t for st in state.optimizer.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)]
        if holder["cache"] is not None:
            ts += list(holder["cache"])
        return tuple(t.data_ptr() for t in ts)

    def replayed(state, blk, key, real):
        """The block through its CUDA graph, or ``None`` when this call
        runs eagerly (the first at its pattern and storage)."""
        now = bound(state)
        entry = programs.get(real)
        if entry is not None and entry[1] == now:
            return entry[0](blk, key)
        programs.pop(real, None)
        if warm.get(real) != now:
            return None
        model, opt = state.model, state.optimizer
        prog = CapturedProgram(
            lambda seeds, k: block(model, opt, seeds, k, real),
            [torch.from_numpy(blk).to(dev), key.clone()], warmup=0)
        programs[real] = (prog, now)
        return prog.replay()

    def step(state: TrainState, seeds_blk, key: torch.Tensor):
        if isinstance(seeds_blk, torch.Tensor):
            raise TypeError("seeds_blk must be a host array: the "
                            "padded-batch no-op is decided on the host")
        _check_model(state, dev)
        blk = np.ascontiguousarray(np.asarray(seeds_blk), dtype=np.int32)
        real = tuple(bool(r) for r in (blk >= 0).any(axis=1))
        step_count.fill_(state.step)
        outs = None
        if dev.type == "cuda" and any(real):
            outs = replayed(state, blk, key, real)
            if outs is not None:
                outs = tuple(t.clone() for t in outs)
        if outs is None:
            outs = block(state.model, state.optimizer,
                         torch.from_numpy(blk).to(dev), key, real)
            if dev.type == "cuda":
                warm[real] = bound(state)
        state = TrainState(state.model, state.optimizer,
                           state.step + sum(real))
        return (state,) + tuple(outs)

    def set_feature_cache(new_cache: FeatureCacheState) -> None:
        # Checkpoint-restore seam: a resumed run pushes its restored
        # cache in before the first block; a captured block bound to the
        # old tensors is captured again after one eager call.
        _check_cache(new_cache, hot_rows.dtype, hot_rows.shape[-1])
        holder["cache"] = new_cache

    step.feature_cache = lambda: holder["cache"]
    step.set_feature_cache = set_feature_cache
    return step


def _check_model(state: TrainState, dev: torch.device) -> None:
    if not same_device(_model_device(state.model), dev):
        raise ValueError(f"the model lives on {_model_device(state.model)}, "
                         f"the sampler's graph on {dev}")


def _host_block(blk, dev: torch.device) -> torch.Tensor:
    """A host block on ``dev`` in the dtype ``jnp.asarray`` gives it
    (64-bit off): integers as int32, float64 as float32."""
    a = np.asarray(blk)
    if a.dtype.kind in "iu":
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def make_scanned_link_train_step(sampler, rows, loss_fn, neg_sampling=None
                                 ) -> Callable:
    """Train ``G`` consecutive seed-edge batches per call.

    Per batch: negatives (strict trials, then padding), the multi-hop
    sample of the seed union
    (:meth:`~glt_tpu_torch.sampler.NeighborSampler.sample_from_edge_tensors`),
    the feature gather (kernel B2 on the card), the forward,
    ``loss_fn(z, meta)`` on the node embeddings ``z`` and the batch
    metadata (``edge_label_index`` and ``edge_label`` in binary mode,
    the triplet indices in triplet mode), backward and the optimizer
    step.

    Returns ``step(state, src_blk, dst_blk, key) -> (state, losses
    [G])``: ``src_blk``/``dst_blk`` are host ``[G, q]`` id blocks, -1
    padded (:func:`link_seed_blocks`), and batch ``g`` uses ``split(key,
    G)[g]``.  As in ``glt_tpu``, a fully padded batch is not skipped: in
    binary mode it still draws ``q * amount`` negatives and trains on
    them, and the optimizer steps.  ``G`` is the blocks' leading axis
    (``glt_tpu``'s ``group``).
    """
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    gather_xy = make_gather_xy(id2index)

    def step(state: TrainState, src_blk, dst_blk, key: torch.Tensor):
        _check_model(state, dev)
        src, dst = _host_block(src_blk, dev), _host_block(dst_blk, dev)
        keys = trandom.split(key, src.shape[0])
        losses = []
        for i in range(src.shape[0]):
            out = sampler.sample_from_edge_tensors(src[i], dst[i],
                                                   neg_sampling, keys[i])
            x, _ = gather_xy(hot_rows, None, out)
            z = state.model(x, torch.stack([out.row, out.col]),
                            out.edge_mask)
            loss = loss_fn(z, out.metadata)
            state = _update(state, loss)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return step


def make_scanned_subgraph_train_step(sampler, rows, loss_fn,
                                     max_degree: int) -> Callable:
    """Train a block of induced-subgraph batches per call.

    Per batch: hop expansion and the induced extract
    (:meth:`~glt_tpu_torch.sampler.NeighborSampler.subgraph`), the
    feature gather (kernel B2 on the card), the forward,
    ``loss_fn(z, out, y)`` on the node embeddings, the batch's
    :class:`~glt_tpu_torch.sampler.SamplerOutput` (graph-direction COO)
    and its label row ``y``, backward and the optimizer step.  Seeds are
    deduplicated in the node list, so ``out.metadata["seed_index"]``
    (``[B]`` local index of each seed slot, -1 for padding) locates
    them.

    Returns ``step(state, seeds_blk, y_blk, key) -> (state, losses
    [G])`` over host blocks ``seeds_blk [G, B]`` (-1 padded) and
    ``y_blk [G, ...]``; batch ``g`` uses ``split(key, G)[g]``, and a
    fully padded batch still steps the optimizer, as in ``glt_tpu``.
    """
    if not sampler.last_hop_dedup:
        raise ValueError(
            "scanned subgraph step requires last_hop_dedup=True")
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    gather_xy = make_gather_xy(id2index)
    b = sampler.batch_size

    def step(state: TrainState, seeds_blk, y_blk, key: torch.Tensor):
        _check_model(state, dev)
        seeds, ys = _host_block(seeds_blk, dev), _host_block(y_blk, dev)
        keys = trandom.split(key, seeds.shape[0])
        losses = []
        for i in range(seeds.shape[0]):
            out = sampler.subgraph(NodeSamplerInput(seeds[i]),
                                   max_degree=max_degree, key=keys[i])
            out.metadata = {"seed_index": relabel_by_reference(
                out.node[:b], seeds[i])}
            x, _ = gather_xy(hot_rows, None, out)
            z = state.model(x, torch.stack([out.row, out.col]),
                            out.edge_mask)
            loss = loss_fn(z, out, ys[i])
            state = _update(state, loss)
            losses.append(loss.detach())
        return state, torch.stack(losses)

    return step


def link_seed_blocks(edge_index, batch_size: int, group: int, rng):
    """Shuffled seed-edge ``[G, q]`` src/dst blocks, -1 padded: yields
    ``(src_blk, dst_blk, n_batches)`` (the epoch loop of
    :func:`make_scanned_link_train_step`); the last block may carry
    fully padded batches."""
    e = np.asarray(edge_index)
    perm = rng.permutation(e.shape[1])
    src, dst = e[0][perm], e[1][perm]
    per_block = batch_size * group
    for lo in range(0, src.shape[0], per_block):
        sb = np.full((group, batch_size), -1, np.int64)
        db = np.full((group, batch_size), -1, np.int64)
        chunk_s = src[lo: lo + per_block]
        m = chunk_s.shape[0]
        sb.reshape(-1)[:m] = chunk_s
        db.reshape(-1)[:m] = dst[lo: lo + per_block]
        yield sb, db, -(-m // batch_size)


def node_seed_blocks(train_idx, batch_size: int, group: int, rng):
    """Shuffled ``[G, B]`` seed blocks, -1 padded (the epoch loop of
    :func:`make_scanned_node_train_step`)."""
    ids = np.asarray(train_idx)[rng.permutation(len(train_idx))]
    per_block = batch_size * group
    for lo in range(0, len(ids), per_block):
        blk = np.full((group, batch_size), -1, np.int64)
        chunk = ids[lo: lo + per_block]
        blk.reshape(-1)[: chunk.shape[0]] = chunk
        yield blk


def run_scanned_epoch(step, state: TrainState, train_idx, batch_size: int,
                      group: int, rng, base_key: torch.Tensor,
                      start_block: int = 0, on_block=None):
    """One epoch through a scanned train step.

    Shuffles ``train_idx`` into ``[G, B]`` blocks and drives ``step`` per
    block under ``fold_in(base_key, i)``; the metrics come back in ONE
    device->host copy at the end.  Returns ``(state, losses [n_real],
    accs [n_real], overflow_count)`` as host numpy.

    ``start_block``/``on_block`` are the resume seam: the first
    ``start_block`` blocks are skipped without disturbing the key
    schedule (block ``i`` always trains under ``fold_in(base_key, i)``),
    and ``on_block(state, i)`` fires after block ``i``'s device work has
    finished.
    """
    n_real = -(-len(train_idx) // batch_size)
    n_real = max(0, n_real - int(start_block) * group)
    losses, accs, ovfs = [], [], []
    blocks = node_seed_blocks(train_idx, batch_size, group, rng)
    for i, blk in enumerate(blocks):
        if i < start_block:
            continue
        state, ls, ac, ov = step(state, blk, trandom.fold_in(base_key, i))
        losses.append(ls)
        accs.append(ac)
        ovfs.append(ov)
        if on_block is not None:
            if ls.is_cuda:
                torch.cuda.synchronize(ls.device)
            on_block(state, i)
    if not losses:
        empty = np.zeros((0,), np.float32)
        return state, empty, empty, 0
    n = sum(ls.shape[0] for ls in losses)
    host = torch.cat([torch.cat(losses), torch.cat(accs),
                      torch.cat(ovfs).to(torch.float32)]).cpu().numpy()
    return (state, host[:n][:n_real], host[n: 2 * n][:n_real],
            int(host[2 * n:].sum()))
