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
as one ``lax.scan`` program; here the "scan" is a Python loop over the
block's rows, launched eagerly (a CUDA graph per block is later work).

State: :class:`TrainState` holds the ``nn.Module``, its optimizer and a
host ``int`` step counter.  The model and optimizer update in place (a
torch optimizer owns its parameters); the steps return a new
``TrainState`` with the advanced counter, as ``glt_tpu`` returns new
state.  Dropout draws from a ``torch.Generator`` seeded per step from
``fold_in(PRNGKey(dropout_seed), step)``, the key ``glt_tpu`` uses; the
global torch generator is never used.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..data.feature import Feature
from ..loader.transform import Batch
from ..ops.dedup_gather import dedup_gather_rows
from ..ops.fused_frontier import fused_frontier
from ..ops.gather_cuda import gather_rows
from ..ops.unique import relabel_by_reference
from ..sampler.base import NodeSamplerInput
from ..typing import PADDING_ID
from ..utils.device import same_device

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]


class TrainState(NamedTuple):
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int


def adam(learning_rate: float) -> OptimizerFactory:
    """``optax.adam(learning_rate)`` with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8) as a factory: ``adam(lr)(model.parameters())``."""
    def make(params):
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
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


def _seed_dropout(gen: torch.Generator, dropout_seed: int, step: int
                  ) -> torch.Generator:
    """Seed ``gen`` with the words of ``fold_in(PRNGKey(dropout_seed),
    step)``, hashed on the host: one stream per step.  (The CPU
    generator keeps only a seed's low 32 bits, so the step must reach
    them.)"""
    k = trandom.fold_in(trandom.PRNGKey(dropout_seed, device="cpu"), step)
    gen.manual_seed((int(k[0]) << 32) | int(k[1]))
    return gen


def _update(state: TrainState, loss: torch.Tensor) -> TrainState:
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return TrainState(state.model, opt, state.step + 1)


def make_train_step(batch_size: int, dropout_seed: int = 0) -> Callable:
    """``(state, batch) -> (state, loss, acc)``: one fwd/bwd and
    optimizer step on a :class:`~glt_tpu_torch.loader.transform.Batch`."""
    def train_step(state: TrainState, batch: Batch):
        gen = torch.Generator(device=_model_device(state.model))
        logits = state.model(batch.x, batch.edge_index, batch.edge_mask,
                             generator=_seed_dropout(gen, dropout_seed,
                                                     state.step))
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
                                 feature_cache=None) -> Callable:
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
    :func:`make_gather_xy`.  The model and optimizer must live on the
    sampler's graph device.  ``feature_cache`` is not ported yet.
    """
    if feature_cache is not None:
        raise NotImplementedError(
            "the cross-batch feature cache is not ported yet")
    g = sampler.graph
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    labels_dev = _device_labels(labels, dev)
    gather_xy = make_gather_xy(id2index, dedup=dedup, fused=fused_frontier)
    gen = torch.Generator(device=dev)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)

    def step(state: TrainState, seeds_blk, key: torch.Tensor):
        if isinstance(seeds_blk, torch.Tensor):
            raise TypeError("seeds_blk must be a host array: the "
                            "padded-batch no-op is decided on the host")
        _check_model(state, dev)
        blk = np.asarray(seeds_blk)
        real = (blk >= 0).any(axis=1)
        seeds_dev = torch.from_numpy(
            np.ascontiguousarray(blk, dtype=np.int32)).to(dev)
        keys = trandom.split(key, blk.shape[0])
        losses, accs, ovfs = [], [], []
        for i in range(blk.shape[0]):
            if not real[i]:
                losses.append(zero_f)
                accs.append(zero_f)
                ovfs.append(zero_i)
                continue
            out = sampler._sample_impl(g.indptr, g.indices,
                                       g.gather_edge_ids, seeds_dev[i],
                                       keys[i])
            x, y = gather_xy(hot_rows, labels_dev, out)
            edge_index = torch.stack([out.row, out.col])
            logits = state.model(x, edge_index, out.edge_mask,
                                 generator=_seed_dropout(gen, dropout_seed,
                                                         state.step))
            loss, acc = seed_cross_entropy(logits, y, batch_size,
                                           out.node_mask)
            state = _update(state, loss)
            losses.append(loss.detach())
            accs.append(acc.to(torch.float32))
            ovfs.append(out.metadata["overflow"].to(torch.int32)
                        if out.metadata else zero_i)
        return (state, torch.stack(losses), torch.stack(accs),
                torch.stack(ovfs))

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
