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
a caller's function of the embeddings; so do hetero graphs
(:func:`make_scanned_hetero_train_step`, per-type inputs and the loss
on the seed type).  ``glt_tpu`` compiles the block
as one ``lax.scan`` program.  Here the "scan" is a Python loop over the
block's rows; on the card the node step captures it, once per block
shape, as one CUDA graph (:mod:`glt_tpu_torch.utils.graphs`) and
replays it (the first call at a shape runs eagerly and creates Adam's
state), and so do the hetero, link and subgraph steps (the last two
keyed by the block's shape alone: a padded batch still trains there).

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

Observability (:mod:`glt_tpu_torch.obs`, as in ``glt_tpu``): the epoch
driver counts ``glt.train.steps``/``glt.train.epochs``, times
``glt.train.block_ms``, opens the spans ``train.scanned_epoch`` and
``train.scanned_block_dispatch`` on the host, feeds the profiler's spike
detector, publishes the device gauges and records a ``train.epoch``
flight event per epoch; captures count under ``scanned_node_step``,
``scanned_hetero_step``, ``scanned_link_step`` and
``scanned_subgraph_step``.  Nothing inside a captured block opens a span
or touches a metric: a replay runs no Python.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..data.feature import Feature
from ..data.feature_cache import FeatureCacheState, cache_gather
from ..obs import compilewatch as _compilewatch
from ..obs import device as _device
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs import profiler as _profiler
from ..obs.trace import span as _span
from ..ops.dedup_gather import dedup_gather_rows
from ..ops.fused_frontier import fused_frontier
from ..ops.gather_cuda import gather_rows
from ..ops.unique import relabel_by_reference, unique_first_occurrence
from ..sampler.base import NodeSamplerInput
from ..typing import PADDING_ID, reverse_edge_type
from ..utils.device import same_device
from ..utils.graphs import CapturedProgram

OptimizerFactory = Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]

# Epoch-driver instrumentation: only the HOST loop is instrumented.
_M_STEPS = _metrics.counter(
    "glt.train.steps", "train steps dispatched by the epoch drivers")
_M_EPOCHS = _metrics.counter(
    "glt.train.epochs", "scanned epochs driven")
_M_BLOCK_MS = _metrics.histogram(
    "glt.train.block_ms",
    "wall per [G, B] block: dispatch + (when a hook syncs) device wait")


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
    for p in model.parameters():
        _device.register_owner("params", p)
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


def _targets(batch, target_type: Optional[str]):
    """``(y, node_mask)`` of the supervised rows: the batch's, or a
    hetero batch's ``target_type`` entries."""
    if target_type is None:
        return batch.y, batch.node_mask
    return batch.y[target_type], batch.node_mask[target_type]


def make_train_step(batch_size: int, dropout_seed: int = 0,
                    target_type: Optional[str] = None) -> Callable:
    """``(state, batch) -> (state, loss, acc)``: one fwd/bwd and
    optimizer step on a :class:`~glt_tpu_torch.loader.transform.Batch`,
    or with ``target_type`` on a
    :class:`~glt_tpu_torch.loader.transform.HeteroBatch` (the loss over
    that type's seed rows)."""
    def train_step(state: TrainState, batch):
        base = trandom.PRNGKey(dropout_seed,
                               device=_model_device(state.model))
        logits = state.model(batch.x, batch.edge_index, batch.edge_mask,
                             dropout_key=trandom.fold_in(base, state.step))
        y, node_mask = _targets(batch, target_type)
        loss, acc = seed_cross_entropy(logits, y, batch_size, node_mask)
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
        if fused:
            x = fused_frontier(rows, ids, id2index=id2index).features
        elif dedup:
            x = dedup_gather_rows(rows, ids, id2index=id2index)
        else:
            x = gather_ids(rows, ids, id2index)
        return x, None if labels is None else gather_labels(labels, ids)

    return gather_xy


def gather_ids(rows: torch.Tensor, ids: torch.Tensor,
               id2index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rows`` of the global ``ids`` (through ``id2index`` when given),
    zeros on padding: kernel B2 for CUDA rows."""
    valid = ids >= 0
    ridx = torch.where(valid, ids, 0)
    if id2index is not None:
        ridx = id2index[ridx.clamp(max=id2index.shape[0] - 1).long()]
    x = gather_rows(rows, ridx.to(torch.int32).contiguous())
    return torch.where(valid[:, None], x, 0)


def gather_labels(labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``labels`` of the global ``ids``, -1 on padding."""
    valid = ids >= 0
    gid = torch.where(valid, ids, 0)
    lab = labels[gid.clamp(max=labels.shape[0] - 1).long()]
    return torch.where(valid, lab, PADDING_ID)


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

        cache, urows = cache_gather(
            cache, uniq, lambda fids: gather_ids(rows, fids, id2index))
        x = urows[inv.clamp(0, max(inv.shape[0] - 1, 0)).long()]
        x = torch.where((inv >= 0)[:, None], x, 0)
        return cache, x, (None if labels is None
                          else gather_labels(labels, ids))

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


def make_eval_step(batch_size: int,
                   target_type: Optional[str] = None) -> Callable:
    """``(model, batch) -> (loss, acc)`` without dropout or gradients
    (``target_type`` as in :func:`make_train_step`)."""
    def eval_step(model: nn.Module, batch):
        with torch.no_grad():
            logits = model(batch.x, batch.edge_index, batch.edge_mask)
            y, node_mask = _targets(batch, target_type)
            return seed_cross_entropy(logits, y, batch_size, node_mask)

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


def _host_array(blk) -> np.ndarray:
    """A host block in the dtype ``jnp.asarray`` gives it (64-bit off):
    integers as int32, float64 as float32.  A tensor raises: the
    block's pattern (its real batches, its shapes) is decided on the
    host, from the array the caller holds."""
    if isinstance(blk, torch.Tensor):
        raise TypeError("blocks must be host arrays: the block's pattern "
                        "is decided on the host")
    a = np.asarray(blk)
    if a.dtype.kind in "iub":
        a = a.astype(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


class _ScannedBlocks:
    """A scanned train step over host blocks with a leading ``[G]`` axis:
    ``step(state, *blocks, key) -> (state, *outputs)``.

    ``block(model, opt, blocks, key, real)`` trains the block's batches
    (``blocks``: the host blocks as device tensors; ``real``: a ``[G]``
    bool tuple) and advances ``step_count`` (when given) in place per
    real batch; ``step_count`` is set from ``state.step`` before each
    call, and the returned state's counter moves by ``sum(real)``.  With
    ``skip_padded`` a batch whose first block holds no id ``>= 0`` in
    any position (all axes but the first) is not real: the block skips
    it, so a fully padded batch is a no-op without a sync.  Without it
    every batch is real (steps where a padded batch still trains), and
    the pattern is the blocks' shapes alone.

    On the card the block is one CUDA graph per pattern (the blocks'
    shapes and ``real``) over static block and key buffers, filled
    through pinned memory: the first call at a pattern, or after the
    tensors it reads in place (the model's, the optimizer's, ``held()``)
    were replaced, runs eagerly (it creates Adam's state); the next
    captures the block and every later call replays it.  A failed
    capture raises.  On the CPU every call runs eagerly.  Captures count
    under the compilewatch label ``program``.
    """

    def __init__(self, dev: torch.device, block: Callable,
                 step_count: Optional[torch.Tensor], program: str,
                 held: Callable[[], tuple] = tuple,
                 skip_padded: bool = True):
        self.dev = dev
        self.program = program
        self.block = block
        self.step_count = step_count
        self.held = held
        self.skip_padded = skip_padded
        self._programs = {}  # pattern -> (CapturedProgram, storage)
        self._warm = {}      # pattern -> storage of its eager call

    def _bound(self, state) -> tuple:
        """The storage a captured block reads and writes in place."""
        ts = list(state.model.parameters()) + [
            t for st in state.optimizer.state.values() for t in st.values()
            if isinstance(t, torch.Tensor)] + list(self.held())
        return tuple(t.data_ptr() for t in ts)

    def _replayed(self, state, blks, key, pattern, real):
        """The block through its CUDA graph, or ``None`` when this call
        runs eagerly (the first at its pattern and storage)."""
        now = self._bound(state)
        entry = self._programs.get(pattern)
        if entry is not None and entry[1] == now:
            return entry[0](*blks, key)
        self._programs.pop(pattern, None)
        if self._warm.get(pattern) != now:
            return None
        model, opt = state.model, state.optimizer
        prog = CapturedProgram(
            lambda *ins: self.block(model, opt, ins[:-1], ins[-1], real),
            [torch.from_numpy(b).to(self.dev) for b in blks] + [key.clone()],
            warmup=0)
        self._programs[pattern] = (prog, now)
        return prog.replay()

    def __call__(self, state: TrainState, *args):
        *blocks, key = args
        dev = self.dev
        _check_model(state, dev)
        blks = [_host_array(b) for b in blocks]
        g = blks[0].shape[0]
        if self.skip_padded:
            real = tuple(bool(r) for r in
                         (blks[0].reshape(g, -1) >= 0).any(axis=1))
        else:
            real = (True,) * g
        pattern = (tuple(b.shape for b in blks), real)
        if self.step_count is not None:
            self.step_count.fill_(state.step)
        outs = None
        if dev.type == "cuda" and any(real):
            with _compilewatch.label(self.program):
                outs = self._replayed(state, blks, key, pattern, real)
            if outs is not None:
                outs = tuple(t.clone() for t in outs)
        if outs is None:
            outs = self.block(state.model, state.optimizer,
                              tuple(torch.from_numpy(b).to(dev)
                                    for b in blks), key, real)
            if dev.type == "cuda":
                self._warm[pattern] = self._bound(state)
        state = TrainState(state.model, state.optimizer,
                           state.step + sum(real))
        return (state,) + tuple(outs)


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

    def block(model, opt, blocks, key, real):
        seeds, = blocks
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

    step = _ScannedBlocks(dev, block, step_count, "scanned_node_step",
                          lambda: (() if holder["cache"] is None
                                   else tuple(holder["cache"])))

    def set_feature_cache(new_cache: FeatureCacheState) -> None:
        # Checkpoint-restore seam: a resumed run pushes its restored
        # cache in before the first block; a captured block bound to the
        # old tensors is captured again after one eager call.
        _check_cache(new_cache, hot_rows.dtype, hot_rows.shape[-1])
        holder["cache"] = new_cache

    step.feature_cache = lambda: holder["cache"]
    step.set_feature_cache = set_feature_cache
    return step


def hetero_init_shapes(sampler, feats, rows_of):
    """Zero-filled ``(x, edge_index, edge_mask)`` of a hetero sampler's
    static output shapes: ``x[t]`` ``[capacity_t, d_t]`` for each type
    with features (``rows_of(feats[t])`` gives the ``[N_t, d_t]`` rows
    whose width and dtype the dummy takes), and per reversed edge type
    a ``[2, edges]`` -1 COO and an all-False mask."""
    capacity = sampler.node_capacity
    widths = sampler.hop_widths
    dev = sampler.device
    x = {}
    for t in feats:
        if t in capacity:
            rows = rows_of(feats[t])
            x[t] = torch.zeros((max(capacity[t], 1), rows.shape[-1]),
                               dtype=rows.dtype, device=dev)
    ei, mask = {}, {}
    for et in sampler.edge_types:
        ecap = max(sum(widths[hop][et[0]] * f
                       for hop, f in enumerate(sampler.num_neighbors[et])
                       if f > 0), 1)
        rev = reverse_edge_type(et)
        ei[rev] = torch.full((2, ecap), PADDING_ID, dtype=torch.int32,
                             device=dev)
        mask[rev] = torch.zeros((ecap,), dtype=torch.bool, device=dev)
    return x, ei, mask


def init_hetero_state(model: nn.Module, tx: OptimizerFactory, sampler,
                      feats) -> TrainState:
    """State at step 0 for a hetero model whose per-type input widths
    (``model.in_features``) must match ``feats`` (``node_type -> Feature
    | [N_t, d] array``); the torch model is built with its widths, so
    no dummy forward runs, but the sampler's static shapes
    (:func:`hetero_init_shapes`) are checked against them."""
    x, _, _ = hetero_init_shapes(
        sampler, feats, lambda f: f.hot_rows if isinstance(f, Feature)
        else np.asarray(f))
    widths = {t: int(v.shape[-1]) for t, v in x.items()}
    if widths != dict(model.in_features):
        raise ValueError(f"the model takes per-type widths "
                         f"{dict(model.in_features)}, the features have "
                         f"{widths}")
    return create_train_state(model, tx)


def make_scanned_hetero_train_step(sampler, feats, labels, batch_size: int,
                                   dropout_seed: int = 0) -> Callable:
    """Train ``G`` consecutive hetero seed batches per call (cf.
    ``glt_tpu``'s ``make_scanned_hetero_train_step``).

    Per batch: the multi-type multi-hop sample
    (:class:`~glt_tpu_torch.sampler.HeteroNeighborSampler`; kernel B1
    once per (hop, edge type) with a nonzero width), each node type's
    feature gather (kernel B2 once per type with features), the target
    type's label gather, fwd/bwd and the optimizer step.

    Args:
      sampler: a :class:`~glt_tpu_torch.sampler.HeteroNeighborSampler`.
      feats: ``node_type -> Feature | [N_t, d] array``, wholly on the
        sampler's device.
      labels: ``node_type -> [N_t]`` int labels; the sampler's
        ``input_type`` entry is the supervised target.

    Returns ``step(state, seeds_blk, key) -> (state, losses [G], accs
    [G])`` over a HOST ``[G, B]`` block (-1 padded); batch ``g`` samples
    with ``split(key, G)[g]`` and drops out with ``fold_in(PRNGKey(
    dropout_seed), step)``.  A fully padded batch is a no-op with loss
    and accuracy 0.  On the card the block is one CUDA graph per
    real-batch pattern, as the node step's; on the CPU it runs eagerly.
    """
    dev = sampler.device
    tgt = sampler.input_type

    def resident(f):
        if isinstance(f, Feature) and f.hot_count < f.size:
            raise ValueError(
                "the scanned hetero step needs device-resident features")
        return _device_rows(f, dev)

    rows = {t: resident(f) for t, f in feats.items()}
    labels_tgt = _device_labels(labels[tgt], dev)
    graph_arrays = sampler.graph_arrays()
    widths, cap = sampler._widths, sampler._capacity
    dropout_base = trandom.PRNGKey(dropout_seed, device=dev)
    step_count = torch.zeros((), dtype=torch.int32, device=dev)
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
            out = sampler._sample_impl(widths, cap, graph_arrays,
                                       {tgt: seeds[i]}, keys[i])
            x = {t: gather_ids(rows[t][0], node, rows[t][1])
                 for t, node in out.node.items() if t in rows}
            y = gather_labels(labels_tgt, out.node[tgt])
            edge_index = {et: torch.stack([out.row[et], out.col[et]])
                          for et in out.row}
            logits = model(x, edge_index, out.edge_mask,
                           dropout_key=trandom.fold_in(dropout_base,
                                                       step_count))
            loss, acc = seed_cross_entropy(logits, y, batch_size,
                                           out.node_mask[tgt])
            _backward_and_step(opt, loss)
            step_count.add_(1)
            losses.append(loss.detach())
            accs.append(acc.to(torch.float32))
        return torch.stack(losses), torch.stack(accs)

    return _ScannedBlocks(dev, block, step_count, "scanned_hetero_step")


def _check_model(state: TrainState, dev: torch.device) -> None:
    if not same_device(_model_device(state.model), dev):
        raise ValueError(f"the model lives on {_model_device(state.model)}, "
                         f"the sampler's graph on {dev}")


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

    On the card the block is one CUDA graph per block shape, over static
    ``[G, q]`` src and dst buffers and a key buffer: the first call at a
    shape runs eagerly (it creates Adam's state and the lazily built
    graph views), the next captures the block, and every later call
    replays it.  On the CPU every call runs eagerly.
    """
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    gather_xy = make_gather_xy(id2index)
    if neg_sampling is not None:
        neg_sampling.cdf(dev)   # a weight's cdf reaches the device here

    def block(model, opt, blocks, key, real):
        src, dst = blocks
        keys = trandom.split(key, len(real))
        losses = []
        for i in range(len(real)):
            out = sampler.sample_from_edge_tensors(src[i], dst[i],
                                                   neg_sampling, keys[i])
            x, _ = gather_xy(hot_rows, None, out)
            z = model(x, torch.stack([out.row, out.col]), out.edge_mask)
            loss = loss_fn(z, out.metadata)
            _backward_and_step(opt, loss)
            losses.append(loss.detach())
        return (torch.stack(losses),)

    return _ScannedBlocks(dev, block, None, "scanned_link_step",
                          skip_padded=False)


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
    fully padded batch still steps the optimizer, as in ``glt_tpu``.  On
    the card the block is one CUDA graph per block shape over static
    seed, label and key buffers, as the link step's.
    """
    if not sampler.last_hop_dedup:
        raise ValueError(
            "scanned subgraph step requires last_hop_dedup=True")
    dev = sampler.device
    hot_rows, id2index = _device_rows(rows, dev)
    gather_xy = make_gather_xy(id2index)
    b = sampler.batch_size

    def block(model, opt, blocks, key, real):
        seeds, ys = blocks
        keys = trandom.split(key, len(real))
        losses = []
        for i in range(len(real)):
            out = sampler.subgraph(NodeSamplerInput(seeds[i]),
                                   max_degree=max_degree, key=keys[i])
            out.metadata = {"seed_index": relabel_by_reference(
                out.node[:b], seeds[i])}
            x, _ = gather_xy(hot_rows, None, out)
            z = model(x, torch.stack([out.row, out.col]), out.edge_mask)
            loss = loss_fn(z, out, ys[i])
            _backward_and_step(opt, loss)
            losses.append(loss.detach())
        return (torch.stack(losses),)

    return _ScannedBlocks(dev, block, None, "scanned_subgraph_step",
                          skip_padded=False)


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
    """One epoch through a scanned train step (node or hetero).

    Shuffles ``train_idx`` into ``[G, B]`` blocks and drives ``step`` per
    block under ``fold_in(base_key, i)``; the metrics come back in ONE
    device->host copy at the end.  Returns ``(state, losses [n_real],
    accs [n_real], overflow_count)`` as host numpy; ``overflow_count``
    is 0 for a step without overflow flags (the hetero step).

    ``start_block``/``on_block`` are the resume seam
    (:class:`~glt_tpu_torch.ckpt.driver.TrainLoop`): the first
    ``start_block`` blocks are skipped without disturbing the key
    schedule (block ``i`` always trains under ``fold_in(base_key, i)``),
    and ``on_block(state, i)`` fires after block ``i``'s device work has
    finished.
    """
    n_real = -(-len(train_idx) // batch_size)
    n_blocks = -(-len(train_idx) // (batch_size * group))
    n_real = max(0, n_real - int(start_block) * group)
    losses, accs, ovfs = [], [], []
    blocks = node_seed_blocks(train_idx, batch_size, group, rng)
    with _span("train.scanned_epoch", blocks=n_blocks,
               start_block=int(start_block)):
        t_epoch0 = time.perf_counter()
        for i, blk in enumerate(blocks):
            if i < start_block:
                continue
            t_blk0 = time.perf_counter()
            with _span("train.scanned_block_dispatch"):
                res = step(state, blk, trandom.fold_in(base_key, i))
            _M_STEPS.inc()
            state, ls = res[0], res[1]
            losses.append(ls)
            accs.append(res[2])
            if len(res) > 3:
                ovfs.append(res[3])
            if on_block is not None:
                # The hook may checkpoint: the block's device work
                # finishes first, so the state it captures is post-block.
                if ls.is_cuda:
                    torch.cuda.synchronize(ls.device)
                on_block(state, i)
            blk_ms = (time.perf_counter() - t_blk0) * 1e3
            _M_BLOCK_MS.observe(blk_ms)
            _profiler.spike_observe(blk_ms)
        _M_EPOCHS.inc()
        # Epoch boundary: refresh the glt.device.* gauges (absent on
        # the CPU) and advance the live-bytes leak watch.
        _device.observe_epoch()
        _flight.record("train.epoch", blocks=n_blocks - int(start_block),
                       start_block=int(start_block),
                       duration_ms=(time.perf_counter() - t_epoch0) * 1e3)
        if not losses:
            empty = np.zeros((0,), np.float32)
            return state, empty, empty, 0
        n = sum(ls.shape[0] for ls in losses)
        parts = [torch.cat(losses), torch.cat(accs)]
        if ovfs:
            parts.append(torch.cat(ovfs).to(torch.float32))
        # The epoch's one host copy is its sync: the span closes after.
        host = torch.cat(parts).cpu().numpy()
    return (state, host[:n][:n_real], host[n: 2 * n][:n_real],
            int(host[2 * n:].sum()))
