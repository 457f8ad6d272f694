"""The training loops shared by the hetero twins
(:mod:`~glt_tpu_torch.examples.train_hgt_mag`,
:mod:`~glt_tpu_torch.examples.rgat_igbh`): the scanned route (one
:func:`~glt_tpu_torch.models.make_scanned_hetero_train_step` call per
block of ``group`` batches) and the loader route
(:class:`~glt_tpu_torch.loader.HeteroNeighborLoader` and one step a
batch), both on the paper type's labels."""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..loader import HeteroNeighborLoader
from ..models import (
    adam,
    create_train_state,
    init_hetero_state,
    make_scanned_hetero_train_step,
    make_train_step,
    run_scanned_epoch,
)
from ..sampler import HeteroNeighborSampler

TARGET = "paper"


def init_hetero_params(model: torch.nn.Module, seed: int = 0
                       ) -> torch.nn.Module:
    """Weights from a numpy generator: zero biases, ones for the scalar
    and per-head gates (HGT's ``skip`` and ``mu``, as flax initialises
    them), normal matrices of variance 1 / fan-in: the last axis of a
    ``Linear.weight`` or an attention vector, the leading axes of HGT's
    per-head ``[h, d, d]`` maps (flax's glorot over them)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            state[name] = torch.zeros_like(p)
        elif p.dim() < 2:
            state[name] = torch.ones_like(p)
        else:
            fan_in = p.shape[-1] if p.dim() == 2 else np.prod(p.shape[:-1])
            w = rng.standard_normal(tuple(p.shape)) / np.sqrt(fan_in)
            state[name] = torch.from_numpy(w.astype(np.float32))
    model.load_state_dict(state)
    return model


def _log(epoch, losses, accs, dt):
    print(f"epoch {epoch}: loss={float(np.mean(losses)):.4f} "
          f"acc={float(np.mean(accs)):.4f} time={dt:.2f}s "
          f"({len(losses)} batches)", flush=True)


def train_scanned(ds, train_idx, model, fanout, args, lr: float,
                  last_hop_dedup: bool = True
                  ) -> Tuple[object, List[Tuple[np.ndarray, np.ndarray]]]:
    """``args.epochs`` scanned epochs of ``group`` batches a call; epoch
    ``e`` runs under ``PRNGKey(100 + e)``, its seeds shuffled by numpy
    seed 0.  Returns the state and each epoch's (losses, accs)."""
    sampler = HeteroNeighborSampler(
        ds.graph, fanout, TARGET, batch_size=args.batch_size, seed=0,
        last_hop_dedup=last_hop_dedup)
    feats = {t: ds.get_node_feature(t) for t in ds.get_node_types()
             if ds.get_node_feature(t) is not None}
    labels = {TARGET: np.asarray(ds.get_node_label(TARGET))}
    state = init_hetero_state(model, adam(lr), sampler, feats)
    step = make_scanned_hetero_train_step(sampler, feats, labels,
                                          args.batch_size)
    rng = np.random.default_rng(0)
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        state, losses, accs, _ = run_scanned_epoch(
            step, state, train_idx, args.batch_size, args.group, rng,
            trandom.PRNGKey(100 + epoch, device=args.device))
        _log(epoch, losses, accs, time.perf_counter() - t0)
        epochs.append((losses, accs))
    return state, epochs


def train_loader(ds, train_idx, model, fanout, args, lr: float,
                 last_hop_dedup: bool = True):
    """The per-batch route: a shuffled ``HeteroNeighborLoader`` (seed 0)
    and one step a batch, dropout keys ``fold_in(PRNGKey(1), step)``.
    Returns the state and each epoch's (losses, accs)."""
    loader = HeteroNeighborLoader(
        ds, fanout, (TARGET, train_idx), batch_size=args.batch_size,
        shuffle=True, seed=0, last_hop_dedup=last_hop_dedup)
    state = create_train_state(model, adam(lr))
    step = make_train_step(args.batch_size, dropout_seed=1,
                           target_type=TARGET)
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for batch in loader:
            state, loss, acc = step(state, batch)
            losses.append(loss)
            accs.append(acc)
        host = torch.stack(losses + accs).cpu().numpy()
        n = len(losses)
        _log(epoch, host[:n], host[n:], time.perf_counter() - t0)
        epochs.append((host[:n], host[n:]))
    return state, epochs
