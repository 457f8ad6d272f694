"""Unsupervised GraphSAGE on synthetic PPI with binary negative sampling.

The port's twin of ``examples/graph_sage_unsup_ppi.py``, with its
defaults: GraphSAGE 64/64 (2 layers, no dropout), fanout (10, 10),
batches of 256 seed edges with one uniform negative edge each, frontier
cap 4096, Adam 1e-3, and a binary cross-entropy on the embeddings' dot
products.  The default path is the scanned step, G = 8 batches a call
(``--group 0``: ``LinkNeighborLoader`` and one step per batch).

    python -m glt_tpu_torch.examples.graph_sage_unsup_ppi --device cuda
    python -m glt_tpu_torch.examples.graph_sage_unsup_ppi --device cpu

Weights are drawn from numpy seed 0 (as the digits twin does).  The
loader path samples its first batch for training, where ``glt_tpu``'s
first draws go to initialising flax, so only the scanned path follows
``glt_tpu``'s keys batch for batch.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as trandom
from ..loader import LinkNeighborLoader
from ..models import (
    GraphSAGE,
    adam,
    create_train_state,
    link_seed_blocks,
    make_scanned_link_train_step,
)
from ..models.train import TrainState, _update
from ..sampler import NegativeSampling, NeighborSampler
from .datasets import synthetic_ppi
from .train_sage_digits import init_params

FRONTIER_CAP = 4096


def unsup_dot_loss(z: torch.Tensor, meta) -> torch.Tensor:
    """Mean binary cross-entropy of the seed pairs' embedding dot
    products against ``edge_label > 0``, over the valid pairs (0 when
    none is)."""
    eli = meta["edge_label_index"]
    label = meta["edge_label"]
    valid = (eli[0] >= 0) & (eli[1] >= 0) & (label >= 0)
    last = z.shape[0] - 1
    src = z[eli[0].clamp(0, last).long()]
    dst = z[eli[1].clamp(0, last).long()]
    logits = (src * dst).sum(-1)
    ce = F.binary_cross_entropy_with_logits(
        logits, (label > 0).to(logits.dtype), reduction="none")
    return torch.where(valid, ce, 0).sum() / valid.sum().clamp(min=1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--fanout", type=int, nargs="+", default=[10, 10])
    ap.add_argument("--group", type=int, default=8,
                    help="link batches per scanned call; 0: the loader")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_model(in_features: int, args: argparse.Namespace
               ) -> torch.nn.Module:
    model = GraphSAGE(in_features, 64, 64, num_layers=2, dropout_rate=0.0,
                      dtype=torch.bfloat16 if args.bf16 else None)
    return init_params(model).to(args.device)


def train_scanned(args: argparse.Namespace, ds, edge_index,
                  model: Optional[torch.nn.Module] = None):
    """``args.epochs`` epochs of the scanned link step over
    ``edge_index``; block ``i`` of epoch ``e`` trains under
    ``fold_in(PRNGKey(e), real batches before it)``.  Returns the state
    and each epoch's real-batch losses (host numpy)."""
    dev = args.device
    feat = ds.get_node_feature()
    if model is None:
        model = make_model(feat.shape[1], args)
    sampler = NeighborSampler(ds.get_graph(), args.fanout,
                              batch_size=args.batch_size,
                              frontier_cap=FRONTIER_CAP, with_edge=False)
    state = create_train_state(model, adam(1e-3))
    step = make_scanned_link_train_step(sampler, feat, unsup_dot_loss,
                                        NegativeSampling("binary", 1))
    rng = np.random.default_rng(0)
    epochs: List[np.ndarray] = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses, nbs, batches = [], [], 0
        for sb, db, nb in link_seed_blocks(edge_index, args.batch_size,
                                           args.group, rng):
            state, ls = step(state, sb, db, trandom.fold_in(
                trandom.PRNGKey(epoch, device=dev), batches))
            losses.append(ls)
            nbs.append(nb)
            batches += nb
        flat = torch.cat(losses).cpu().numpy()
        real = np.concatenate([np.arange(nb) + i * args.group
                               for i, nb in enumerate(nbs)])
        epochs.append(flat[real])
        print(f"epoch {epoch}: loss={float(np.mean(flat[real])):.4f} "
              f"time={time.perf_counter() - t0:.2f}s")
    return state, epochs


def train_loader(args: argparse.Namespace, ds, edge_index,
                 model: Optional[torch.nn.Module] = None):
    """The per-batch path: ``LinkNeighborLoader`` (shuffled, binary
    negatives) and one step per batch.  Returns the state and each
    epoch's losses."""
    feat = ds.get_node_feature()
    if model is None:
        model = make_model(feat.shape[1], args)
    loader = LinkNeighborLoader(
        ds, args.fanout, edge_index, batch_size=args.batch_size,
        neg_sampling=NegativeSampling("binary", 1), shuffle=True,
        frontier_cap=FRONTIER_CAP)
    state: TrainState = create_train_state(model, adam(1e-3))
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            z = state.model(batch.x, batch.edge_index, batch.edge_mask)
            loss = unsup_dot_loss(z, batch.metadata)
            state = _update(state, loss)
            losses.append(loss.detach())
        epochs.append(torch.stack(losses).cpu().numpy())
        print(f"epoch {epoch}: loss={float(np.mean(epochs[-1])):.4f} "
              f"time={time.perf_counter() - t0:.2f}s")
    return state, epochs


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    ds, edge_index = synthetic_ppi(scale=args.scale, device=args.device)
    run = train_scanned if args.group > 0 else train_loader
    return run(args, ds, edge_index)


if __name__ == "__main__":
    main()
