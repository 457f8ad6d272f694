"""Supervised GraphSAGE on (synthetic) ogbn-products, on one device.

The port's twin of ``examples/train_sage_products.py``, the flagship
configuration: ``NeighborSampler`` with fanout [15, 10, 5] and batch
1024, a 3-layer GraphSAGE (hidden 256, bf16 matmuls) and Adam 1e-3;
per epoch the loss, the accuracy and the sampled subgraphs a second.
The node capacity is calibrated to the p99 of measured unique-node
counts (``--auto-cap``; overflow batches train with their excess edges
masked and are reported).  ``--group G`` (the default 8) trains G
batches a call through the scanned node step, on the card one CUDA
graph a block shape; ``--group 0`` runs the loader loop, one step a
batch.  The graph is the JAX example's synthetic one (``--scale`` of
2,449,029 nodes, 12 out-edges a node); weights come from numpy seed 0.

    python -m glt_tpu_torch.examples.train_sage_products --scale 0.01
    python -m glt_tpu_torch.examples.train_sage_products --device cpu \\
        --scale 0.001 --epochs 1

The JAX example's ``--data-root`` (converted real ogbn-products files)
has no counterpart: those files are not in the repository.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..loader import NeighborLoader
from ..models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_scanned_node_train_step,
    make_train_step,
    run_scanned_epoch,
)
from ..sampler import NeighborSampler, calibrate_node_capacity
from .datasets import synthetic_products
from .train_sage_digits import init_params, seed_batches

CLASSES = 47


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--fanout", type=int, nargs="+", default=[15, 10, 5])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--frontier-cap", type=int, default=8192)
    ap.add_argument("--auto-cap", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--node-cap", type=int, default=None,
                    help="explicit padded node capacity (overrides "
                         "--auto-cap calibration)")
    ap.add_argument("--cap-batches", type=int, default=24,
                    help="calibration batches for --auto-cap")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--group", type=int, default=8,
                    help="batches per scanned call (0: the loader loop)")
    ap.add_argument("--last-hop-dedup",
                    action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_sampler(args: argparse.Namespace, ds, train_idx
                  ) -> NeighborSampler:
    """The training sampler: capped at ``--node-cap``, or at the p99 of
    ``--cap-batches`` calibration batches; the uncapped probe itself
    when the calibration leaves no headroom."""
    skw = dict(batch_size=args.batch_size, frontier_cap=args.frontier_cap,
               with_edge=False, last_hop_dedup=args.last_hop_dedup)
    node_cap = args.node_cap
    if node_cap is None and args.auto_cap:
        probe = NeighborSampler(ds.get_graph(), args.fanout, **skw)
        cal = [b for b, _ in zip(
            seed_batches(train_idx, args.batch_size,
                         np.random.default_rng(42)),
            range(args.cap_batches))]
        node_cap = calibrate_node_capacity(probe, cal)
        print(f"auto-cap: node_capacity {node_cap} "
              f"({node_cap / probe.full_node_capacity:.0%} of worst-case "
              f"{probe.full_node_capacity})")
        if node_cap >= probe.full_node_capacity:
            return probe
    return NeighborSampler(ds.get_graph(), args.fanout,
                           node_capacity=node_cap, **skw)


def make_model(args: argparse.Namespace, in_features: int,
               dropout_rate: float = 0.5) -> torch.nn.Module:
    """GraphSAGE of ``--hidden`` x len(``--fanout``) layers, 47 classes,
    weights from numpy seed 0, on ``--device``."""
    model = GraphSAGE(in_features, args.hidden, CLASSES,
                      num_layers=len(args.fanout),
                      dropout_rate=dropout_rate,
                      dtype=torch.bfloat16 if args.bf16 else None)
    return init_params(model).to(args.device)


def run(args: argparse.Namespace, model: Optional[torch.nn.Module] = None):
    """``--epochs`` epochs; returns ``(state, history)``, the history a
    host array of each epoch's losses."""
    dev = args.device
    ds, train_idx = synthetic_products(scale=args.scale, device=dev)
    sampler = build_sampler(args, ds, train_idx)
    feat = ds.get_node_feature()
    labels = ds.get_node_label()
    if model is None:
        model = make_model(args, feat.shape[1])
    state = create_train_state(model, adam(1e-3))
    history: List[np.ndarray] = []
    if args.group > 0:
        step = make_scanned_node_train_step(sampler, feat, labels,
                                            args.batch_size)
        rng = np.random.default_rng(0)

        def run_epoch(state, epoch):
            state, losses, accs, ovf = run_scanned_epoch(
                step, state, train_idx, args.batch_size, args.group, rng,
                trandom.PRNGKey(100 + epoch, device=dev))
            if ovf:
                print(f"  overflow batches: {ovf}/{len(losses)}")
            return state, losses, accs
    else:
        loader = NeighborLoader(ds, args.fanout, train_idx,
                                batch_size=args.batch_size, shuffle=True,
                                sampler=sampler)
        one = make_train_step(args.batch_size)

        def run_epoch(state, epoch):
            losses, accs = [], []
            for batch in loader:
                state, loss, acc = one(state, batch)
                losses.append(loss)
                accs.append(acc)
            host = torch.stack(losses + accs).float().cpu().numpy()
            return state, host[:len(losses)], host[len(losses):]

    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        state, losses, accs = run_epoch(state, epoch)
        dt = time.perf_counter() - t0
        history.append(np.asarray(losses))
        print(f"epoch {epoch}: loss={float(np.mean(losses)):.4f} "
              f"acc={float(np.mean(accs)):.4f} time={dt:.2f}s "
              f"subgraphs/s={len(losses) / dt:.1f}")
    return state, history


def main(argv: Optional[Sequence[str]] = None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
