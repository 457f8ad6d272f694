"""Supervised GraphSAGE on a real dataset: the sklearn digits k-NN graph.

The port's twin of ``examples/train_sage_digits.py``, with its defaults:
the flagship pipeline (``NeighborSampler`` with the occupancy auto-cap,
bf16 matmuls, the scanned epoch with Adam) on 1797 handwritten-digit
images (64 pixel features, 10 classes, symmetric 8-NN graph) read from
the in-repo ``data/digits-knn`` with numpy.  Reports held-out test
accuracy against the non-graph baselines of the dataset's META.json.

    python -m glt_tpu_torch.examples.train_sage_digits --device cuda

Weights are drawn from numpy seed 0 (lecun-normal kernels, zero biases,
as flax initialises ``Dense``), so no global torch generator is used.

:func:`int8_store_parity` evaluates trained weights on the raw features
and through an int8 feature store of them, as
``tests/test_real_digits.py::test_digits_int8_store_accuracy_parity``
does for ``glt_tpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..data import Dataset, Feature
from ..loader import NeighborLoader
from ..models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_eval_step,
    make_scanned_node_train_step,
    run_scanned_epoch,
)
from ..sampler import NeighborSampler, calibrate_node_capacity
from ..store import DiskFeatureStore, write_feature_store

DATA = Path(__file__).resolve().parents[2] / "data" / "digits-knn"


def seed_batches(train_idx, batch_size: int, rng):
    """Shuffled ``[batch_size]`` seed chunks, trailing batch -1 padded."""
    ids = train_idx[rng.permutation(train_idx.shape[0])]
    for lo in range(0, ids.shape[0], batch_size):
        chunk = ids[lo: lo + batch_size].astype(np.int32)
        if chunk.shape[0] < batch_size:
            chunk = np.pad(chunk, (0, batch_size - chunk.shape[0]),
                           constant_values=-1)
        yield chunk


def init_params(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Lecun-normal weights and zero biases from a numpy generator."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.state_dict().items():
        if name.endswith("bias"):
            state[name] = torch.zeros_like(p)
        else:
            w = rng.standard_normal(tuple(p.shape)) / np.sqrt(p.shape[1])
            state[name] = torch.from_numpy(w.astype(np.float32))
    model.load_state_dict(state)
    return model


class TrainRun(NamedTuple):
    """What :func:`train` leaves for evaluation."""
    state: object                  # TrainState
    dataset: Dataset
    node_capacity: Optional[int]
    test_idx: np.ndarray
    meta: dict
    args: argparse.Namespace


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--fanout", type=int, nargs="+", default=[15, 10, 5])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--group", type=int, default=4,
                    help="batches per scanned block")
    ap.add_argument("--auto-cap", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--data-root", default=str(DATA))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> TrainRun:
    """Train on the raw features; returns the state and the dataset."""
    dev = args.device
    load = lambda f: np.load(os.path.join(args.data_root, f + ".npy"))  # noqa
    labels = load("labels")
    train_idx, test_idx = load("train_idx"), load("test_idx")
    with open(os.path.join(args.data_root, "META.json")) as fh:
        meta = json.load(fh)
    ds = (Dataset(device=dev)
          .init_graph((load("indptr"), load("indices")), layout="CSR")
          .init_node_features(load("feat"))
          .init_node_labels(labels))
    feat = ds.get_node_feature()
    classes = int(labels.max()) + 1

    model = GraphSAGE(feat.shape[1], args.hidden, classes,
                      num_layers=len(args.fanout),
                      dtype=torch.bfloat16 if args.bf16 else None)
    model = init_params(model).to(dev)

    node_cap = None
    if args.auto_cap:
        probe = NeighborSampler(ds.get_graph(), args.fanout,
                                batch_size=args.batch_size, with_edge=False)
        cal = [b for b, _ in zip(seed_batches(
            train_idx, args.batch_size, np.random.default_rng(42)),
            range(6))]
        node_cap = calibrate_node_capacity(probe, cal)
        print(f"auto-cap: node_capacity {node_cap} "
              f"({node_cap / probe.full_node_capacity:.0%} of worst case)")

    sampler = NeighborSampler(ds.get_graph(), args.fanout,
                              batch_size=args.batch_size, with_edge=False,
                              node_capacity=node_cap)
    state = create_train_state(model, adam(args.lr))
    step = make_scanned_node_train_step(sampler, feat, labels,
                                        args.batch_size)
    rng = np.random.default_rng(0)
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        state, losses, accs, _ = run_scanned_epoch(
            step, state, train_idx, args.batch_size, args.group, rng,
            trandom.PRNGKey(100 + epoch, device=dev))
        dt = time.perf_counter() - t0
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch}: loss={float(np.mean(losses)):.4f} "
                  f"train_acc={float(np.mean(accs)):.4f} time={dt:.2f}s")
    return TrainRun(state, ds, node_cap, test_idx, meta, args)


def evaluate(run: TrainRun, feature: Optional[Feature] = None,
             keep_x: bool = False):
    """Held-out accuracy through the sampling pipeline, no dropout,
    weighted by each batch's valid seeds.  ``feature`` replaces the
    dataset's features for this evaluation.  Every call samples with a
    fresh sampler of one seed, so two calls draw the same subgraphs.
    Returns ``(accuracy, xs)``, ``xs`` the batches' features when
    ``keep_x``."""
    args, ds = run.args, run.dataset
    saved = ds.node_features
    if feature is not None:
        ds.node_features = feature
    try:
        sampler = NeighborSampler(ds.get_graph(), args.fanout,
                                  batch_size=args.batch_size,
                                  with_edge=False,
                                  node_capacity=run.node_capacity, seed=1)
        ev = make_eval_step(args.batch_size)
        loader = NeighborLoader(ds, args.fanout, run.test_idx,
                                batch_size=args.batch_size, sampler=sampler)
        accs, weights, xs = [], [], []
        for b in loader:
            _, acc = ev(run.state.model, b)
            accs.append(float(acc))
            weights.append(b.batch_size)   # valid seeds (trailing < bs)
            if keep_x:
                xs.append(b.x)
    finally:
        ds.node_features = saved
    return float(np.average(accs, weights=weights)), xs


def int8_store_parity(run: TrainRun, workdir: Optional[str] = None
                      ) -> dict:
    """Evaluate ``run``'s weights on the raw features (host-resident,
    ``split_ratio=0.0``) and through an int8 feature store of the same
    matrix, served from a DRAM stager with a budget of 1/4 of the raw
    bytes (``split_ratio=0.0``: the stager and the device merge) and
    from the device (``split_ratio=1.0``: kernel B4 on the card).
    Returns the three accuracies and whether the two int8 evaluations'
    ``x`` are bitwise equal."""
    args = run.args
    feats = np.load(os.path.join(args.data_root, "feat.npy")).astype(
        np.float32)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        root = write_feature_store(os.path.join(tmp, "digits_int8"), feats,
                                   codec="int8")
        out = {}
        acc, _ = evaluate(run, Feature(feats, split_ratio=0.0,
                                       device=args.device))
        out["acc_raw"] = acc
        xs = {}
        for split in (0.0, 1.0):
            f = Feature.from_store(DiskFeatureStore(root),
                                   dram_budget_bytes=feats.nbytes // 4,
                                   split_ratio=split, device=args.device)
            try:
                acc, xs[split] = evaluate(run, f, keep_x=True)
            finally:
                f.close()
            out[f"acc_int8_split{split:g}"] = acc
    out["x_equal"] = len(xs[0.0]) == len(xs[1.0]) and all(
        torch.equal(a, b) for a, b in zip(xs[0.0], xs[1.0]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> float:
    args = parse_args(argv)
    run = train(args)
    test_acc, _ = evaluate(run)
    print(f"TEST accuracy: {test_acc:.4f}  "
          f"(baselines on same split: {run.meta.get('baseline_acc', {})})")
    return test_acc


if __name__ == "__main__":
    main()
