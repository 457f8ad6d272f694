"""Distributed GraphSAGE over a mesh of shards: the papers100M-style
configuration on synthetic ogbn-products.

The port's twin of ``examples/dist_train_sage.py``: the graph and the
features are split into ``--devices`` contiguous shards
(``shard_graph``, ``shard_feature``), every shard of one
:class:`~glt_tpu_torch.parallel.Mesh` on ``--device``, and each step
samples every shard's seed batch through the all-to-all exchange,
gathers features and labels, and steps one shared GraphSAGE (hidden
128, 47 classes, no dropout, Adam 1e-3;
:func:`~glt_tpu_torch.parallel.make_dist_train_step`).  Each shard
trains on seeds it owns (the reference's per-rank disjoint seed split),
drawn with numpy seed 0; step ``it`` of epoch ``e`` samples under
``PRNGKey(e * 1000 + it)``.  Weights come from numpy seed 0.

    python -m glt_tpu_torch.examples.dist_train_sage --device cuda
    python -m glt_tpu_torch.examples.dist_train_sage --device cpu \\
        --devices 4 --scale 0.001
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..models import GraphSAGE, TrainState, adam
from ..parallel import (
    Mesh,
    ShardedFeature,
    ShardedGraph,
    init_dist_state,
    make_dist_train_step,
    shard_feature,
    shard_graph,
)
from .datasets import synthetic_products
from .train_sage_digits import init_params

CLASSES = 47


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh shards (all on --device)")
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--fanout", type=int, nargs="+", default=[10, 5])
    ap.add_argument("--frontier-cap", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Setup(NamedTuple):
    """The sharded data, the state at step 0 and the step."""
    graph: ShardedGraph
    feature: ShardedFeature
    labels: torch.Tensor         # [S, nodes_per_shard], -1 past the end
    mesh: Mesh
    per_shard: List[np.ndarray]  # each shard's own training seeds
    steps_per_epoch: int
    state: TrainState
    step: object


def build(args: argparse.Namespace,
          model: Optional[torch.nn.Module] = None) -> Setup:
    """Build the synthetic graph on the host, shard it onto the mesh and
    make the state (``model``, or GraphSAGE from numpy seed 0) and the
    distributed step."""
    dev, S = args.device, args.devices
    ds, train_idx = synthetic_products(scale=args.scale, device="cpu")
    topo = ds.get_graph().topo
    feat = ds.get_node_feature().hot_rows.numpy()
    labels = np.asarray(ds.get_node_label())
    g = shard_graph(topo, S, device=dev)
    f = shard_feature(feat, S, device=dev)
    pad = S * g.nodes_per_shard - labels.shape[0]
    lab = torch.from_numpy(np.pad(labels, (0, pad), constant_values=-1)
                           .reshape(S, g.nodes_per_shard)).to(dev)
    mesh = Mesh([dev] * S)
    if model is None:
        model = init_params(GraphSAGE(feat.shape[1], 128, CLASSES,
                                      num_layers=len(args.fanout),
                                      dropout_rate=0.0))
    state = init_dist_state(model.to(dev), adam(1e-3), g, f, args.fanout,
                            args.batch_size, args.frontier_cap)
    step = make_dist_train_step(g, f, lab, mesh, args.fanout,
                                args.batch_size,
                                frontier_cap=args.frontier_cap)
    per_shard = [train_idx[train_idx // g.nodes_per_shard == s]
                 for s in range(S)]
    steps = min(max(1, len(p) // args.batch_size) for p in per_shard)
    return Setup(g, f, lab, mesh, per_shard, steps, state, step)


def draw_seeds(rng, per_shard: Sequence[np.ndarray], batch_size: int
               ) -> np.ndarray:
    """One ``[S, B]`` batch: each shard draws from its own seeds (with
    replacement only when it holds fewer than ``batch_size``)."""
    return np.stack([rng.choice(p, batch_size,
                                replace=len(p) < batch_size)
                     for p in per_shard]).astype(np.int32)


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``(state, history)``: per epoch, the host losses."""
    args = parse_args(argv)
    run = build(args)
    state, rng = run.state, np.random.default_rng(0)
    history = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for it in range(run.steps_per_epoch):
            seeds = draw_seeds(rng, run.per_shard, args.batch_size)
            state, loss, _ = run.step(
                state, seeds,
                trandom.PRNGKey(epoch * 1000 + it, device=args.device))
            losses.append(loss)
        host = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        history.append(host)
        print(f"epoch {epoch}: loss={float(host.mean()):.4f} "
              f"time={dt:.2f}s subgraphs/s="
              f"{run.steps_per_epoch * args.devices / dt:.1f}")
    return state, history


if __name__ == "__main__":
    main()
