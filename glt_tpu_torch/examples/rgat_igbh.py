"""R-GAT on an IGBH-shaped heterogeneous graph.

The port's twin of ``examples/rgat_igbh.py``, with its defaults:
paper / author / institute (synthetic, ``--scale`` 1 = 1,000 papers),
R-GAT hidden 32, 2 layers, 2 heads, GAT convs, dropout 0, fanout (4,
4), batches of 64 papers, Adam 5e-3, paper classification.  The default
route is the scanned step, G = 8 batches a call (``--group 0``:
``HeteroNeighborLoader`` and one step a batch).  ``--distributed N``
trains N shards of the graph on one device (every edge type sharded by
its source type, each shard sampling its own papers through the
exchange; ``make_hetero_dist_train_step``, frontier cap 512, batch
``min(--batch-size, the smallest shard's papers)``).

    python -m glt_tpu_torch.examples.rgat_igbh --device cuda
    python -m glt_tpu_torch.examples.rgat_igbh --device cpu
    python -m glt_tpu_torch.examples.rgat_igbh --device cpu --distributed 4

``--use-real`` is not ported (ROADMAP, queue A item 2).  Weights come
from numpy seed 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..models import RGAT, adam
from ..parallel import (DistHeteroNeighborSampler, Mesh,
                        init_hetero_dist_state, make_hetero_dist_train_step,
                        shard_feature, shard_hetero_graph)
from ..typing import reverse_edge_type
from .datasets import synthetic_igbh
from .hetero import (TARGET, _log, init_hetero_params, train_loader,
                     train_scanned)

FANOUT = [4, 4]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--use-real", action="store_true")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--distributed", type=int, default=0, metavar="N")
    ap.add_argument("--group", type=int, default=8,
                    help="batches per scanned call; 0: the loader")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_model(ds, classes: int, args: argparse.Namespace) -> RGAT:
    """R-GAT over the batch's edge types, in the order of the dataset's
    sorted edge types (reversed, not sorted again)."""
    batch_ets = [reverse_edge_type(et) for et in ds.get_edge_types()]
    widths = {t: ds.get_node_feature(t).shape[1]
              for t in ds.get_node_types()}
    model = RGAT(batch_ets, widths, 32, classes, TARGET, num_layers=2,
                 conv="gat", dropout_rate=0.0,
                 dtype=torch.bfloat16 if args.bf16 else None)
    return init_hetero_params(model).to(args.device)


def run_distributed(args: argparse.Namespace):
    """``--distributed N``: ``glt_tpu``'s ``run_distributed`` on N shards
    of one device.  Epoch ``e`` draws shard ``s``'s seeds from its own
    papers with ``default_rng(1000 * e + s)`` and step ``i`` runs under
    ``PRNGKey(1000 * e + i)``.  Returns the state and each epoch's
    (losses, accs) as host arrays."""
    n_dev = args.distributed
    ds, train_idx, classes = synthetic_igbh(scale=args.scale, device="cpu")
    sharded = shard_hetero_graph({et: g.topo for et, g in ds.graph.items()},
                                 n_dev, device=args.device)
    feats = {t: shard_feature(ds.get_node_feature(t).hot_rows.numpy(),
                              n_dev, device=args.device)
             for t in ds.get_node_types()}
    labels = np.asarray(ds.get_node_label(TARGET))
    per = sharded[(TARGET, "cites", TARGET)].nodes_per_shard
    lab = torch.from_numpy(np.pad(labels, (0, n_dev * per - labels.size),
                                  constant_values=-1).reshape(n_dev, per)
                           ).to(args.device)
    # Per-shard seed pools bound the usable batch size.
    owned = [train_idx[(train_idx // per) == s] for s in range(n_dev)]
    if min(len(o) for o in owned) == 0:
        raise RuntimeError(
            f"{n_dev} shards over {len(train_idx)} paper seeds leave a "
            f"shard without seeds; use fewer shards or a larger --scale")
    bs = min(args.batch_size, min(len(o) for o in owned))
    mesh = Mesh([args.device] * n_dev)
    sampler = DistHeteroNeighborSampler(sharded, mesh, FANOUT, TARGET,
                                        batch_size=bs, frontier_cap=512,
                                        seed=0)
    model = make_model(ds, classes, args)
    state = init_hetero_dist_state(model, adam(5e-3), sampler, feats)
    step = make_hetero_dist_train_step(sampler, feats, lab, mesh, bs)
    steps_per_epoch = max(min(len(o) for o in owned) // bs, 1)
    epochs = []
    for epoch in range(args.epochs):
        rngs = [np.random.default_rng(1000 * epoch + s) for s in range(n_dev)]
        t0 = time.perf_counter()
        losses, accs = [], []
        for it in range(steps_per_epoch):
            seeds = np.stack([rngs[s].choice(owned[s], bs, replace=False)
                              for s in range(n_dev)]).astype(np.int32)
            state, loss, acc = step(state, seeds, trandom.PRNGKey(
                epoch * 1000 + it, device=args.device))
            losses.append(loss)
            accs.append(acc)
        host = torch.stack(losses + accs).cpu().numpy()
        n = len(losses)
        _log(epoch, host[:n], host[n:], time.perf_counter() - t0)
        epochs.append((host[:n], host[n:]))
    return state, epochs


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.use_real:
        raise NotImplementedError(
            "--use-real: no converted IGBH in the repository; the real "
            "data waits for its files (ROADMAP queue A, item 2)")
    if args.distributed:
        return run_distributed(args)
    ds, train_idx, classes = synthetic_igbh(scale=args.scale,
                                            device=args.device)
    run = train_scanned if args.group > 0 else train_loader
    return run(ds, train_idx, make_model(ds, classes, args), FANOUT, args,
               lr=5e-3)


if __name__ == "__main__":
    main()
