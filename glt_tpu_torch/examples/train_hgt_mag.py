"""HGT on an OGB-MAG-shaped heterogeneous graph.

The port's twin of ``examples/train_hgt_mag.py``, with its defaults:
paper / author / institution / field_of_study (synthetic, ``--scale``
1 = 1,500 papers), HGT hidden 64, 4 heads, 2 layers, dropout 0.3,
fanout (5, 5), batches of 64 papers, Adam 1e-3, f32, venue
classification.  The default route is the scanned step, G = 8 batches a
call (``--group 0``: ``HeteroNeighborLoader`` and one step a batch).

    python -m glt_tpu_torch.examples.train_hgt_mag --device cuda
    python -m glt_tpu_torch.examples.train_hgt_mag --device cpu

Weights come from numpy seed 0; dropout draws from threefry keys, not
flax's bits.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..models import HGT
from ..typing import reverse_edge_type
from .datasets import synthetic_mag
from .hetero import TARGET, init_hetero_params, train_loader, train_scanned


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--fanout", type=int, nargs="+", default=[5, 5])
    ap.add_argument("--last-hop-dedup", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--group", type=int, default=8,
                    help="batches per scanned call; 0: the loader")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_model(ds, classes: int, args: argparse.Namespace) -> HGT:
    """HGT over the batch's edge types (sorted), built for the
    dataset's per-type feature widths."""
    batch_ets = sorted(reverse_edge_type(et) for et in ds.graph)
    widths = {t: ds.get_node_feature(t).shape[1]
              for t in ds.get_node_types()}
    model = HGT(batch_ets, widths, args.hidden, classes, TARGET,
                num_layers=len(args.fanout), heads=args.heads,
                dropout_rate=0.3,
                dtype=torch.bfloat16 if args.bf16 else None)
    return init_hetero_params(model).to(args.device)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    ds, train_idx, classes = synthetic_mag(scale=args.scale,
                                           device=args.device)
    run = train_scanned if args.group > 0 else train_loader
    return run(ds, train_idx, make_model(ds, classes, args), args.fanout,
               args, lr=1e-3, last_hop_dedup=args.last_hop_dedup)


if __name__ == "__main__":
    main()
