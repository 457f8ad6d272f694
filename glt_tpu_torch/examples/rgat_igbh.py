"""R-GAT on an IGBH-shaped heterogeneous graph.

The port's twin of ``examples/rgat_igbh.py``, with its defaults:
paper / author / institute (synthetic, ``--scale`` 1 = 1,000 papers),
R-GAT hidden 32, 2 layers, 2 heads, GAT convs, dropout 0, fanout (4,
4), batches of 64 papers, Adam 5e-3, paper classification.  The default
route is the scanned step, G = 8 batches a call (``--group 0``:
``HeteroNeighborLoader`` and one step a batch).

    python -m glt_tpu_torch.examples.rgat_igbh --device cuda
    python -m glt_tpu_torch.examples.rgat_igbh --device cpu

``--distributed`` and ``--use-real`` are not ported (ROADMAP, queue A).
Weights come from numpy seed 0.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from ..models import RGAT
from ..typing import reverse_edge_type
from .datasets import synthetic_igbh
from .hetero import TARGET, init_hetero_params, train_loader, train_scanned

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


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: the multi-card hetero path is not ported "
            "(ROADMAP queue A, item 7)")
    if args.use_real:
        raise NotImplementedError(
            "--use-real: no converted IGBH in the repository; the real "
            "data waits for its files (ROADMAP queue A, item 2)")
    ds, train_idx, classes = synthetic_igbh(scale=args.scale,
                                            device=args.device)
    run = train_scanned if args.group > 0 else train_loader
    return run(ds, train_idx, make_model(ds, classes, args), FANOUT, args,
               lr=5e-3)


if __name__ == "__main__":
    main()
