"""Unsupervised bipartite GraphSAGE on a user-item graph.

The port's twin of ``examples/bipartite_sage_unsup.py``: hetero link
sampling over the ``user -> item`` seed edge type with binary negatives
(``HeteroLinkNeighborLoader``), two-tower hetero SAGE encoders
(``HeteroConv(conv="sage")``), a dot-product edge decoder and binary
cross-entropy on ``edge_label``, one train step a batch.  Users click
items near ``u % n_items``, so the structure is recoverable from the
graph alone.  Weights come from numpy seed 0.

    python -m glt_tpu_torch.examples.bipartite_sage_unsup --device cuda
    python -m glt_tpu_torch.examples.bipartite_sage_unsup --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import Dataset
from ..loader import HeteroLinkNeighborLoader
from ..models import TrainState, adam, create_train_state
from ..models.rgat import HeteroConv
from ..sampler import NegativeSampling
from ..typing import reverse_edge_type
from ..utils.device import DeviceLike
from .hetero import init_hetero_params

ET_UI = ("user", "clicks", "item")
ET_IU = ("item", "rev_clicks", "user")


def synthetic_user_item(n_users: int = 600, n_items: int = 300,
                        deg: int = 6, seed: int = 0,
                        device: DeviceLike = None):
    """The JAX example's graph: each user clicks ``deg`` items near
    ``u % n_items``, with the reverse edge type; 16-wide normal features
    per type.  Returns ``(dataset, positive edges [2, E])``."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_users), deg)
    dst = (src % n_items + rng.integers(0, 8, src.shape[0])) % n_items
    ei = {ET_UI: np.stack([src, dst]), ET_IU: np.stack([dst, src])}
    feats = {
        "user": rng.normal(size=(n_users, 16)).astype(np.float32),
        "item": rng.normal(size=(n_items, 16)).astype(np.float32),
    }
    ds = (Dataset(device=device)
          .init_graph(ei, num_nodes={"user": n_users, "item": n_items})
          .init_node_features(feats))
    return ds, np.stack([src, dst])


class TwoTowerSAGE(nn.Module):
    """Per-type input projections (``inputs``), ``num_layers``
    :class:`~glt_tpu_torch.models.rgat.HeteroConv` SAGE layers with relu
    (a type no edge type reaches keeps its rows), per-type output
    projections (``outputs``), and the dot product of each labelled
    pair's user and item embeddings: ``[Q]`` logits."""

    def __init__(self, edge_types, in_features: Dict[str, int],
                 hidden: int = 64, out: int = 32, num_layers: int = 2):
        super().__init__()
        self.inputs = nn.ModuleDict({t: nn.Linear(d, hidden)
                                     for t, d in in_features.items()})
        widths = {t: hidden for t in in_features}
        self.layers = nn.ModuleList([
            HeteroConv(edge_types, widths, hidden, conv="sage")
            for _ in range(num_layers)])
        self.outputs = nn.ModuleDict({t: nn.Linear(hidden, out)
                                      for t in in_features})

    def forward(self, x, edge_index, edge_mask, edge_label_index):
        h = {t: self.inputs[t](v) for t, v in x.items()}
        for layer in self.layers:
            out = layer(h, edge_index, edge_mask)
            h = {t: F.relu(out[t]) if t in out else v for t, v in h.items()}
        z = {t: self.outputs[t](v) for t, v in h.items()}
        zu = z["user"][edge_label_index[0].clamp(min=0).long()]
        zi = z["item"][edge_label_index[1].clamp(min=0).long()]
        return (zu * zi).sum(-1)


def bce_and_acc(logits: torch.Tensor, label: torch.Tensor):
    """Mean binary cross-entropy and link accuracy over the valid pairs
    (``label >= 0``), 0 when none is."""
    valid = label >= 0
    y = label.clamp(0, 1).to(torch.float32)
    bce = F.binary_cross_entropy_with_logits(logits, y, reduction="none")
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, bce, 0).sum() / n
    acc = (valid & ((logits > 0) == (y > 0.5))).sum() / n
    return loss, acc


def make_step():
    """``(state, batch) -> (state, loss, acc)``: the forward over the
    batch, BCE on ``edge_label``, backward and the optimizer step."""
    def step(state: TrainState, batch):
        logits = state.model(batch.x, batch.edge_index, batch.edge_mask,
                             batch.metadata["edge_label_index"])
        loss, acc = bce_and_acc(logits, batch.metadata["edge_label"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return (TrainState(state.model, state.optimizer, state.step + 1),
                loss.detach(), acc)

    return step


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--fanout", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """``(loader, state)``: the seed-edge loader (shuffled, seed 0) and
    the model and Adam 1e-3 at step 0, on ``--device``."""
    ds, pos_edges = synthetic_user_item(device=args.device)
    loader = HeteroLinkNeighborLoader(
        ds, args.fanout, (ET_UI, pos_edges),
        neg_sampling=NegativeSampling("binary", 1.0),
        batch_size=args.batch_size, shuffle=True, seed=0)
    batch_ets = sorted(reverse_edge_type(et) for et in ds.get_edge_types())
    widths = {t: ds.get_node_feature(t).shape[1]
              for t in ds.get_node_types()}
    model = init_hetero_params(TwoTowerSAGE(batch_ets, widths))
    return loader, create_train_state(model.to(args.device), adam(1e-3))


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``(state, history)``: per epoch, the mean BCE."""
    args = parse_args(argv)
    loader, state = build(args)
    step = make_step()
    history: List[float] = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for batch in loader:
            state, loss, acc = step(state, batch)
            losses.append(loss)
            accs.append(acc)
        host = torch.stack(losses + accs).float().cpu().numpy()
        nb = len(losses)
        history.append(float(host[:nb].mean()))
        print(f"epoch {epoch}: bce {history[-1]:.4f} link-acc "
              f"{host[nb:].mean():.4f} ({time.perf_counter() - t0:.2f}s)")
    return state, history


if __name__ == "__main__":
    main()
