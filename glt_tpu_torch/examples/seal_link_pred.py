"""SEAL-style link prediction with induced-subgraph sampling.

The port's twin of ``examples/seal_link_pred.py``, with its defaults:
512 real edges of synthetic PPI (label 1) and 512 random node pairs
(label 0); each batch of 32 candidate links expands both endpoints by
fanout (8, 8), extracts the subgraph the sampled nodes induce (at most
16 entries of each row scanned), runs GraphSAGE 32/32 (2 layers, no
dropout) over it and scores a link by its endpoints' embedding dot
product.  The default path is the scanned step, G = 8 batches a call
(``--group 0``: ``SubGraphLoader``'s sampler and collate, one step per
batch, with a learned head vector).

    python -m glt_tpu_torch.examples.seal_link_pred --device cuda
    python -m glt_tpu_torch.examples.seal_link_pred --device cpu

Weights (and the loader path's head) are drawn from numpy, seeds 0 and
1.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import random as trandom
from ..loader import SubGraphLoader
from ..models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_scanned_subgraph_train_step,
)
from ..ops import relabel_by_reference
from ..sampler import NeighborSampler, NodeSamplerInput
from .datasets import synthetic_ppi
from .train_sage_digits import init_params

FANOUT, MAX_DEGREE, NUM_LINKS = [8, 8], 16, 512


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--group", type=int, default=8,
                    help="subgraph batches per scanned call; 0: the loader")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def candidate_links(edge_index: np.ndarray, num_nodes: int, m: int, rng):
    """``m`` real edges then ``m`` uniform node pairs, ``[2, 2m]``, with
    labels 1 and 0."""
    pos = edge_index[:, rng.permutation(edge_index.shape[1])[:m]]
    neg = rng.integers(0, num_nodes, (2, m))
    links = np.concatenate([pos, neg], axis=1)
    labels = np.concatenate([np.ones(m), np.zeros(m)]).astype(np.int32)
    return links, labels


def make_model(in_features: int, args: argparse.Namespace
               ) -> torch.nn.Module:
    model = GraphSAGE(in_features, 32, 32, num_layers=2, dropout_rate=0.0,
                      dtype=torch.bfloat16 if args.bf16 else None)
    return init_params(model).to(args.device)


def pair_loss(z: torch.Tensor, out, y: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of each (src, dst) seed pair's
    embedding dot product; pairs are found through
    ``metadata["seed_index"]`` (seeds are deduplicated in the node
    list)."""
    si = out.metadata["seed_index"].reshape(y.shape[0], 2)
    zs = z[si.clamp(0, z.shape[0] - 1).long()]          # [B, 2, d]
    logit = (zs[:, 0] * zs[:, 1]).sum(-1)
    valid = (y >= 0) & (si >= 0).all(dim=1)
    ce = F.binary_cross_entropy_with_logits(
        logit, y.clamp(0, 1).to(logit.dtype), reduction="none")
    return torch.where(valid, ce, 0).sum() / valid.sum().clamp(min=1)


def run_scanned(args: argparse.Namespace, ds, links: np.ndarray,
                labels: np.ndarray, rng,
                model: Optional[torch.nn.Module] = None):
    """``args.epochs`` epochs of the scanned subgraph step; each epoch
    shuffles the links with ``rng`` and trains block ``lo`` (its first
    link's offset) under ``fold_in(PRNGKey(epoch), lo)``.  Returns the
    state and each epoch's real-batch losses (host numpy)."""
    bs, G, dev = args.batch_size, args.group, args.device
    seed_width = bs * 2
    feat = ds.get_node_feature()
    sampler = NeighborSampler(ds.get_graph(), FANOUT,
                              batch_size=seed_width, with_edge=True)
    if model is None:
        model = make_model(feat.shape[1], args)
    state = create_train_state(model, adam(1e-3))
    step = make_scanned_subgraph_train_step(sampler, feat, pair_loss,
                                            max_degree=MAX_DEGREE)
    m2 = labels.shape[0]
    epochs: List[np.ndarray] = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        order = rng.permutation(m2)
        losses, nbs = [], []
        for lo in range(0, m2, bs * G):
            sel = order[lo: lo + bs * G]
            sb = np.full((G, seed_width), -1, np.int64)
            yb = np.full((G, bs), -1, np.int64)
            k = sel.shape[0]
            sb.reshape(-1)[: k * 2] = links.T[sel].reshape(-1)
            yb.reshape(-1)[:k] = labels[sel]
            state, ls = step(state, sb, yb, trandom.fold_in(
                trandom.PRNGKey(epoch, device=dev), lo))
            losses.append(ls)
            nbs.append(-(-k // bs))
        flat = torch.cat(losses).cpu().numpy()
        real = np.concatenate([np.arange(b) + i * G
                               for i, b in enumerate(nbs)])
        epochs.append(flat[real])
        print(f"epoch {epoch}: loss={float(np.mean(flat[real])):.4f} "
              f"time={time.perf_counter() - t0:.2f}s")
    return state, epochs


def run_loader(args: argparse.Namespace, ds, links: np.ndarray,
               labels: np.ndarray, rng,
               model: Optional[torch.nn.Module] = None):
    """One step per batch of full size through ``SubGraphLoader``'s
    sampler and collate; the score is ``(z_src * z_dst) @ w`` with a
    learned head ``w``.  Returns the model, the head and each epoch's
    losses."""
    bs, dev = args.batch_size, args.device
    loader = SubGraphLoader(ds, FANOUT, links.T.reshape(-1),
                            batch_size=bs * 2, max_degree=MAX_DEGREE)
    if model is None:
        model = make_model(ds.get_node_feature().shape[1], args)
    w = torch.from_numpy((np.random.default_rng(1).standard_normal(32)
                          * 0.1).astype(np.float32)).to(dev)
    w.requires_grad_(True)
    opt = adam(1e-3)(list(model.parameters()) + [w])
    m2 = labels.shape[0]
    order = rng.permutation(m2)
    epochs = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses = []
        for lo in range(0, m2, bs):
            sel = order[lo: lo + bs]
            if sel.shape[0] < bs:
                continue
            seeds = links.T[sel].reshape(-1)
            out = loader.sampler.subgraph(NodeSamplerInput(seeds),
                                          max_degree=MAX_DEGREE)
            batch = loader._collate_fn(out, seeds.shape[0])
            y = torch.from_numpy(labels[sel]).to(dev)
            z = model(batch.x, batch.edge_index, batch.edge_mask)
            si = relabel_by_reference(batch.node[: bs * 2],
                                      batch.batch).reshape(bs, 2)
            zs = z[si.clamp(0, z.shape[0] - 1).long()]
            logit = (zs[:, 0] * zs[:, 1]) @ w
            valid = (si >= 0).all(dim=1)
            ce = F.binary_cross_entropy_with_logits(
                logit, y.to(logit.dtype), reduction="none")
            loss = torch.where(valid, ce, 0).sum() / valid.sum().clamp(min=1)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        epochs.append(torch.stack(losses).cpu().numpy())
        print(f"epoch {epoch}: loss={float(np.mean(epochs[-1])):.4f} "
              f"time={time.perf_counter() - t0:.2f}s")
    return model, w, epochs


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    ds, edge_index = synthetic_ppi(scale=args.scale, device=args.device)
    rng = np.random.default_rng(0)
    links, labels = candidate_links(edge_index, ds.get_graph().num_nodes,
                                    NUM_LINKS, rng)
    run = run_scanned if args.group > 0 else run_loader
    return run(args, ds, links, labels, rng)


if __name__ == "__main__":
    main()
