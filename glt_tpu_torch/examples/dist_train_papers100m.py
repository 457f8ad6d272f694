"""Partition -> load -> distributed train on a papers100M-shaped graph.

The port's twin of ``examples/dist_train_papers100m.py``, single process
with every shard on one device:

  1. offline: the FrequencyPartitioner, fed by each rank's
     ``NeighborSampler.sample_prob`` (computed on ``--device``), writes
     the on-disk partition layout and the summed hotness;
  2. load: ``DistDataset.load`` relabels contiguously (hottest rows
     first) and shards graph, features and labels onto the device,
     keeping only the hottest ``--hot-ratio`` of each shard's feature
     rows there (the rest in host memory; 0.25 by default, as the JAX
     example);
  3. train: over a mesh of ``--devices`` shards, one step per seed
     batch of every shard: below ``--hot-ratio 1`` the two-stage
     ``TieredTrainPipeline`` (sample, host cold gather, train), at 1.0
     ``make_dist_train_step``.

The graph is the JAX example's synthetic one: ``--scale`` of
papers100M's 111,059,956 nodes, 15 out-edges a node to destinations
drawn by a power law of a random rank, numpy seed 0, labels the rank
mod ``--classes``, standard-normal features whose column 0 carries the
label.  Weights come from numpy seed 0.

    python -m glt_tpu_torch.examples.dist_train_papers100m --device cuda
    python -m glt_tpu_torch.examples.dist_train_papers100m --device cpu \\
        --devices 4 --scale 2e-5

The multi-host run (``GLT_NUM_PROCESSES``) and the real ogbn-papers100M
files wait for later slices (ROADMAP queue A items 7 and 6).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import random as trandom
from ..data import CSRTopo, Graph
from ..distributed import DistDataset
from ..models import GraphSAGE, TrainState, adam
from ..parallel import (DistNeighborSampler, Mesh, TieredShardedFeature,
                        TieredTrainPipeline, init_dist_state,
                        make_dist_train_step, make_tiered_train_step)
from ..partition import FrequencyPartitioner
from ..sampler import NeighborSampler
from .train_sage_digits import init_params

PAPERS_NODES = 111_059_956


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="mesh shards (all on --device)")
    ap.add_argument("--scale", type=float, default=2e-5,
                    help="fraction of papers100M's 111M nodes")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--classes", type=int, default=172)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--fanout", type=int, nargs="+", default=[12, 10])
    ap.add_argument("--hot-ratio", type=float, default=0.25,
                    help="fraction of each shard's feature rows on the "
                         "device (the rest stay in host memory)")
    ap.add_argument("--part-dir", default=None,
                    help="reuse an existing partition dir")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class Papers(NamedTuple):
    """The synthetic graph on the host."""
    n: int
    edge_index: np.ndarray     # [2, 15 n] int64
    feat: np.ndarray           # [n, dim] f32
    labels: np.ndarray         # [n] int32
    train_idx: np.ndarray      # [max(n // 10, devices * batch)]


def synthetic_papers(scale: float, devices: int, batch_size: int,
                     dim: int = 128, classes: int = 172) -> Papers:
    """The JAX example's synthetic papers100M-shaped graph (numpy seed
    0, the same draws in the same order)."""
    n = max(devices * batch_size, int(PAPERS_NODES * scale))
    rng = np.random.default_rng(0)
    # Power-law-ish citation graph: preferential attachment by rank.
    deg_rank = rng.permutation(n)
    popularity = 1.0 / (1.0 + deg_rank.astype(np.float64)) ** 0.8
    popularity /= popularity.sum()
    avg_deg = 15
    src = rng.integers(0, n, n * avg_deg)
    dst = rng.choice(n, n * avg_deg, p=popularity)
    edge_index = np.stack([src, dst]).astype(np.int64)
    labels = (deg_rank % classes).astype(np.int32)
    feat = rng.normal(0, 1, (n, dim)).astype(np.float32)
    feat[:, 0] = labels  # learnable signal
    train_idx = rng.choice(n, max(n // 10, devices * batch_size),
                           replace=False)
    return Papers(n, edge_index, feat, labels, train_idx)


def papers_graph(papers: Papers, device) -> Graph:
    """The synthetic graph's CSR on ``device``."""
    return Graph(CSRTopo(papers.edge_index, num_nodes=papers.n),
                 device=device)


def rank_probs(graph: Graph, train_idx: np.ndarray, devices: int,
               fanout: Sequence[int], batch_size: int) -> list:
    """Each rank's ``sample_prob`` over its slice of ``train_idx``, on
    the graph's device (one f32 tensor a rank)."""
    sampler = NeighborSampler(graph, fanout, batch_size=batch_size)
    return [sampler.sample_prob(r, graph.num_nodes)
            for r in np.array_split(train_idx, devices)]


def partition(papers: Papers, part_dir: str, devices: int, probs) -> float:
    """FrequencyPartitioner from the rank vectors ``probs`` (host arrays)
    into ``part_dir``, plus ``hotness.npy`` (their sum, which orders
    each shard's rows).  Returns the seconds it took."""
    t0 = time.perf_counter()
    probs = [np.asarray(p) for p in probs]
    FrequencyPartitioner(
        part_dir, devices, papers.n, papers.edge_index,
        node_feat=papers.feat, probs=probs, cache_ratio=0.0,
        chunk_size=max(1, papers.n // (devices * 16))).partition()
    np.save(os.path.join(part_dir, "hotness.npy"), np.sum(probs, axis=0))
    return time.perf_counter() - t0


def load(part_dir: str, labels: np.ndarray, hot_ratio: float,
         device) -> DistDataset:
    """``DistDataset.load`` with the saved hotness (the in-degree when
    the directory has none)."""
    hot_file = os.path.join(part_dir, "hotness.npy")
    hotness = np.load(hot_file) if os.path.exists(hot_file) else None
    return DistDataset.load(part_dir, hot_ratio=hot_ratio, labels=labels,
                            hotness=hotness, device=device)


def make_state(ds: DistDataset, fanout: Sequence[int], batch_size: int,
               classes: int, device) -> TrainState:
    """GraphSAGE hidden 256, one layer a hop, dropout 0, Adam 1e-3,
    weights from numpy seed 0."""
    tiered = isinstance(ds.feature, TieredShardedFeature)
    dim = (ds.feature.hot if tiered else ds.feature.rows).shape[-1]
    model = GraphSAGE(dim, 256, classes,
                      num_layers=len(fanout), dropout_rate=0.0)
    model = init_params(model).to(device)
    return init_dist_state(model, adam(1e-3), ds.graph, ds.feature, fanout,
                           batch_size)


def train(ds: DistDataset, mesh: Mesh, state: TrainState,
          train_idx: np.ndarray, fanout: Sequence[int], batch_size: int,
          epochs: int, **step_kw):
    """``epochs`` epochs, the batches from one shuffle Generator (seed
    0) advancing across epochs, epoch ``e`` under ``PRNGKey(e)``: a
    tiered feature trains through ``TieredTrainPipeline.run_epoch``,
    a whole one through the distributed step, batch ``b`` under
    ``fold_in(PRNGKey(e), b)``.  Returns the state and each epoch's
    losses (host numpy)."""
    tiered = isinstance(ds.feature, TieredShardedFeature)
    if tiered:
        sampler = DistNeighborSampler(ds.graph, mesh,
                                      num_neighbors=fanout,
                                      batch_size=batch_size)
        pipe = TieredTrainPipeline(
            sampler, make_tiered_train_step(ds.graph, ds.feature, ds.labels,
                                            mesh, batch_size, **step_kw),
            ds.feature, mesh)
    else:
        step = make_dist_train_step(ds.graph, ds.feature, ds.labels, mesh,
                                    fanout, batch_size, **step_kw)
    shuffle_rng = np.random.default_rng(0)
    dev = mesh.device
    history = []
    for epoch in range(epochs):
        batches = ds.split_seeds(train_idx, batch_size, shuffle=True,
                                 rng=shuffle_rng)
        t0 = time.perf_counter()
        losses, accs = [], []
        key = trandom.PRNGKey(epoch, device=dev)
        if tiered:
            state, losses, accs = pipe.run_epoch(state, list(batches), key)
        else:
            for b in range(batches.shape[0]):
                state, loss, acc = step(state, batches[b],
                                        trandom.fold_in(key, b))
                losses.append(loss)
                accs.append(acc)
        losses = torch.stack(losses).cpu().numpy()
        dt = time.perf_counter() - t0
        history.append(losses)
        print(f"epoch {epoch}: loss={float(np.mean(losses)):.4f} "
              f"acc={float(torch.stack(accs).mean()):.3f} time={dt:.2f}s "
              f"subgraphs/s={len(losses) * mesh.size / dt:.1f}")
    if tiered:
        dropped = pipe.flush_dropped()
        pipe.close()
        print(f"cold rows past cold_cap: {dropped}; most cold rows a "
              f"shard served: {pipe.max_cold_rows} of {pipe.cold_cap}")
    return state, history


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    papers = synthetic_papers(args.scale, args.devices, args.batch_size,
                              args.dim, args.classes)
    part_dir = args.part_dir or os.path.join(
        tempfile.gettempdir(), f"glt_torch_papers_parts_{papers.n}_"
                               f"{args.devices}")
    done_file = os.path.join(part_dir, "_DONE")
    if not os.path.exists(done_file):
        probs = rank_probs(papers_graph(papers, args.device),
                           papers.train_idx, args.devices, args.fanout,
                           args.batch_size)
        secs = partition(papers, part_dir, args.devices,
                         [p.cpu().numpy() for p in probs])
        with open(done_file, "w") as fh:
            fh.write("ok")
        print(f"partitioned {papers.n} nodes / {papers.edge_index.shape[1]} "
              f"edges into {args.devices} parts in {secs:.1f}s -> "
              f"{part_dir}")
    ds = load(part_dir, papers.labels, args.hot_ratio, args.device)
    hot = (f"{ds.feature.hot_per_shard}/{ds.feature.nodes_per_shard}"
           if isinstance(ds.feature, TieredShardedFeature)
           else "all (no host tier)")
    print(f"loaded: {ds.graph.num_shards} shards x "
          f"{ds.relabel.nodes_per_shard} nodes on {args.device}, hot "
          f"rows a shard: {hot}")
    mesh = Mesh([args.device] * args.devices)
    state = make_state(ds, args.fanout, args.batch_size, args.classes,
                       args.device)
    t0 = time.perf_counter()
    state, history = train(ds, mesh, state, papers.train_idx, args.fanout,
                           args.batch_size, args.epochs)
    steps = sum(len(h) for h in history)
    print(json.dumps({"metric": "papers100m_loader_throughput",
                      "value": round(steps * args.devices
                                     / (time.perf_counter() - t0), 2),
                      "unit": "subgraphs/s", "devices": args.devices}))
    return state, history


if __name__ == "__main__":
    main()
