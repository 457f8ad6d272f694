"""Partition -> load -> distributed train on a papers100M-shaped graph.

The port's twin of ``examples/dist_train_papers100m.py``, in one process
with every shard on one device, or across processes:

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

With ``GLT_NUM_PROCESSES`` above 1 the run spans processes, as the JAX
example's: every process joins the gloo group
(``multihost.initialize``: ``MASTER_ADDR``, ``MASTER_PORT``,
``GLT_NUM_PROCESSES``, ``GLT_PROCESS_ID``), process 0 partitions and
writes ``_DONE`` while the others wait for it (600 s), ``--devices`` is
the global shard count, split evenly over the processes with every
local shard on ``--device``, each process loads only its own partitions
(``DistDataset.load(mesh=)``), all of them train one mesh, and process
0 prints the summary.  ``--part-dir`` must be on a filesystem every
process sees.  Two processes can share one card (gloo carries their
exchanges through host memory)::

    export MASTER_ADDR=localhost MASTER_PORT=29500 GLT_NUM_PROCESSES=2
    for r in 0 1; do GLT_PROCESS_ID=$r python -m \\
        glt_tpu_torch.examples.dist_train_papers100m --device cpu \\
        --devices 4 --scale 2e-5 --part-dir /tmp/parts & done; wait

The real ogbn-papers100M files are not read: they need a download,
which no port slice makes.
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
                        make_dist_train_step, make_tiered_train_step,
                        multihost)
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
         device, mesh: Optional[Mesh] = None) -> DistDataset:
    """``DistDataset.load`` with the saved hotness (the in-degree when
    the directory has none); with a ``mesh`` that spans processes, this
    process's partitions only."""
    hot_file = os.path.join(part_dir, "hotness.npy")
    hotness = np.load(hot_file) if os.path.exists(hot_file) else None
    return DistDataset.load(part_dir, hot_ratio=hot_ratio, labels=labels,
                            hotness=hotness, device=device, mesh=mesh)


def publish_done(done_file: str) -> None:
    """Write the partition sentinel under a tmp name and publish it with
    one rename, so a waiting rank never sees it half written."""
    tmp = f"{done_file}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write("ok")
    os.replace(tmp, done_file)


def wait_for_partition(done_file: str, part_dir: str,
                       timeout_s: float = 600.0) -> None:
    """A process other than 0 waits for process 0's ``_DONE``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(done_file):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"partitioning never finished: {part_dir} — on a "
                f"multi-host run, --part-dir must be on a filesystem "
                f"shared by every host")
        time.sleep(0.5)


def fleet_mesh(devices: int, device) -> Mesh:
    """The mesh of ``devices`` shards over every process: an even share
    of them a process, each on ``device``."""
    nproc = multihost.process_count()
    if devices % nproc:
        raise SystemExit(f"--devices {devices} does not split evenly over "
                         f"{nproc} processes")
    mesh = multihost.global_mesh([device] * (devices // nproc))
    if mesh.size != devices:
        raise SystemExit(f"--devices {devices} != global device count "
                         f"{mesh.size}")
    return mesh


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
    losses (host numpy).  On a mesh that spans processes every process
    calls this; process 0 prints."""
    tiered = isinstance(ds.feature, TieredShardedFeature)
    main_proc = multihost.process_index() == 0
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
        if main_proc:
            print(f"epoch {epoch}: loss={float(np.mean(losses)):.6f} "
                  f"acc={float(torch.stack(accs).mean()):.3f} "
                  f"time={dt:.2f}s "
                  f"subgraphs/s={len(losses) * mesh.size / dt:.1f}")
    if tiered:
        dropped = int(multihost.agree_sum(np.array([pipe.flush_dropped()]))
                      [0])
        most = multihost.agree_max(pipe.max_cold_rows)
        pipe.close()
        if main_proc:
            print(f"cold rows past cold_cap: {dropped}; most cold rows a "
                  f"shard served: {most} of {pipe.cold_cap}")
    return state, history


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    fleet = int(os.environ.get("GLT_NUM_PROCESSES", "1")) > 1
    if fleet:
        multihost.initialize()
    main_proc = multihost.process_index() == 0
    papers = synthetic_papers(args.scale, args.devices, args.batch_size,
                              args.dim, args.classes)
    part_dir = args.part_dir or os.path.join(
        tempfile.gettempdir(), f"glt_torch_papers_parts_{papers.n}_"
                               f"{args.devices}")
    done_file = os.path.join(part_dir, "_DONE")
    # A partition dir without the sentinel (the standalone partitioner's)
    # is adopted, not redone.
    if (main_proc and not os.path.exists(done_file)
            and os.path.exists(os.path.join(part_dir, "META.json"))):
        publish_done(done_file)
    if not main_proc:
        wait_for_partition(done_file, part_dir)
    elif not os.path.exists(done_file):
        probs = rank_probs(papers_graph(papers, args.device),
                           papers.train_idx, args.devices, args.fanout,
                           args.batch_size)
        secs = partition(papers, part_dir, args.devices,
                         [p.cpu().numpy() for p in probs])
        publish_done(done_file)
        print(f"partitioned {papers.n} nodes / {papers.edge_index.shape[1]} "
              f"edges into {args.devices} parts in {secs:.1f}s -> "
              f"{part_dir}")
    if fleet:
        mesh = fleet_mesh(args.devices, args.device)
        ds = load(part_dir, papers.labels, args.hot_ratio, args.device,
                  mesh=mesh)
    else:
        mesh = Mesh([args.device] * args.devices)
        ds = load(part_dir, papers.labels, args.hot_ratio, args.device)
    hot = (f"{ds.feature.hot_per_shard}/{ds.feature.nodes_per_shard}"
           if isinstance(ds.feature, TieredShardedFeature)
           else "all (no host tier)")
    if main_proc:
        print(f"loaded: {ds.graph.num_shards} shards x "
              f"{ds.relabel.nodes_per_shard} nodes on {args.device}"
              f"{' over processes' if mesh.spans else ''}, hot rows a "
              f"shard: {hot}")
    state = make_state(ds, args.fanout, args.batch_size, args.classes,
                       args.device)
    t0 = time.perf_counter()
    state, history = train(ds, mesh, state, papers.train_idx, args.fanout,
                           args.batch_size, args.epochs)
    steps = sum(len(h) for h in history)
    if main_proc:
        print(json.dumps({"metric": "papers100m_loader_throughput",
                          "value": round(steps * args.devices
                                         / (time.perf_counter() - t0), 2),
                          "unit": "subgraphs/s", "devices": args.devices}))
    return state, history


if __name__ == "__main__":
    main()
