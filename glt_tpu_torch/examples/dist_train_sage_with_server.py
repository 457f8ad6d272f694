"""Supervised GraphSAGE trained through the server-client deployment.

The port's twin of ``examples/dist_train_sage_with_server.py`` (the
reference's ``dist_train_sage_supervised_with_server.py``): sampling
*server* processes own the graph and the features and stream sampled
batches over sockets (:func:`~glt_tpu_torch.distributed.init_server`);
*trainer* processes hold only the model and consume a
:class:`~glt_tpu_torch.distributed.RemoteNeighborLoader`.  Graph storage
and sampling scale apart from the trainers.

Topology (one machine): ``--servers`` server processes and one trainer
per server, all spawned, all on ``--device``: on one card every process
has its own CUDA context, the servers sample through the port's kernels
(B1 and the threefry hash kernel, B2 for the feature gather) and the
trainers run the model's forward and backward.  Trainer ``r`` trains on
``train_idx[r::servers]`` against server ``r``; GraphSAGE (hidden 128,
3 layers, dropout 0.5, 47 classes, weights from numpy seed 0), Adam
1e-3, fanout (15, 10, 5), batch 256, on synthetic ogbn-products at
``--scale``.

    python -m glt_tpu_torch.examples.dist_train_sage_with_server \\
        --servers 2 --epochs 3
    python -m glt_tpu_torch.examples.dist_train_sage_with_server \\
        --device cpu --scale 0.002 --epochs 1
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import time
from typing import Callable, Optional, Sequence

import numpy as np

FANOUT = (15, 10, 5)
HIDDEN, CLASSES, LR = 128, 47, 1e-3


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--workers", type=int, default=0,
                    help="mp sampling workers per server producer")
    ap.add_argument("--max-batches", type=int, default=0,
                    help="cut each trainer's seeds to this many batches "
                    "(0: all)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_dataset(scale: float = 0.02, device: str = "cuda"):
    """The servers' dataset (and the mp workers' builder)."""
    from .datasets import synthetic_products

    return synthetic_products(scale=scale, device=device)[0]


def serve(scale: float, device: str, conn, server_rank: int = 0,
          num_servers: int = 1) -> None:
    """Server role: build the dataset on ``device``, start the server,
    send its address down ``conn`` and serve until ``conn`` says stop."""
    from ..distributed import init_server

    srv = init_server(build_dataset(scale, device),
                      dataset_builder=build_dataset,
                      builder_args=(scale, device),
                      num_servers=num_servers, server_rank=server_rank,
                      num_clients=num_servers)
    conn.send(tuple(srv.addr))
    conn.recv()           # blocks until the launcher says shutdown
    srv.shutdown()


def make_state(device: str):
    """GraphSAGE 100 -> 128 -> 47 (3 layers, dropout 0.5) from numpy
    seed 0, and Adam 1e-3."""
    from ..models import GraphSAGE, adam, create_train_state
    from .train_sage_digits import init_params

    model = init_params(GraphSAGE(100, HIDDEN, CLASSES)).to(device)
    return create_train_state(model, adam(LR))


def make_loader(addr, seeds: np.ndarray, batch_size: int,
                num_workers: int = 0, device: str = "cuda"):
    """A trainer's remote loader on the server at ``addr``."""
    from ..distributed import (RemoteNeighborLoader,
                               RemoteSamplingWorkerOptions)

    return RemoteNeighborLoader(
        addr, list(FANOUT), seeds, batch_size=batch_size,
        worker_options=RemoteSamplingWorkerOptions(
            num_workers=num_workers, buffer_capacity=8, prefetch_size=4,
            channel_capacity_bytes=64 << 20),
        device=device)


def train(rank: int, world: int, addr, seeds: np.ndarray, epochs: int,
          batch_size: int, num_workers: int = 0, device: str = "cuda",
          on_batch: Optional[Callable] = None) -> dict:
    """Client role: a remote loader, the model and its train step; no
    local graph.  ``on_batch(epoch, batch, loss)`` sees every batch.
    Returns the per-epoch losses (host floats), step wall ms and epoch
    seconds."""
    import torch

    from ..distributed import init_client_context
    from ..models import make_train_step

    init_client_context(num_clients=world, client_rank=rank,
                        num_servers=world)
    loader = make_loader(addr, seeds, batch_size, num_workers, device)
    hist = {"losses": [], "step_ms": [], "epoch_s": [], "batches": 0}
    try:
        state = make_state(device)
        step = make_train_step(batch_size)
        sync = (torch.cuda.synchronize if torch.device(device).type ==
                "cuda" else (lambda: None))
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = []
            for batch in loader:
                sync()
                ts = time.perf_counter()
                state, loss, _ = step(state, batch)
                sync()
                hist["step_ms"].append((time.perf_counter() - ts) * 1e3)
                losses.append(loss)
                if on_batch is not None:
                    on_batch(epoch, batch, loss)
            host = torch.stack(losses).cpu().tolist()
            hist["losses"].append(host)
            hist["batches"] += len(host)
            hist["epoch_s"].append(time.perf_counter() - t0)
            print(f"[client {rank}] epoch {epoch}: loss "
                  f"{float(np.mean(host)):.4f} "
                  f"({hist['epoch_s'][-1]:.2f}s)", flush=True)
    finally:
        loader.shutdown()
    return hist


def trainer_seeds(train_idx: np.ndarray, rank: int, world: int,
                  batch_size: int, max_batches: int = 0) -> np.ndarray:
    """Trainer ``rank``'s seeds: ``train_idx[rank::world]`` (the
    reference's per-rank disjoint split), cut to ``max_batches``."""
    seeds = train_idx[rank::world]
    return seeds[:max_batches * batch_size] if max_batches else seeds


def main(argv: Optional[Sequence[str]] = None) -> None:
    from .datasets import synthetic_products

    args = parse_args(argv)
    # The trainers' seed split comes from the same recipe on the host.
    _, train_idx = synthetic_products(scale=args.scale, device="cpu")
    ctx = mp.get_context("spawn")
    servers, pipes = [], []
    for r in range(args.servers):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=serve, args=(args.scale, args.device, child,
                                            r, args.servers))
        p.start()
        servers.append(p)
        pipes.append(parent)
    addrs = [pipe.recv() for pipe in pipes]
    print(f"servers up at {addrs}", flush=True)
    trainers = [ctx.Process(target=train, args=(
        r, args.servers, addrs[r],
        trainer_seeds(train_idx, r, args.servers, args.batch_size,
                      args.max_batches),
        args.epochs, args.batch_size, args.workers, args.device))
        for r in range(args.servers)]
    for t in trainers:
        t.start()
    for t in trainers:
        t.join()
    for pipe in pipes:
        pipe.send("shutdown")
    for p in servers:
        p.join(timeout=15)
        if p.is_alive():
            p.terminate()
    bad = [t.exitcode for t in trainers if t.exitcode != 0]
    if bad:
        raise SystemExit(f"trainers failed: exit codes {bad}")
    print("done", flush=True)


if __name__ == "__main__":
    main()
