"""A dataset shared across processes through POSIX shared memory.

The port's twin of ``examples/feature_mp.py`` (the reference's
``examples/feature_mp.py``): ``share_dataset`` puts the graph and the
feature rows in shared memory once; spawned workers ``attach_dataset``
the picklable handle and map the same host pages.  On ``--device cuda``
each worker builds its own device tier from those pages (its CUDA
context cannot read another process's device memory): here every row
(``split_ratio=None`` keeps the feature's 1.0), gathered through kernel
B2; on ``--device cpu`` the rows stay in the shared pages.

    python -m glt_tpu_torch.examples.feature_mp
    python -m glt_tpu_torch.examples.feature_mp --device cpu
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
from typing import Optional, Sequence

import numpy as np


def build(device: str = "cpu"):
    """5,000 nodes of out-degree 8 (numpy seed 0), 64-wide rows whose
    every entry is the row's id."""
    from ..data import Dataset

    rng = np.random.default_rng(0)
    n, deg, dim = 5000, 8, 64
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    feat = np.arange(n, dtype=np.float32)[:, None] * np.ones(
        (1, dim), np.float32)
    return (Dataset(device=device)
            .init_graph(np.stack([src, dst]), num_nodes=n)
            .init_node_features(feat))


def worker(rank: int, handle, device: str, q) -> None:
    import torch

    from ..data import attach_dataset

    ds = attach_dataset(handle, split_ratio=None, device=device)
    ids = torch.arange(rank * 100, rank * 100 + 50, device=device)
    rows = ds.get_node_feature().gather(ids).cpu().numpy()
    ok = bool((rows[:, 0] == ids.cpu().numpy()).all())
    q.put((rank, ok, float(rows.sum())))


def main(argv: Optional[Sequence[str]] = None) -> int:
    from ..data import share_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args(argv)
    # The parent only shares: its copy stays on the host.
    handle = share_dataset(build("cpu"))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, handle, args.device, q))
             for r in range(args.workers)]
    try:
        for p in procs:
            p.start()
        for _ in procs:
            rank, ok, s = q.get(timeout=300)
            print(f"worker {rank}: gather-correct={ok} checksum={s:.0f}")
            if not ok:
                raise SystemExit(f"worker {rank} gathered wrong rows")
        for p in procs:
            p.join()
        print(f"feature_mp: {args.workers} workers gathered from one "
              f"shared copy ({handle.nbytes()} bytes)")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        handle.unlink()
    return 0


if __name__ == "__main__":
    main()
