"""Train from table-format storage (the PAI/ODPS ingestion path).

The port's twin of ``examples/table_dataset_train.py``: graph edges and
node features arrive as table records, ``(src, dst)`` rows for edges and
``(id, "f1:f2:...:fd")`` rows for nodes with the label as the last
column, through a ``common_io``-shaped reader (here an in-memory reader
over synthetic records: 2,000 nodes, 8 out-edges each, 6 classes, numpy
seed 0).  :class:`~glt_tpu_torch.data.TableDataset` builds the dataset
on ``--device``; a ``NeighborLoader`` (fanout (5, 5), batch 128,
shuffled with seed 0) feeds GraphSAGE 6 -> 64 -> 6 (3 layers, dropout
0.5, weights from numpy seed 0), Adam 5e-3, 3 epochs, one step a batch:
kernels B1 (each hop) and B2 (the feature gather) on the card.

    python -m glt_tpu_torch.examples.table_dataset_train
    python -m glt_tpu_torch.examples.table_dataset_train --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np

FANOUT, BATCH, HIDDEN, LR = (5, 5), 128, 64, 5e-3


class ListTableReader:
    """A minimal ``common_io``-shaped reader over in-memory records."""

    def __init__(self, records):
        self._records = list(records)
        self._pos = 0

    def read(self, batch_size, allow_smaller_final_batch=True):
        if self._pos >= len(self._records):
            raise StopIteration
        got = self._records[self._pos: self._pos + batch_size]
        self._pos += len(got)
        return got

    def close(self):
        pass


def synthetic_tables(n=2000, deg=8, classes=6, seed=0):
    """The JAX example's records: ``({"edges": [(src, dst)], "nodes":
    [(id, "f1:...:f6:label")]}, classes)``."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, n * deg)
    labels = rng.integers(0, classes, n)
    feats = (np.eye(classes)[labels]
             + rng.normal(0, .3, (n, classes))).astype(np.float32)
    edge_records = list(zip(src.tolist(), dst.tolist()))
    node_records = [
        (i, ":".join(f"{v:.5f}" for v in feats[i]) + f":{labels[i]}")
        for i in range(n)]
    return {"edges": edge_records, "nodes": node_records}, classes


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_tables(device: str = "cuda"):
    """``(dataset, classes)``: the synthetic tables drained through the
    reader into a :class:`~glt_tpu_torch.data.TableDataset` on
    ``device``."""
    from ..data.table_dataset import TableDataset

    tables, classes = synthetic_tables()
    ds = TableDataset.from_tables(
        {"edge": "edges"}, {"node": "nodes"},
        reader_factory=lambda name: ListTableReader(tables[name]),
        device=device, label_from_last_column=True, reader_batch_size=256)
    return ds, classes


def build(args: argparse.Namespace):
    """``(dataset, loader, state)``: the table dataset, its shuffled
    loader (seed 0) and GraphSAGE with Adam 5e-3 at step 0."""
    from ..loader import NeighborLoader
    from ..models import GraphSAGE, adam, create_train_state
    from .train_sage_digits import init_params

    ds, classes = load_tables(args.device)
    n = ds.get_graph().num_nodes
    loader = NeighborLoader(ds, list(FANOUT), np.arange(n), batch_size=BATCH,
                            shuffle=True, seed=0)
    # The JAX example draws one batch to initialize its model, which
    # starts an epoch and advances the sampler's keys; the twin draws it
    # too, so its epochs see the example's shuffles and keys.
    first = next(iter(loader))
    model = init_params(GraphSAGE(first.x.shape[1], HIDDEN, classes))
    return ds, loader, create_train_state(model.to(args.device), adam(LR))


def main(argv: Optional[Sequence[str]] = None):
    """Returns ``(state, history)``: per epoch, the batches' losses."""
    import torch

    from ..models import make_train_step

    args = parse_args(argv)
    ds, loader, state = build(args)
    g = ds.get_graph()
    print(f"loaded from tables: {g.num_nodes} nodes, {g.num_edges} edges")
    step = make_train_step(BATCH)
    history: List[List[float]] = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        losses, accs = [], []
        for batch in loader:
            state, loss, acc = step(state, batch)
            losses.append(loss)
            accs.append(acc)
        host = torch.stack(losses + accs).float().cpu().numpy()
        nb = len(losses)
        history.append(host[:nb].tolist())
        print(f"epoch {epoch}: loss {host[:nb].mean():.4f} acc "
              f"{host[nb:].mean():.4f} ({time.perf_counter() - t0:.2f}s)")
    return state, history


if __name__ == "__main__":
    main()
