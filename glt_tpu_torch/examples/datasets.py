"""Synthetic datasets of the port's examples (cf. ``examples/datasets.py``):
the same numpy recipes, so a seed gives the same arrays in both
packages.  Nothing is downloaded."""
from __future__ import annotations

import numpy as np

from ..data import Dataset
from ..data.topology import csr_to_coo
from ..utils.device import DeviceLike


def synthetic_ppi(scale: float = 1.0, dim: int = 50, seed: int = 0,
                  device: DeviceLike = None):
    """PPI-shaped graph for unsupervised link prediction: ``max(500,
    14,755 * scale)`` nodes of out-degree 14 to uniform neighbors and
    standard-normal ``dim``-wide features, the column-sorted view built.
    Returns ``(dataset, edge_index [2, E])``."""
    rng = np.random.default_rng(seed)
    n = max(500, int(14_755 * scale))
    deg = 14
    indptr = (np.arange(n + 1) * deg).astype(np.int64)
    indices = rng.integers(0, n, n * deg, dtype=np.int64)
    feat = rng.normal(size=(n, dim)).astype(np.float32)
    ds = (Dataset(device=device)
          .init_graph((indptr.astype(np.int32), indices.astype(np.int32)),
                      layout="CSR", with_sorted_columns=True)
          .init_node_features(feat))
    topo = ds.get_graph().topo
    src, dst = csr_to_coo(topo.indptr, topo.indices)
    return ds, np.stack([src, dst])
