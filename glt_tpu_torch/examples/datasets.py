"""Synthetic datasets of the port's examples (cf. ``examples/datasets.py``):
the same numpy recipes, so a seed gives the same arrays in both
packages.  Nothing is downloaded."""
from __future__ import annotations

import numpy as np

from ..data import Dataset
from ..data.topology import csr_to_coo
from ..utils.device import DeviceLike


def synthetic_products(scale: float = 0.01, dim: int = 100,
                       num_classes: int = 47, seed: int = 0,
                       device: DeviceLike = None):
    """ogbn-products-shaped graph (2.45M nodes, 12 out-edges a node at
    scale 1.0), ~70 % of the edges within a node's class, features the
    class embedding plus noise.  Returns ``(dataset, train ids)``."""
    rng = np.random.default_rng(seed)
    n = max(1000, int(2_449_029 * scale))
    deg = 12
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    indptr = (np.arange(n + 1) * deg).astype(np.int64)
    targets = rng.integers(0, n, (n, deg), dtype=np.int64)
    same_mask = rng.random((n, deg)) < 0.7
    # Redirect same-class picks to a random member of the same class.
    class_members = [np.flatnonzero(labels == c) for c in range(num_classes)]
    for c in range(num_classes):
        rows = np.flatnonzero(labels == c)
        picks = rng.choice(class_members[c], size=(rows.shape[0], deg))
        targets[rows] = np.where(same_mask[rows], picks, targets[rows])
    indices = targets.reshape(-1)
    feat = (np.eye(num_classes, dtype=np.float32)[labels]
            @ rng.normal(0, 1, (num_classes, dim)).astype(np.float32))
    feat += rng.normal(0, 0.5, (n, dim)).astype(np.float32)
    ds = (Dataset(device=device)
          .init_graph((indptr.astype(np.int32), indices.astype(np.int32)),
                      layout="CSR")
          .init_node_features(feat)
          .init_node_labels(labels))
    train_idx = rng.permutation(n)[: int(n * 0.1)]
    return ds, train_idx


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


def _synthetic_citation_hetero(node_counts, relations, scale, seed,
                               device, label_type="paper", classes=8):
    """Citation-shaped hetero graph: ``node_counts`` maps a type to
    ``(floor, base)``, its count ``max(floor, base * scale)``;
    ``relations`` holds ``(src_t, rel, dst_t, degree, reversed_rel)``,
    each source node linking to ``degree`` uniform destinations, and the
    reverse edge type added where ``reversed_rel`` is set.  Labels live
    on ``label_type``, whose features are noisy one-hot labels; the
    other types' features are noise.  Returns ``(dataset, train ids,
    classes)``."""
    rng = np.random.default_rng(seed)
    n = {t: max(floor, int(base * scale))
         for t, (floor, base) in node_counts.items()}
    ei = {}
    for src_t, rel, dst_t, deg, rev in relations:
        src = np.repeat(np.arange(n[src_t]), deg)
        dst = rng.integers(0, n[dst_t], n[src_t] * deg)
        edges = np.stack([src, dst])
        ei[(src_t, rel, dst_t)] = edges
        if rev is not None:
            ei[(dst_t, rev, src_t)] = edges[::-1]
    labels = rng.integers(0, classes, n[label_type]).astype(np.int32)
    feats = {t: rng.normal(size=(c, classes)).astype(np.float32)
             for t, c in n.items()}
    feats[label_type] = (np.eye(classes, dtype=np.float32)[labels]
                         + feats[label_type] * 0.3)
    ds = (Dataset(device=device)
          .init_graph(ei, num_nodes=n)
          .init_node_features(feats)
          .init_node_labels({label_type: labels}))
    return ds, np.arange(n[label_type]), classes


def synthetic_igbh(scale: float = 1.0, seed: int = 0,
                   device: DeviceLike = None):
    """IGBH-shaped hetero graph: paper (1,000 x scale, cites 4 papers),
    author (800 x scale, writes 3 papers), institute (80 x scale, one
    affiliation an author), the reverse of each cross-type relation, 8
    classes on papers."""
    return _synthetic_citation_hetero(
        {"paper": (200, 1000), "author": (150, 800), "institute": (20, 80)},
        [("paper", "cites", "paper", 4, None),
         ("author", "writes", "paper", 3, "rev_writes"),
         ("author", "affiliated", "institute", 1, "rev_affiliated")],
        scale, seed, device)


def synthetic_mag(scale: float = 1.0, seed: int = 0,
                  device: DeviceLike = None):
    """OGB-MAG-shaped hetero graph: paper (1,500 x scale), author (1,000
    x scale), institution (100 x scale) and field_of_study (200 x scale)
    with MAG's four relations (cites 4, writes 3, affiliated_with 1,
    has_topic 2 a source node) and the reverses of the cross-type ones,
    8 venue classes on papers."""
    return _synthetic_citation_hetero(
        {"paper": (300, 1500), "author": (200, 1000),
         "institution": (30, 100), "field_of_study": (50, 200)},
        [("paper", "cites", "paper", 4, None),
         ("author", "writes", "paper", 3, "rev_writes"),
         ("author", "affiliated_with", "institution", 1,
          "rev_affiliated_with"),
         ("paper", "has_topic", "field_of_study", 2, "rev_has_topic")],
        scale, seed, device)
