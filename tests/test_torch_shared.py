"""``share_dataset`` / ``attach_dataset`` and ``CSRTopo(edge_weights=)``
against ``glt_tpu``'s (cf. ``tests/test_dist_loader.py``'s shared-memory
case and ``glt_tpu/data/shared.py``): the round trip gives back every
array ``==``, edge weights included, the handle pickles to a few hundred
bytes, a spawned process maps the same pages, and the creator's unlink
frees them."""
import multiprocessing as mp
import pickle

import numpy as np
import pytest
import torch

from glt_tpu_torch.data import (CSRTopo, Dataset, attach_dataset,
                                share_dataset)
from glt_tpu_torch.data.shared import SharedArray

torch.set_num_threads(1)

N = 40


def _coo(seed=0, n=N, e=160):
    rng = np.random.default_rng(seed)
    return (np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]),
            rng.random(e).astype(np.float32))


def build(device="cpu"):
    ei, w = _coo()
    rng = np.random.default_rng(1)
    ds = Dataset(device=device)
    ds.graph = __import__("glt_tpu_torch.data", fromlist=["Graph"]).Graph(
        CSRTopo(ei, num_nodes=N, edge_weights=w), device=device)
    return (ds.init_node_features(rng.standard_normal((N, 6)).astype(
        np.float32), id2idx=rng.permutation(N))
        .init_edge_features(rng.standard_normal((160, 2)).astype(
            np.float32))
        .init_node_labels((np.arange(N) % 5).astype(np.int32)))


def test_edge_weights_follow_csr_order_as_glt_tpu():
    from glt_tpu.data import CSRTopo as JaxTopo

    ei, w = _coo()
    a, b = CSRTopo(ei, edge_weights=w), JaxTopo(ei, edge_weights=w)
    for f in ("indptr", "indices", "edge_ids", "edge_weights"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # each weight sits beside its own edge
    row, col = a.to_coo()
    np.testing.assert_array_equal(w[a.edge_ids], a.edge_weights)
    np.testing.assert_array_equal(ei[1][a.edge_ids], col)
    assert CSRTopo(ei).edge_weights is None
    t = CSRTopo.from_csr_arrays(a.indptr, a.indices, a.edge_ids,
                                a.edge_weights)
    assert t.edge_weights is a.edge_weights


def _same(a, b):
    ga, gb = a.get_graph(), b.get_graph()
    for f in ("indptr", "indices", "edge_ids", "edge_weights"):
        x, y = getattr(ga.topo, f), getattr(gb.topo, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("indptr", "indices", "edge_ids"):
        assert torch.equal(getattr(ga, f).long(), getattr(gb, f).long())
    ids = torch.tensor([0, 5, N - 1, -1, 7, 7])
    for fa, fb in ((a.get_node_feature(), b.get_node_feature()),
                   (a.get_edge_feature(), b.get_edge_feature())):
        assert torch.equal(fa.gather(ids), fb.gather(ids))
        np.testing.assert_array_equal(fa.cpu_get(ids.numpy()),
                                      fb.cpu_get(ids.numpy()))
    np.testing.assert_array_equal(a.get_node_label(), b.get_node_label())


@pytest.mark.parametrize("split_ratio", [0.0, None, 0.5])
def test_share_attach_roundtrip(split_ratio):
    ds = build()
    h = share_dataset(ds)
    try:
        blob = pickle.dumps(h)
        assert len(blob) < 2000
        h2 = pickle.loads(blob)
        back = attach_dataset(h2, split_ratio=split_ratio, device="cpu")
        _same(ds, back)
        f = back.get_node_feature()
        want = ds.get_node_feature().split_ratio if split_ratio is None \
            else split_ratio
        assert f.split_ratio == want
        assert f.hot_count == int(N * want)
        # The host rows are the shared pages themselves, not a copy.
        assert np.shares_memory(f._host_full,
                                h2.node_feats[None].rows.array)
    finally:
        h.unlink()


def test_attach_matches_glt_tpu_attach():
    """The same arrays through both packages' share/attach."""
    from glt_tpu.data import CSRTopo as JaxTopo
    from glt_tpu.data import Dataset as JaxDataset
    from glt_tpu.data import Graph as JaxGraph
    from glt_tpu.data import attach_dataset as jax_attach
    from glt_tpu.data import share_dataset as jax_share

    ei, w = _coo()
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((N, 6)).astype(np.float32)
    jds = JaxDataset()
    jds.graph = JaxGraph(JaxTopo(ei, num_nodes=N, edge_weights=w),
                         mode="HOST")
    jds.init_node_features(feat).init_node_labels(np.arange(N) % 5)
    pds = Dataset(device="cpu")
    pds.graph = __import__("glt_tpu_torch.data", fromlist=["Graph"]).Graph(
        CSRTopo(ei, num_nodes=N, edge_weights=w), device="cpu")
    pds.init_node_features(feat).init_node_labels(np.arange(N) % 5)
    jh, ph = jax_share(jds), share_dataset(pds)
    try:
        ja, pa = jax_attach(jh), attach_dataset(ph, device="cpu")
        for f in ("indptr", "indices", "edge_ids", "edge_weights"):
            np.testing.assert_array_equal(getattr(ja.get_graph().topo, f),
                                          getattr(pa.get_graph().topo, f))
        ids = np.array([3, 0, N - 1, -1])
        np.testing.assert_array_equal(
            ja.get_node_feature().cpu_get(ids),
            pa.get_node_feature().cpu_get(ids))
        np.testing.assert_array_equal(ja.node_labels, pa.node_labels)
    finally:
        jh.unlink()
        ph.unlink()


def test_hetero_roundtrip():
    from glt_tpu_torch.data import Dataset as D

    ei = {("u", "to", "i"): np.stack([np.arange(8), np.arange(8) % 3]),
          ("i", "rev", "u"): np.stack([np.arange(8) % 3, np.arange(8)])}
    ds = (D(device="cpu").init_graph(ei, num_nodes={"u": 8, "i": 3})
          .init_node_features({"u": np.ones((8, 2), np.float32),
                               "i": np.arange(6, dtype=np.float32)
                               .reshape(3, 2)})
          .init_node_labels({"u": np.arange(8) % 2}))
    h = share_dataset(ds)
    try:
        back = attach_dataset(pickle.loads(pickle.dumps(h)), device="cpu")
        assert back.is_hetero
        assert sorted(back.graph) == sorted(ds.graph)
        for et in ds.graph:
            np.testing.assert_array_equal(back.graph[et].topo.indices,
                                          ds.graph[et].topo.indices)
        for t in ("u", "i"):
            assert torch.equal(back.get_node_feature(t).gather(
                torch.arange(3)), ds.get_node_feature(t).gather(
                torch.arange(3)))
        np.testing.assert_array_equal(back.node_labels["u"],
                                      ds.node_labels["u"])
        no_labels = share_dataset(D(device="cpu").init_graph(
            ei, num_nodes={"u": 8, "i": 3}))
        assert attach_dataset(no_labels, device="cpu").node_labels is None
        no_labels.unlink()
    finally:
        h.unlink()


def _child_sum(handle, q):
    ds = attach_dataset(handle, device="cpu")
    f = ds.get_node_feature()
    q.put((float(f.cpu_get(np.arange(N)).sum()),
           int(ds.get_graph().topo.indices.sum()),
           float(ds.get_graph().topo.edge_weights.sum())))


def test_spawned_process_maps_the_same_pages():
    ds = build()
    h = share_dataset(ds)
    try:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=_child_sum, args=(h, q))
        p.start()
        got = q.get(timeout=120)
        p.join(timeout=60)
        assert p.exitcode == 0
        topo = ds.get_graph().topo
        assert got == (float(ds.get_node_feature().cpu_get(
            np.arange(N)).sum()), int(topo.indices.sum()),
            float(topo.edge_weights.sum()))
    finally:
        h.unlink()


def test_unlink_frees_segments():
    h = share_dataset(build())
    names = [a.name for a in h._arrays()]
    assert len(names) >= 8
    h.unlink()
    for name in names:
        with pytest.raises(FileNotFoundError):
            SharedArray.attach(name, (1,), np.uint8)


def test_store_backed_feature_cannot_be_shared(tmp_path):
    from glt_tpu_torch.data import Feature
    from glt_tpu_torch.store import DiskFeatureStore, write_feature_store

    write_feature_store(str(tmp_path / "st"), np.ones((10, 4), np.float32),
                        codec="raw", overwrite=True)
    ds = build()
    ds.node_features = Feature.from_store(
        DiskFeatureStore(str(tmp_path / "st")), 1 << 12, device="cpu")
    with pytest.raises(ValueError, match="store-backed"):
        share_dataset(ds)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_attach_on_cuda_without_a_card_raises():
    h = share_dataset(build())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            attach_dataset(h)
    finally:
        h.unlink()


def test_feature_mp_twin_on_the_cpu(capsys):
    from glt_tpu_torch.examples import feature_mp

    assert feature_mp.main(["--device", "cpu", "--workers", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("gather-correct=True") == 2
