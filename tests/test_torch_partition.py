"""glt_tpu_torch.partition and NeighborSampler.sample_prob against
glt_tpu's, on the CPU.

Both packages partition the same graph (the frequency partitioner from
the same ``probs`` arrays) into two directories whose files must be
equal array for array and whose ``META.json`` must be equal byte for
byte; each package loads the other's directory; the relabel, the cache
merge and the residency scores compare with ``==``.  ``sample_prob``
divides once, as ``glt_tpu`` does, so on the CPU it is ``==`` to
``glt_tpu``'s, and each package partitioning from its own probs writes
the same files; the 1e-6 test stays as the bound a card run (atomic
``index_add_``) is held to.
"""
import os

import numpy as np
import pytest
import torch

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import Graph as JaxGraph
from glt_tpu import partition as jpart
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu_torch import partition as tpart
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.sampler import NeighborSampler

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, PARTS, FANOUTS = 1500, 4, [5, 3]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    deg = np.minimum(rng.zipf(1.7, N), 60)
    src = np.repeat(np.arange(N), deg)
    dst = rng.integers(0, N, src.size)
    perm = rng.permutation(src.size)
    ei = np.stack([src[perm], dst[perm]])
    feat = rng.standard_normal((N, 8)).astype(np.float32)
    efeat = rng.standard_normal((ei.shape[1], 3)).astype(np.float32)
    eids = rng.permutation(ei.shape[1]) + 100
    train = rng.choice(N, 300, replace=False)
    sampler = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                              FANOUTS)
    probs = [sampler.sample_prob(train[r::PARTS], N).numpy()
             for r in range(PARTS)]
    return ei, feat, efeat, eids, train, probs


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_dirs(a, b):
    fa, fb = _files(a), _files(b)
    assert fa == fb
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            with open(pa, "rb") as fa_, open(pb, "rb") as fb_:
                assert fa_.read() == fb_.read(), f


def _partition(pkg, cls, root, data, strategy, chunk, **kw):
    ei, feat, efeat, eids, _, _ = data
    getattr(pkg, cls)(str(root), PARTS, N, ei, edge_ids=eids, node_feat=feat,
                      edge_feat=efeat, edge_assign_strategy=strategy,
                      chunk_size=chunk, **kw).partition()
    return str(root)


@pytest.mark.parametrize("strategy", ["by_src", "by_dst"])
@pytest.mark.parametrize("chunk", [97, 1000])
def test_random_partitioner_files_equal(tmp_path, data, strategy, chunk):
    a = _partition(jpart, "RandomPartitioner", tmp_path / "j", data,
                   strategy, chunk, seed=3)
    b = _partition(tpart, "RandomPartitioner", tmp_path / "t", data,
                   strategy, chunk, seed=3)
    _same_dirs(a, b)


@pytest.mark.parametrize("cache_ratio", [0.0, 0.2])
@pytest.mark.parametrize("strategy", ["by_src", "by_dst"])
@pytest.mark.parametrize("chunk", [97, 1000])
def test_frequency_partitioner_files_equal(tmp_path, data, cache_ratio,
                                          strategy, chunk):
    probs = data[-1]
    kw = {"probs": probs, "cache_ratio": cache_ratio}
    a = _partition(jpart, "FrequencyPartitioner", tmp_path / "j", data,
                   strategy, chunk, **kw)
    b = _partition(tpart, "FrequencyPartitioner", tmp_path / "t", data,
                   strategy, chunk, **kw)
    _same_dirs(a, b)
    if cache_ratio:
        assert np.load(os.path.join(b, "part0/node_feat/cache_ids.npy")).size


def _same_load(jl, tl):
    (jg, jnf, jef, jnpb, jepb, jmeta) = jl
    (tg, tnf, tef, tnpb, tepb, tmeta) = tl
    assert jmeta == tmeta
    for x, y in ((jg.edge_index, tg.edge_index), (jg.eids, tg.eids),
                 (jnpb, tnpb), (jepb, tepb)):
        np.testing.assert_array_equal(x, y)
    for jf, tf in ((jnf, tnf), (jef, tef)):
        assert (jf is None) == (tf is None)
        if jf is not None:
            for x, y in zip(jf, tf):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_load_partition_and_cache_across_packages(tmp_path, data, writer):
    """A directory written by either package loads equal in both, and
    cat_feature_cache merges equal."""
    pkg = jpart if writer == "jax" else tpart
    root = _partition(pkg, "FrequencyPartitioner", tmp_path / writer, data,
                      "by_src", 200, probs=data[-1], cache_ratio=0.1)
    for p in range(PARTS):
        jl = jpart.load_partition(root, p)
        tl = tpart.load_partition(root, p)
        _same_load(jl, tl)
        jf, ji = jpart.cat_feature_cache(jl[1], N)
        tf, ti = tpart.cat_feature_cache(tl[1], N)
        np.testing.assert_array_equal(jf, tf)
        np.testing.assert_array_equal(ji, ti)


def test_residency_scores_equal(data):
    probs = data[-1]
    for normalize in (True, False):
        np.testing.assert_array_equal(
            jpart.residency_scores(probs, normalize),
            tpart.residency_scores(probs, normalize))


@pytest.mark.parametrize("hotness", ["none", "probs", "ties"])
def test_contiguous_relabel_equal(data, hotness):
    ei, feat = data[0], data[1]
    rng = np.random.default_rng(4)
    node_pb = rng.integers(0, PARTS, N).astype(np.int32)
    hot = {"none": None, "probs": np.sum(data[-1], axis=0),
           "ties": rng.integers(0, 3, N)}[hotness]
    j = jpart.contiguous_relabel(node_pb, hotness=hot, num_parts=PARTS)
    t = tpart.contiguous_relabel(node_pb, hotness=hot, num_parts=PARTS)
    np.testing.assert_array_equal(j.old2new, t.old2new)
    np.testing.assert_array_equal(j.new2old, t.new2old)
    assert (j.nodes_per_shard, j.num_parts) == (t.nodes_per_shard,
                                                t.num_parts)
    jt = jpart.relabel_topology(JaxTopo(ei, num_nodes=N), j)
    tt = tpart.relabel_topology(CSRTopo(ei, num_nodes=N), t)
    for f in ("indptr", "indices", "edge_ids"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    np.testing.assert_array_equal(jpart.relabel_rows(feat, j),
                                  tpart.relabel_rows(feat, t))
    lab = rng.integers(0, 5, N)
    np.testing.assert_array_equal(jpart.relabel_rows(lab, j, fill=-1),
                                  tpart.relabel_rows(lab, t, fill=-1))


@pytest.mark.parametrize("fanouts", [[5, 3], [2, 2, 2]])
def test_sample_prob_within_1e6(data, fanouts):
    ei, train = data[0], data[4]
    js = JaxSampler(JaxGraph(JaxTopo(ei, num_nodes=N)), fanouts)
    ts = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                         fanouts)
    for seeds in (train[:50], train):
        want = np.asarray(js.sample_prob(seeds, N + 7))
        got = ts.sample_prob(seeds, N + 7).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got[N:] == 0).all() and got.max() == 1.0


@pytest.mark.parametrize("fanouts", [[5, 3], [15, 10, 5], [2, 2, 2]])
def test_sample_prob_equals_jax(data, fanouts):
    """One division a hop, as ``glt_tpu``'s: ``==`` on the CPU."""
    ei, train = data[0], data[4]
    js = JaxSampler(JaxGraph(JaxTopo(ei, num_nodes=N)), fanouts)
    ts = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                         fanouts)
    for seeds in (train[:50], train):
        want = np.asarray(js.sample_prob(seeds, N))
        got = ts.sample_prob(seeds, N).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["by_src", "by_dst"])
def test_frequency_partitions_from_own_probs_equal(tmp_path, data, strategy):
    """Each package computes its own probs and partitions from them at
    ``cache_ratio=0.2``: the two directories are equal."""
    ei, train = data[0], data[4]
    js = JaxSampler(JaxGraph(JaxTopo(ei, num_nodes=N)), FANOUTS)
    jprobs = [np.asarray(js.sample_prob(train[r::PARTS], N))
              for r in range(PARTS)]
    tprobs = data[-1]
    a = _partition(jpart, "FrequencyPartitioner", tmp_path / "j", data,
                   strategy, 97, probs=jprobs, cache_ratio=0.2)
    b = _partition(tpart, "FrequencyPartitioner", tmp_path / "t", data,
                   strategy, 97, probs=tprobs, cache_ratio=0.2)
    _same_dirs(a, b)
    assert np.load(os.path.join(b, "part0/node_feat/cache_ids.npy")).size
