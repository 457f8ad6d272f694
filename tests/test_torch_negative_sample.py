"""glt_tpu_torch's negative sampling against glt_tpu's on the CPU.

Same graphs, keys and weights on both sides.  ``==`` for the sorted
view, ``edge_in_csr`` (the port's searchsorted route and its plain
32-step search), ``uniform``/``randint``/``weighted_draw`` (given JAX's
cdf), ``weight_to_cdf`` (the port adds in XLA:CPU's order, so integer
and real weights alike give the same bits), the negative pairs (strict
and padded, uniform and weighted) and ``stitch_sample_results``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import Graph as JaxGraph
from glt_tpu.ops import negative_sample as jneg
from glt_tpu.ops.stitch import stitch_sample_results as jax_stitch
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Dataset, Graph
from glt_tpu_torch.ops import (
    edge_in_csr,
    edge_in_csr_plain,
    sample_negative_edges,
    stitch_sample_results,
    weight_to_cdf,
    weighted_draw,
)
from glt_tpu_torch.sampler import NegativeSampling

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _coo(seed=0, n=60, e=400, isolated=(0, 7, 59)):
    """Random COO with duplicate edges, unsorted columns and rows that
    have no edges."""
    rng = np.random.default_rng(seed)
    row, col = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = ~np.isin(row, isolated)
    return np.stack([row[keep], col[keep]]), n


def _graphs(seed=0, n=60, e=400):
    ei, n = _coo(seed, n, e)
    jg = JaxGraph(JaxTopo(ei, num_nodes=n), with_sorted_columns=True)
    tg = Graph(CSRTopo(ei, num_nodes=n), device="cpu")
    return jg, tg, ei, n


def _i32(a):
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.mark.parametrize("seed,n,e", [(0, 60, 400), (1, 40, 5), (2, 500, 40),
                                      (3, 200, 3000)])
def test_sorted_indices_matches_jax(seed, n, e):
    jg, tg, _, _ = _graphs(seed, n, e)
    got = tg.sorted_indices
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.sorted_indices))
    keys = tg.edge_keys
    assert keys.dtype == torch.int64 and bool((keys[1:] >= keys[:-1]).all())
    np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), got.numpy())
    np.testing.assert_array_equal((keys >> 32).numpy(), np.repeat(
        np.arange(n), np.diff(tg.topo.indptr)))


def test_sorted_view_built_at_init_or_first_use():
    ei, n = _coo()
    eager = Graph(CSRTopo(ei, num_nodes=n), device="cpu",
                  with_sorted_columns=True)
    assert eager._sorted_indices is not None
    lazy = Dataset(device="cpu").init_graph(ei, num_nodes=n).get_graph()
    assert lazy._sorted_indices is None
    assert torch.equal(lazy.sorted_indices, eager.sorted_indices)
    ds = Dataset(device="cpu").init_graph(ei, num_nodes=n,
                                          with_sorted_columns=True)
    assert ds.get_graph()._sorted_indices is not None


def _queries(ei, n, rng, k=600):
    """Real edges, random pairs, padding on either side, ids 0 and
    n - 1, empty rows, and ids past the last row."""
    real = ei[:, rng.integers(0, ei.shape[1], k // 3)] if ei.shape[1] else \
        np.zeros((2, 0), np.int64)
    rand = rng.integers(0, n, (2, k // 3))
    special = np.array([[-1, 3, -1, 0, n - 1, 0, n - 1, 7, 59 % n, n, n + 5,
                         2],
                        [4, -1, -1, 0, n - 1, n - 1, 0, 3, 1, 0, 2, n]])
    q = np.concatenate([real, rand, special], axis=1)
    return q[0], q[1]


@pytest.mark.parametrize("route", ["searchsorted", "plain"])
@pytest.mark.parametrize("seed,n,e", [(0, 60, 400), (1, 40, 5), (2, 500, 40),
                                      (3, 200, 3000)])
def test_edge_in_csr_matches_jax(route, seed, n, e):
    jg, tg, ei, n = _graphs(seed, n, e)
    qs, qd = _queries(ei, n, np.random.default_rng(seed + 10))
    want = np.asarray(jneg.edge_in_csr(jg.indptr, jg.sorted_indices,
                                       jnp.asarray(qs, jnp.int32),
                                       jnp.asarray(qd, jnp.int32)))
    if route == "plain":
        got = edge_in_csr_plain(tg.indptr, tg.sorted_indices, _i32(qs),
                                _i32(qd))
    else:
        got = edge_in_csr(tg.indptr, tg.sorted_indices, _i32(qs), _i32(qd),
                          tg.edge_keys)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if e:
        assert want.any() and not want.all()


@pytest.mark.parametrize("shape", [(7,), (3, 40), ()])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.1)])
def test_uniform_matches_jax(shape, lo, hi):
    for seed in (0, 9):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                             minval=lo, maxval=hi))
        got = trandom.uniform(trandom.PRNGKey(seed, device="cpu"), shape, lo,
                              hi)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_randint_matches_jax_at_negative_shapes():
    for seed, shape, hi in ((0, (5, 32), 60), (3, (5, 7), 1 << 20),
                            (4, (48,), 1)):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                             0, hi, dtype=jnp.int32))
        got = trandom.randint(trandom.PRNGKey(seed, device="cpu"), shape, 0,
                              hi)
        np.testing.assert_array_equal(got.numpy(), want)


def _weights(kind, n, rng):
    if kind == "integer":
        w = rng.integers(0, 4, n).astype(np.float32)
    else:
        w = rng.random(n).astype(np.float32) * (rng.random(n) < 0.6)
    w[0] = max(w[0], 1.0)
    return w


@pytest.mark.parametrize("n", [1, 16, 17, 300, 70_001])
@pytest.mark.parametrize("kind", ["integer", "real"])
def test_weight_to_cdf_matches_jax(kind, n):
    w = _weights(kind, n, np.random.default_rng(5))
    want = np.asarray(jneg.weight_to_cdf(w))
    got = weight_to_cdf(w).numpy()
    assert got.dtype == np.float32 and got[-1] == 1.0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # NegativeSampling caches its cdf per device.
    ns = NegativeSampling("binary", 1, weight=w)
    assert ns.cdf("cpu") is ns.cdf(torch.device("cpu"))
    assert torch.equal(ns.cdf("cpu"), weight_to_cdf(w))
    assert NegativeSampling("triplet", 2).cdf("cpu") is None


@pytest.mark.parametrize("kind", ["integer", "real"])
def test_weighted_draw_matches_jax(kind):
    cdf = jneg.weight_to_cdf(_weights(kind, 80, np.random.default_rng(6)))
    for seed, shape in ((0, (5, 64)), (2, (300,))):
        want = np.asarray(jneg.weighted_draw(jax.random.PRNGKey(seed), cdf,
                                             shape))
        got = weighted_draw(trandom.PRNGKey(seed, device="cpu"),
                            torch.from_numpy(np.array(cdf)), shape)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed,n,e,trials", [(0, 30, 250, 5), (2, 12, 120, 2),
                                             (3, 200, 3000, 5)])
def test_sample_negative_edges_matches_jax(padding, weighted, seed, n, e,
                                           trials):
    jg, tg, _, n = _graphs(seed, n, e)
    cdf = (jneg.weight_to_cdf(_weights("real", n, np.random.default_rng(seed)))
           if weighted else None)
    tcdf = None if cdf is None else torch.from_numpy(np.array(cdf))
    for k in (1, 8):
        want = jneg.sample_negative_edges(
            jg.indptr, jg.sorted_indices, 48, jax.random.PRNGKey(k), n,
            trials=trials, padding=padding, src_cdf=cdf, dst_cdf=cdf)
        got = sample_negative_edges(
            tg.indptr, tg.sorted_indices, 48, trandom.PRNGKey(k, device="cpu"),
            n, trials=trials, padding=padding, src_cdf=tcdf, dst_cdf=tcdf,
            edge_keys=tg.edge_keys)
        for name, a, b in zip(("src", "dst", "mask"), want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
        assert got.src.dtype == torch.int32 and got.mask.dtype == torch.bool
    if not padding and n == 12:
        assert not got.mask.all()     # dense graph: some slots stay empty


def test_sample_negative_edges_num_dst_nodes_matches_jax():
    jg, tg, _, n = _graphs(0, 60, 400)
    want = jneg.sample_negative_edges(jg.indptr, jg.sorted_indices, 32,
                                      jax.random.PRNGKey(3), n,
                                      num_dst_nodes=17)
    got = sample_negative_edges(tg.indptr, tg.sorted_indices, 32,
                                trandom.PRNGKey(3, device="cpu"), n,
                                num_dst_nodes=17, edge_keys=tg.edge_keys)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(got.dst.max()) < 17


@pytest.mark.parametrize("weight,err", [
    ([1.0, np.nan], "finite"), ([1.0, -1.0], ">= 0"),
    ([0.0, 0.0], "positive sum")])
def test_negative_sampling_validates_weight_as_jax(weight, err):
    with pytest.raises(ValueError, match=err):
        JaxNegativeSampling("binary", 1, weight=weight)
    with pytest.raises(ValueError, match=err):
        NegativeSampling("binary", 1, weight=weight)
    with pytest.raises(ValueError):
        NegativeSampling("ternary", 1)
    ns = NegativeSampling("Triplet", 2.4)
    assert ns.is_triplet() and ns.sample_count(10) == 24


def test_stitch_matches_jax():
    rng = np.random.default_rng(0)
    idx = [np.array([3, -1, 0, 5]), np.array([1, 2, -1]), np.array([4, 6])]
    nbrs = [rng.integers(-1, 50, (len(i), 3)) for i in idx]
    eids = [rng.integers(-1, 90, (len(i), 3)) for i in idx]
    want = jax_stitch(8, [jnp.asarray(i, jnp.int32) for i in idx],
                      [jnp.asarray(a, jnp.int32) for a in nbrs],
                      [jnp.asarray(a, jnp.int32) for a in eids])
    got = stitch_sample_results(8, [_i32(i) for i in idx],
                                [_i32(a) for a in nbrs],
                                [_i32(a) for a in eids])
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (got[0][7] == -1).all()
