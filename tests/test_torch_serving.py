"""The slice as a whole: both packages serve the same requests on the
committed digits k-NN graph.

Both ``SubgraphEngine``s run ``ServingOptions(num_neighbors=(15, 10, 5),
seed_buckets=(8, 32, 128))`` over the same request lists (1-100 seeds,
overlapping, every bucket); each message compares key by key with ==.
Then ``message_to_batch`` and a 3-layer GraphSAGE whose parameters are
carried across by ``params_from_flax``: logits agree within
atol = rtol = 1e-5 in f32 (``segment_sum`` and ``index_add_`` sum in
different orders) and within 2e-2 of the logits' scale with bf16
matmuls (the two frameworks round bf16 at different places).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Graph as JaxGraph
from glt_tpu.distributed.sample_message import (
    message_to_batch as jax_message_to_batch,
)
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.serving.engine import SubgraphEngine as JaxEngine
from glt_tpu.serving.options import ServingOptions as JaxOptions
from glt_tpu_torch.data import CSRTopo, Dataset
from glt_tpu_torch.distributed import message_to_batch
from glt_tpu_torch.models import GraphSAGE, params_from_flax
from glt_tpu_torch.serving import BadRequest, ServingOptions, SubgraphEngine

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "digits-knn")
OPTS = dict(num_neighbors=(15, 10, 5), seed_buckets=(8, 32, 128))


def _load(name):
    return np.load(os.path.join(DATA, name + ".npy"))


def _request_lists():
    """Micro-batches of overlapping requests that land in every bucket."""
    rng = np.random.default_rng(0)
    n = 1797
    hot = rng.integers(0, n, 40)          # shared ids make requests overlap
    lists = [
        [hot[:3], np.concatenate([hot[1:4], [5]])],                 # 8
        [hot[:1]],                                                  # 8
        [rng.integers(0, n, 10), np.concatenate([hot[:6], hot[:6]]),
         rng.integers(0, n, 12)],                                   # 32
        [rng.integers(0, n, 50), np.concatenate([hot, hot[:10]])],  # 128
        [rng.permutation(n)[:100]],                                 # 128
    ]
    return lists


@pytest.fixture(scope="module")
def engines():
    indptr, indices = _load("indptr"), _load("indices")
    feat, labels = _load("feat"), _load("labels")
    jds = JaxDataset()
    jds.graph = JaxGraph(JaxTopo((indptr, indices), layout="CSR"))
    jds.init_node_features(feat)
    jds.init_node_labels(labels)
    tds = Dataset(device="cpu")
    tds.init_graph((indptr, indices), layout="CSR")
    tds.init_node_features(feat)
    tds.init_node_labels(labels)
    jeng, teng = JaxEngine(jds, JaxOptions(**OPTS)), SubgraphEngine(
        tds, ServingOptions(**OPTS))
    served = []
    for reqs in _request_lists():
        jl = [jeng.validate_seeds(r) for r in reqs]
        tl = [teng.validate_seeds(r) for r in reqs]
        jc, tc = jeng.sample(jl), teng.sample(tl)
        served.append((jc.bucket, tc.bucket, jeng.scatter(jc),
                       teng.scatter(tc)))
    return served


def test_every_bucket_served(engines):
    assert sorted({b for b, _, _, _ in engines}) == [8, 32, 128]
    assert all(jb == tb for jb, tb, _, _ in engines)


def test_messages_equal(engines):
    for _, _, jmsgs, tmsgs in engines:
        assert len(jmsgs) == len(tmsgs)
        for jm, tm in zip(jmsgs, tmsgs):
            assert sorted(jm) == sorted(tm)
            for k in jm:
                a, b = np.asarray(jm[k]), np.asarray(tm[k])
                assert a.dtype == b.dtype and a.shape == b.shape, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            # Loader contract: the request's seeds lead the node list.
            nb = tm["batch"].size
            np.testing.assert_array_equal(tm["node"][:nb], tm["batch"])


def test_warmup_matches_jax():
    """``warmup()`` builds every bucket on both engines and advances
    each bucket's key counter once, so the requests served after it give
    == messages; ``compiled_buckets()`` agree before and after."""
    indptr, indices = _load("indptr"), _load("indices")
    feat, labels = _load("feat"), _load("labels")
    jds = JaxDataset()
    jds.graph = JaxGraph(JaxTopo((indptr, indices), layout="CSR"))
    jds.init_node_features(feat)
    jds.init_node_labels(labels)
    tds = (Dataset(device="cpu").init_graph((indptr, indices), layout="CSR")
           .init_node_features(feat).init_node_labels(labels))
    jeng, teng = JaxEngine(jds, JaxOptions(**OPTS)), SubgraphEngine(
        tds, ServingOptions(**OPTS))
    assert teng.compiled_buckets() == jeng.compiled_buckets() == []
    jeng.warmup()
    teng.warmup()
    assert teng.compiled_buckets() == jeng.compiled_buckets() == [8, 32, 128]
    for reqs in _request_lists()[::2]:
        jmsgs = jeng.scatter(jeng.sample([jeng.validate_seeds(r)
                                          for r in reqs]))
        tmsgs = teng.scatter(teng.sample([teng.validate_seeds(r)
                                          for r in reqs]))
        assert len(jmsgs) == len(tmsgs)
        for jm, tm in zip(jmsgs, tmsgs):
            assert sorted(jm) == sorted(tm)
            for k in jm:
                np.testing.assert_array_equal(np.asarray(jm[k]), tm[k],
                                              err_msg=k)


def test_bf16_features_travel_as_raw_bits():
    """bf16 rows reach the message bit for bit: glt_tpu's ``x`` is
    bfloat16, the port's holds the same 16-bit patterns as uint16 (numpy
    has no bfloat16), and ``message_to_batch`` restores torch.bfloat16."""
    indptr, indices, feat = _load("indptr"), _load("indices"), _load("feat")
    jds = JaxDataset()
    jds.graph = JaxGraph(JaxTopo((indptr, indices), layout="CSR"))
    jds.init_node_features(feat, dtype=jnp.bfloat16)
    tds = Dataset(device="cpu")
    tds.init_graph((indptr, indices), layout="CSR")
    tds.init_node_features(feat, dtype=torch.bfloat16)
    jeng, teng = JaxEngine(jds, JaxOptions(**OPTS)), SubgraphEngine(
        tds, ServingOptions(**OPTS))
    reqs = _request_lists()[0]
    jmsgs = jeng.scatter(jeng.sample([jeng.validate_seeds(r) for r in reqs]))
    tmsgs = teng.scatter(teng.sample([teng.validate_seeds(r) for r in reqs]))
    assert len(jmsgs) == len(tmsgs) == len(reqs)
    for jm, tm in zip(jmsgs, tmsgs):
        assert sorted(jm) == sorted(tm)
        for k in jm:
            a, b = np.asarray(jm[k]), np.asarray(tm[k])
            if k == "x":
                assert a.dtype == jnp.bfloat16 and b.dtype == np.uint16
                a = a.view(np.uint16)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        x = message_to_batch(tm, device="cpu").x
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            x.view(torch.int16).numpy().view(np.uint16), tm["x"])


def _logits(engines, dtype_j, dtype_t):
    jmodel = JaxSAGE(hidden_features=32, out_features=10, num_layers=3,
                     dtype=dtype_j)
    x0 = jnp.zeros((4, 64), jnp.float32)
    ei0 = jnp.zeros((2, 3), jnp.int32)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, x0, ei0,
                         jnp.ones((3,), bool))
    tmodel = GraphSAGE(64, 32, 10, num_layers=3, dtype=dtype_t)
    tmodel.load_state_dict(params_from_flax(params))
    tmodel.eval()
    # The flax side runs every batch padded to one shape (zero rows,
    # masked -1 edges), so it compiles once; padding leaves the real
    # rows' logits unchanged.
    n_pad = 2048
    e_pad = max(m["row"].size for _, _, _, ms in engines for m in ms)
    apply = jax.jit(lambda p, x, ei, em: jmodel.apply(p, x, ei, em,
                                                      train=False))
    out = []
    for _, _, jmsgs, tmsgs in engines:
        for jm, tm in zip(jmsgs, tmsgs):
            jb = jax_message_to_batch(jm)
            tb = message_to_batch(tm, device="cpu")
            n, e = jb.x.shape[0], jb.edge_index.shape[1]
            ref = np.asarray(apply(
                params, jnp.pad(jb.x, ((0, n_pad - n), (0, 0))),
                jnp.pad(jb.edge_index, ((0, 0), (0, e_pad - e)),
                        constant_values=-1),
                jnp.pad(jb.edge_mask, (0, e_pad - e))))[:n]
            with torch.no_grad():
                got = tmodel(tb.x, tb.edge_index, tb.edge_mask).numpy()
            assert got.shape == ref.shape == (tm["node"].size, 10)
            out.append((ref, got))
    return out


def test_graphsage_logits_f32(engines):
    for ref, got in _logits(engines, None, None):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_graphsage_logits_bf16(engines):
    for ref, got in _logits(engines, jnp.bfloat16, torch.bfloat16):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 2e-2 * scale


def test_bad_requests():
    tds = Dataset(device="cpu")
    tds.init_graph((_load("indptr"), _load("indices")), layout="CSR")
    eng = SubgraphEngine(tds, ServingOptions(**OPTS))
    for bad in ([], [[1, 2]], [1797], [-1], [0.5], np.arange(101)):
        with pytest.raises(BadRequest):
            eng.validate_seeds(np.asarray(bad))
    with pytest.raises(BadRequest):
        eng.bucket_for(129)
    np.testing.assert_array_equal(eng.validate_seeds([5, 3, 5, 1]),
                                  [5, 3, 1])
