"""The port's tiered Feature against glt_tpu's, on the CPU.

``Feature.gather`` compares with == (f32 bits; bf16 by its 16-bit
patterns) over every combination of split_ratio {0, 0.5, 1}, codec
raw/bf16/int8 (through ``Feature.from_store``), dedup, id2index and the
cold cache, over a sequence of batches with duplicates, padding and ids
of both tiers; the cold cache's hit/miss counters, the tier byte
counters and ``cpu_get`` compare with ==.  ``fused_frontier(dequant=)``
is held to JAX's fallback (``force="xla"``) with ==, and
``Dataset.init_node_features`` at split_ratio < 1 to JAX's hotness
reorder.  Kernels B4 and B5 are held against their plain versions on the
card in ``test_torch_kernels.py``.
"""
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data.feature import Feature as JaxFeature
from glt_tpu.ops.fused_frontier import fused_frontier as jax_fused
from glt_tpu.store import DiskFeatureStore as JaxStore
from glt_tpu.store import quant as jq
from glt_tpu_torch.data import Dataset, Feature
from glt_tpu_torch.ops import (
    fused_frontier,
    fused_frontier_dequant_cuda,
    gather_cuda,
    gather_rows_dequant_cuda,
)
from glt_tpu_torch.ops.gather_dequant_cuda import gather_rows_dequant_plain
from glt_tpu_torch.store import DiskFeatureStore, quant, write_feature_store

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, D = 200, 24


def _features(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[:, 5] = -2.0                          # a constant column
    x[::7, 3] = -0.0
    return x


def _batches(seed=1, k=4, b=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        ids = rng.integers(-1, N, b)
        ids[:8] = rng.integers(0, 10, 8)   # repeats (cache hits)
        out.append(ids.astype(np.int32))
    return out


def _np(x):
    """jax/torch rows -> comparable numpy bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiers")
    x = _features()
    return {c: write_feature_store(str(root / c), x, codec=c)
            for c in ("raw", "bf16", "int8")}


@pytest.mark.parametrize("cache", [False, True])
@pytest.mark.parametrize("with_id2index", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
@pytest.mark.parametrize("split", [0.0, 0.5, 1.0])
def test_gather_equals_jax(stores, split, codec, dedup, with_id2index,
                           cache):
    perm = (np.random.default_rng(2).permutation(N).astype(np.int32)
            if with_id2index else None)
    budget = 30 * D * 4
    jf = JaxFeature.from_store(JaxStore(stores[codec]), budget,
                               split_ratio=split, id2index=perm, dedup=dedup)
    tf = Feature.from_store(DiskFeatureStore(stores[codec]), budget,
                            split_ratio=split, id2index=perm, dedup=dedup,
                            device="cpu")
    try:
        assert tf.hot_count == jf.hot_count
        if cache:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                jf.enable_cold_cache(40)
                tf.enable_cold_cache(40)
        b4 = gather_rows_dequant_cuda.launches
        for ids in _batches():
            want = jf.gather(jnp.asarray(ids))
            got = tf.gather(ids if split < 1 else torch.from_numpy(ids))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_np(got), _np(want))
        assert gather_rows_dequant_cuda.launches == b4   # CPU: plain
        assert tf.cache_stats() == jf.cache_stats()
        assert tf.bytes_from_hbm == jf.bytes_from_hbm
        s_t, s_j = tf.store_stats(), jf.store_stats()
        assert s_t == s_j
        probe = np.array([0, N - 1, -1, 17, 17, 150], np.int32)
        np.testing.assert_array_equal(
            np.asarray(tf.cpu_get(probe)).view(np.uint32),
            np.asarray(jf.cpu_get(probe), np.float32).view(np.uint32))
    finally:
        jf.close()
        tf.close()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("split", [0.0, 0.5, 1.0])
def test_array_feature_equals_jax(split, dtype):
    """The DRAM-resident tiered Feature (no store), raw rows cast to the
    gather dtype on the host as in glt_tpu."""
    x = _features(3)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jf = JaxFeature(x, split_ratio=split, dtype=jdt)
    tf = Feature(x, split_ratio=split, dtype=tdt, device="cpu")
    for ids in _batches(4):
        np.testing.assert_array_equal(_np(tf.gather(ids)),
                                      _np(jf.gather(jnp.asarray(ids))))
    np.testing.assert_array_equal(tf.cpu_get(np.array([3, -1, 199])),
                                  jf.cpu_get(np.array([3, -1, 199])))


def test_dataset_hotness_reorder_equals_jax():
    from glt_tpu_torch.data import CSRTopo

    rng = np.random.default_rng(5)
    indptr = np.zeros(N + 1, np.int64)
    np.cumsum(rng.integers(0, 9, N), out=indptr[1:])
    indices = rng.zipf(1.3, int(indptr[-1])) % N
    x = _features(6)
    jds = JaxDataset().init_graph((indptr, indices), layout="CSR")
    jds.init_node_features(x, split_ratio=0.3)
    tds = Dataset(device="cpu").init_graph((indptr, indices), layout="CSR")
    tds.init_node_features(x, split_ratio=0.3)
    jf, tf = jds.get_node_feature(), tds.get_node_feature()
    np.testing.assert_array_equal(tf.id2index.numpy(),
                                  np.asarray(jf.id2index))
    assert tf.hot_count == jf.hot_count == int(N * 0.3)
    ids = np.concatenate([np.arange(N), [-1, -1]]).astype(np.int32)
    np.testing.assert_array_equal(_np(tf.gather(ids)),
                                  _np(jf.gather(jnp.asarray(ids))))
    assert tf.bytes_from_hbm == jf.bytes_from_hbm
    topo = CSRTopo.from_csr_arrays(indptr, indices)
    np.testing.assert_array_equal(topo.in_degrees(),
                                  np.bincount(indices, minlength=N))


@pytest.mark.parametrize("with_id2index", [False, True])
@pytest.mark.parametrize("kind", ["duplicates", "all_padding", "clamped",
                                  "empty"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_fused_frontier_dequant_equals_jax_fallback(codec, kind,
                                                     with_id2index):
    rng = np.random.default_rng(7)
    x = _features(8)
    enc, spec_t = quant.encode(x, codec)
    enc_j, spec_j = jq.encode(x, codec)
    b = 0 if kind == "empty" else 90
    if kind == "duplicates":
        ids = rng.integers(-1, 12, b)
    elif kind == "all_padding":
        ids = np.full(b, -1)
    else:
        ids = rng.integers(-1, N + 20, b)
    ids = ids.astype(np.int32)
    perm = (rng.permutation(N).astype(np.int32) if with_id2index
            else None)
    ref = jax_fused(jnp.asarray(enc_j), jnp.asarray(ids),
                    id2index=None if perm is None else jnp.asarray(perm),
                    force="xla", dequant=spec_j)
    b5 = fused_frontier_dequant_cuda.launches
    got = fused_frontier(quant.host_to_torch(enc), torch.from_numpy(ids),
                         id2index=None if perm is None
                         else torch.from_numpy(perm), dequant=spec_t)
    assert fused_frontier_dequant_cuda.launches == b5
    assert got.features.dtype == torch.float32
    np.testing.assert_array_equal(got.unique_ids.numpy(),
                                  np.asarray(ref.unique_ids))
    np.testing.assert_array_equal(got.inverse.numpy(),
                                  np.asarray(ref.inverse))
    np.testing.assert_array_equal(_np(got.features), _np(ref.features))
    # B5's plain version gives the same bits as the fallback.
    from glt_tpu_torch.ops import fused_frontier_dequant_plain, frontier_plan

    _, inv, uidx = frontier_plan(
        torch.from_numpy(ids),
        None if perm is None else torch.from_numpy(perm))
    sz = torch.from_numpy(quant.scale_zero_rows(spec_t, D))
    assert torch.equal(fused_frontier_dequant_plain(
        quant.host_to_torch(enc), uidx, inv, sz), got.features)


@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
def test_gather_rows_seam_routes_by_spec(codec):
    """``gather_rows(dequant=)``: a compressed spec decodes (B4's plain
    version on the CPU), a raw spec or None is the plain gather (B2's),
    and int8 tables gather raw as bytes."""
    x = _features(9)
    enc, spec = quant.encode(x, codec)
    table = quant.host_to_torch(enc)
    idx = torch.tensor([0, 5, N + 3, -2, 5], dtype=torch.int32)
    b2 = gather_cuda.gather_rows_cuda.launches
    raw = gather_cuda.gather_rows(table, idx)
    assert raw.dtype == table.dtype
    assert torch.equal(raw, table[[0, 5, N - 1, 0, 5]])
    got = gather_cuda.gather_rows(table, idx, dequant=spec)
    assert gather_cuda.gather_rows_cuda.launches == b2
    if codec == "raw":
        assert torch.equal(got, raw)
    else:
        sz = torch.from_numpy(quant.scale_zero_rows(spec, D))
        assert torch.equal(got, gather_rows_dequant_plain(table, idx, sz))
        want = jq.decode(jq.encode(x, codec)[0], spec)[[0, 5, N - 1, 0, 5]]
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_cache_gather_equals_jax():
    """``cache_gather`` over a sequence of unique-id batches: rows,
    hit/miss counters and the resident set == glt_tpu's."""
    from glt_tpu.data.feature_cache import cache_gather as jax_cg
    from glt_tpu.data.feature_cache import cache_init as jax_init
    from glt_tpu.data.feature_cache import cache_stats as jax_stats
    from glt_tpu_torch.data import cache_gather, cache_init, cache_stats

    x = _features(11)
    jt, tt = jnp.asarray(x), torch.from_numpy(x)

    def jfetch(ids):
        return jnp.where((ids >= 0)[:, None],
                         jt[jnp.clip(ids, 0, N - 1)], 0)

    def tfetch(ids):
        return torch.where((ids >= 0)[:, None],
                           tt[ids.clamp(0, N - 1).long()], 0)

    js, ts = jax_init(N, 24, D), cache_init(N, 24, D, device="cpu")
    rng = np.random.default_rng(12)
    for _ in range(6):
        ids = rng.choice(40, 30, replace=False).astype(np.int32)
        ids[rng.random(30) < 0.2] = -1
        js, jrows = jax_cg(js, jnp.asarray(ids), jfetch)
        ts, trows = cache_gather(ts, torch.from_numpy(ids), tfetch)
        np.testing.assert_array_equal(_np(trows), _np(jrows))
        assert cache_stats(ts) == jax_stats(js)
        np.testing.assert_array_equal(ts.slot_ids.numpy(),
                                      np.asarray(js.slot_ids))
        np.testing.assert_array_equal(ts.id2slot.numpy(),
                                      np.asarray(js.id2slot))
