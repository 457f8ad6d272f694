"""Row gathers of glt_tpu_torch against glt_tpu's XLA arm, with ==.

``gather_rows`` and ``dedup_gather_rows`` for d in {1, 3, 64, 100, 128},
f32 and bf16, with id2index, out-of-range and padding ids, and
``Feature.gather`` with and without dedup.  On the CPU the gather is
kernel B2's plain version (tests/test_torch_kernels.py holds the kernel
against it on the card).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu.data.feature import Feature as JaxFeature
from glt_tpu.ops.dedup_gather import dedup_gather_rows as jax_dedup
from glt_tpu.ops.gather_pallas import gather_rows as jax_gather
from glt_tpu_torch.data.feature import Feature
from glt_tpu_torch.ops import gather_cuda
from glt_tpu_torch.ops.dedup_gather import dedup_gather_rows

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

WIDTHS = [1, 3, 64, 100, 128]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
N = 40


def _table(d, seed=0):
    rng = np.random.default_rng(seed + d)
    return rng.standard_normal((N, d)).astype(np.float32)


def _ids(seed=0, b=57):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 12, b).astype(np.int32)      # duplicate-heavy
    ids[::7] = -1                                      # padding
    ids[3 % b], ids[10 % b] = N + 5, N - 1             # out of range, last
    return ids


def _to_np(x):
    """jax/torch array -> float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _jt(table, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(table, jdt), torch.from_numpy(table).to(tdt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
def test_gather_rows(d, dt):
    jtab, ttab = _jt(_table(d), dt)
    idx = _ids()
    ref = jax_gather(jtab, jnp.asarray(idx), force="xla")
    got = gather_cuda.gather_rows(ttab, torch.from_numpy(idx))
    assert got.dtype == ttab.dtype and got.shape == (idx.size, d)
    np.testing.assert_array_equal(_to_np(ref), _to_np(got))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("with_id2index", [False, True])
def test_dedup_gather_rows(d, dt, with_id2index):
    jtab, ttab = _jt(_table(d), dt)
    idx = _ids(1)
    idx[5] = N + 9                      # out of range through id2index
    i2i = np.random.default_rng(3).permutation(N).astype(np.int32)
    ref = jax_dedup(jtab, jnp.asarray(idx),
                    id2index=jnp.asarray(i2i) if with_id2index else None,
                    force="xla")
    got = dedup_gather_rows(ttab, torch.from_numpy(idx),
                            id2index=(torch.from_numpy(i2i)
                                      if with_id2index else None))
    np.testing.assert_array_equal(_to_np(ref), _to_np(got))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dt", [None, "bf16"])
@pytest.mark.parametrize("with_id2index", [False, True])
def test_feature_gather(dedup, dt, with_id2index):
    table = _table(100)
    i2i = np.random.default_rng(5).permutation(N).astype(np.int32)
    i2i = i2i if with_id2index else None
    jf = JaxFeature(table, id2index=i2i, dedup=dedup,
                    dtype=None if dt is None else DTYPES[dt][0])
    tf = Feature(table, id2index=i2i, dedup=dedup, device="cpu",
                 dtype=None if dt is None else DTYPES[dt][1])
    idx = _ids(2)
    np.testing.assert_array_equal(_to_np(jf.gather(idx)),
                                  _to_np(tf.gather(idx)))
    np.testing.assert_array_equal(
        _to_np(jf.gather(jnp.asarray(idx))),
        _to_np(tf.gather(torch.from_numpy(idx))))
    assert (tf.gather(idx)[idx < 0] == 0).all()


def test_feature_contract():
    # split_ratio < 1 is ported: half the rows in the device tier, half
    # on the host (held to glt_tpu in test_torch_feature_tiers.py).
    tiered = Feature(_table(4), split_ratio=0.5, device="cpu")
    assert tiered.hot_count == N // 2
    ids = np.array([0, N - 1, -1, N // 2], np.int32)
    want = np.where((ids >= 0)[:, None], _table(4)[np.maximum(ids, 0)], 0)
    np.testing.assert_array_equal(tiered.gather(ids).numpy(), want)
    with pytest.raises(OverflowError):
        Feature(_table(4), device="cpu").gather(
            np.array([2**40], np.int64))
    f = Feature(_table(4).astype(np.float64), device="cpu")
    assert f.dtype == torch.float32 and f.shape == (N, 4)


def test_gather_cuda_refuses_cpu_tensors():
    before = gather_cuda.gather_rows_cuda.launches
    gather_cuda.gather_rows(torch.zeros(4, 2),
                            torch.zeros(3, dtype=torch.int32))
    assert gather_cuda.gather_rows_cuda.launches == before
    with pytest.raises(ValueError):
        gather_cuda.gather_rows_cuda(torch.zeros(4, 2),
                                     torch.zeros(3, dtype=torch.int32))
