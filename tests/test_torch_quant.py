"""glt_tpu_torch.store.quant against glt_tpu.store.quant, on the CPU.

Encoded bytes compare with == (int8 codes; bf16 as 16-bit patterns,
against ``ml_dtypes``' rounding), specs and manifests with ==, and the
decode with == against JAX's ``quant.dequantize`` on the CPU and the
host ``quant.decode``.  One documented exception: XLA:CPU flushes
subnormals (ROADMAP queue C), so where a column's scale is subnormal JAX's
device decode differs from its own host decode; the port follows the
host decode (and so does kernel B4 on the card, built without
flush-to-zero), and the test holds every other element to ==.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from glt_tpu.store import quant as jq
from glt_tpu_torch.store import quant as tq

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

TINY = np.finfo(np.float32).tiny


def _matrix(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((257, 37)).astype(np.float32)
    if kind == "zipf":
        x = rng.zipf(1.5, (300, 16)).astype(np.float32)
        return np.minimum(x, 1e6) * rng.choice([-1.0, 1.0], (300, 16))
    if kind == "constant_columns":
        x = rng.standard_normal((64, 9)).astype(np.float32)
        x[:, 0] = 3.25
        x[:, 4] = 0.0
        x[:, 8] = -0.0
        return x
    if kind == "signed_zeros":
        x = rng.standard_normal((40, 6)).astype(np.float32)
        x[::3, :] = -0.0
        x[1::3, :] = 0.0
        return x
    if kind == "subnormals":
        x = rng.standard_normal((50, 5)).astype(np.float32)
        x[:, 0] = [1e-40, -1e-40, TINY, 1e-44, -0.0] * 10
        x[:, 1] = rng.standard_normal(50).astype(np.float32) * 1e-39
        return x
    if kind == "rows_1":
        return rng.standard_normal((1, 7)).astype(np.float32)
    if kind == "dim_1":
        return rng.standard_normal((33, 1)).astype(np.float32)
    raise ValueError(kind)


KINDS = ["normal", "zipf", "constant_columns", "signed_zeros", "subnormals",
         "rows_1", "dim_1"]


def _bits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
def test_encode_bytes_and_spec_equal(kind, codec):
    x = _matrix(kind)
    ej, sj = jq.encode(x, codec)
    et, st = tq.encode(x, codec)
    assert np.asarray(et).dtype == tq.storage_dtype(codec, x.dtype)
    np.testing.assert_array_equal(_bits(et), _bits(ej))
    assert np.asarray(et).tobytes() == np.asarray(ej).tobytes()
    assert st.codec == sj.codec and st.logical_dtype == sj.logical_dtype
    if codec == "int8":
        np.testing.assert_array_equal(st.scale.view(np.uint32),
                                      sj.scale.view(np.uint32))
        np.testing.assert_array_equal(st.zero.view(np.uint32),
                                      sj.zero.view(np.uint32))
        np.testing.assert_array_equal(tq.zero_point(st), jq.zero_point(sj))
    assert tq.spec_to_manifest(st) == jq.spec_to_manifest(sj)
    np.testing.assert_array_equal(tq.scale_zero_rows(st, x.shape[1]),
                                  jq.scale_zero_rows(sj, x.shape[1]))


def test_bf16_bits_equal_ml_dtypes_on_every_class():
    """Finite values of every exponent, +-0, +-inf, subnormals and NaNs
    (whose bits ml_dtypes sets to sign | 0x7fc0)."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    x = np.concatenate([bits.view(np.float32), np.float32(
        [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, TINY, 1e-45,
         3.4028235e38, -3.4028235e38, 3.3961776e38, np.nan, -np.nan])])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tq.bf16_bits(x), want)
    # float64 input rounds like ml_dtypes' direct float64 cast
    x64 = rng.standard_normal(10_000) * 10.0 ** rng.integers(-30, 30, 10_000)
    np.testing.assert_array_equal(
        tq.bf16_bits(x64), x64.astype(ml_dtypes.bfloat16).view(np.uint16))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_dequantize_equals_jax(kind, codec):
    x = _matrix(kind)
    ej, sj = jq.encode(x, codec)
    et, st = tq.encode(x, codec)
    want = np.asarray(jq.dequantize(jnp.asarray(ej), sj))
    host = jq.decode(ej, sj)
    got = tq.dequantize(tq.host_to_torch(et), st)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.uint32), host.view(np.uint32))
    np.testing.assert_array_equal(tq.decode(et, st).view(np.uint32),
                                  host.view(np.uint32))
    diff = got.view(np.uint32) != want.view(np.uint32)
    if codec == "int8" and kind == "subnormals":
        # XLA:CPU flushes subnormal operands and results (ROADMAP queue
        # C): a subnormal scale reads as 0, so `scale > 0` fails there.
        # Every differing element lies in such a column or is subnormal.
        sub_col = (sj.scale > 0) & (sj.scale < TINY)
        explained = sub_col[None, :] | (np.abs(got) < TINY)
        assert diff.any() and not (diff & ~explained).any()
    else:
        assert not diff.any()


def test_dequantize_rows_is_the_kernel_plain_formula():
    """dequantize == dequantize_rows over scale_zero_rows, and the int8
    decode is add-then-multiply, never multiply-then-add."""
    x = _matrix("normal")
    for codec in ("bf16", "int8"):
        et, st = tq.encode(x, codec)
        t = tq.host_to_torch(et)
        sz = torch.from_numpy(tq.scale_zero_rows(st, x.shape[1]))
        assert torch.equal(tq.dequantize(t, st), tq.dequantize_rows(t, sz))
    et, st = tq.encode(x, "int8")
    k = torch.from_numpy(tq.zero_point(st))
    s = torch.from_numpy(st.scale)
    want = (torch.from_numpy(et).float() + k) * s
    assert torch.equal(tq.dequantize(torch.from_numpy(et), st), want)


@pytest.mark.parametrize("kind", ["normal", "zipf", "dim_1"])
def test_int8_error_within_half_step(kind):
    x = _matrix(kind)
    et, st = tq.encode(x, "int8")
    dq = tq.dequantize(torch.from_numpy(et), st).numpy().astype(np.float64)
    bound = st.scale.astype(np.float64) / 2
    slack = np.abs(dq) * 2.0**-23
    assert (np.abs(x - dq) <= bound[None, :] + slack).all()


def test_constant_columns_exact_and_signed_zero_kept():
    x = _matrix("constant_columns")
    et, st = tq.encode(x, "int8")
    assert (et[:, [0, 4, 8]] == 0).all() and (st.scale[[0, 4, 8]] == 0).all()
    dq = tq.dequantize(torch.from_numpy(et), st).numpy()
    np.testing.assert_array_equal(dq[:, 0], 3.25)
    eb, sb = tq.encode(_matrix("signed_zeros"), "bf16")
    wide = tq.dequantize(tq.host_to_torch(eb), sb).numpy()
    np.testing.assert_array_equal(np.signbit(wide),
                                  np.signbit(_matrix("signed_zeros")))


@pytest.mark.parametrize("codec", ["raw", "bf16", "int8"])
def test_manifests_cross_read(codec):
    x = _matrix("normal")
    _, sj = jq.encode(x, codec)
    _, st = tq.encode(x, codec)
    man_j = {"dtype": "<f4", **jq.spec_to_manifest(sj)}
    man_t = {"dtype": "<f4", **tq.spec_to_manifest(st)}
    back_t = tq.spec_from_manifest(man_j)
    back_j = jq.spec_from_manifest(man_t)
    assert back_t.codec == back_j.codec == codec
    if codec == "int8":
        np.testing.assert_array_equal(back_t.scale, back_j.scale)
        np.testing.assert_array_equal(back_t.zero, back_j.zero)
    assert tq.spec_from_manifest({"dtype": "<f4"}).codec == "raw"
    with pytest.raises(ValueError):
        tq.spec_from_manifest({"dtype": "<f4", "codec": "fp4"})
    with pytest.raises(ValueError):
        tq.storage_dtype("fp4", np.float32)


def test_encode_with_spec_streams_like_whole():
    x = _matrix("normal")
    for codec in ("bf16", "int8"):
        whole, spec = tq.encode(x, codec)
        parts = np.concatenate([tq.encode_with_spec(x[i:i + 50], spec)
                                for i in range(0, x.shape[0], 50)])
        np.testing.assert_array_equal(parts, whole)
