"""glt_tpu_torch.random against jax.random: the same uint32 streams.

The port's threefry is the bit-identity anchor of every sampler test, so
each case compares with ``==``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu_torch import random as trandom

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

SEEDS = [0, 1, 2**31 - 1]
MAXVALS = [1, 2, 7, 2**31 - 1]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 7)]


def _eq(a, b):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), (a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _eq(jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu"))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 5, (2, 3)])
def test_split(seed, num):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    _eq(jax.random.split(jk, num), trandom.split(tk, num))
    # Second generation: split of split.
    _eq(jax.random.split(jax.random.split(jk, 3)[1], num),
        trandom.split(trandom.split(tk, 3)[1], num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 12345, 2**31 - 1])
def test_fold_in(seed, data):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    _eq(jax.random.fold_in(jk, data), trandom.fold_in(tk, data))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_vectorized(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    data = np.array([0, 3, 17, 2**31 - 1, 1797], np.int32)
    ref = jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(data))
    _eq(ref, trandom.fold_in(tk, torch.from_numpy(data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("maxval", MAXVALS)
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_scalar_maxval(seed, maxval, shape):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    ref = jax.random.randint(jk, shape, 0, maxval, dtype=jnp.int32)
    _eq(ref, trandom.randint(tk, shape, 0, maxval))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_array_maxval(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    rng = np.random.default_rng(seed % 1000)
    maxval = np.array(MAXVALS * 5, np.int32).reshape(4, 5)
    rng.shuffle(maxval.reshape(-1))
    ref = jax.random.randint(jk, (4, 5), 0, jnp.asarray(maxval),
                             dtype=jnp.int32)
    _eq(ref, trandom.randint(tk, (4, 5), 0, torch.from_numpy(maxval)))
    # Row-broadcast bound, as the with-replacement draw uses it.
    col = maxval[:, :1]
    ref = jax.random.randint(jk, (4, 5), 0, jnp.asarray(col),
                             dtype=jnp.int32)
    _eq(ref, trandom.randint(tk, (4, 5), 0, torch.from_numpy(col)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(-5, 9), (3, 3), (7, 2),
                                    (-2**31, 2**31 - 1)])
def test_randint_minval(seed, bounds):
    lo, hi = bounds
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    ref = jax.random.randint(jk, (9,), lo, hi, dtype=jnp.int32)
    _eq(ref, trandom.randint(tk, (9,), lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_batched_keys(seed):
    """A key batch ``[K, 2]`` matches ``jax.vmap`` over keys."""
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    jks, tks = jax.random.split(jk, 6), trandom.split(tk, 6)
    m = np.array([1, 2, 7, 2**31 - 1, 100, 3], np.int32)
    ref = jax.vmap(lambda k, b: jax.random.randint(
        k, (), 0, b, dtype=jnp.int32))(jks, jnp.asarray(m))
    _eq(ref, trandom.randint(tks, (), 0, torch.from_numpy(m)))
    ref = jax.vmap(lambda k, b: jax.random.randint(
        k, (4,), 0, b, dtype=jnp.int32))(jks, jnp.asarray(m))
    _eq(ref, trandom.randint(tks, (4,), 0, torch.from_numpy(m)[:, None]))
    nested = jax.vmap(lambda k: jax.random.split(k, 3))(jks)
    _eq(nested, trandom.split(tks, 3))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("plain", [False, True])
def test_routing_functions_match_jax_on_cpu_keys(seed, plain):
    """``split`` and ``fold_in`` route a CUDA key to the hash kernel; a
    CPU key (or ``plain=True``) takes the plain arithmetic, which stays
    ``==`` to ``jax.random`` for a Python-int and a tensor ``data``, for
    one key and for a key batch."""
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    _eq(jax.random.split(jk, 4), trandom.split(tk, 4, plain=plain))
    for data in (0, 7, 2**31 - 1, 2**32 + 9, -1):
        _eq(jax.random.fold_in(jk, data % 2**32),
            trandom.fold_in(tk, data, plain=plain))
    ids = np.array([0, 5, 1797, 2**31 - 1], np.int32)
    for dtype in (torch.int32, torch.int64):
        _eq(jax.vmap(jax.random.fold_in, (None, 0))(jk, jnp.asarray(ids)),
            trandom.fold_in(tk, torch.from_numpy(ids).to(dtype),
                            plain=plain))
    jks, tks = jax.random.split(jk, 3), trandom.split(tk, 3)
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, 12))(jks),
        trandom.fold_in(tks, 12, plain=plain))
    _eq(jax.vmap(lambda k: jax.random.split(k, (2, 5)))(jks),
        trandom.split(tks, (2, 5), plain=plain))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_plain_matches_jax(seed):
    """The hash kernel's plain version: ``[K, D, 2]`` words of the iota
    (``split``), of a tensor and of a Python int (``fold_in``)."""
    from glt_tpu_torch.ops import threefry_hash_plain

    jks = jax.random.split(jax.random.PRNGKey(seed), 3)
    tks = trandom.split(trandom.PRNGKey(seed, device="cpu"), 3)
    _eq(jax.vmap(lambda k: jax.random.split(k, 6))(jks),
        threefry_hash_plain(tks, n=6))
    data = np.array([3, 0, 2**31 - 1], np.int32)
    _eq(jax.vmap(lambda k: jax.vmap(jax.random.fold_in, (None, 0))(
        k, jnp.asarray(data)))(jks),
        threefry_hash_plain(tks, data=torch.from_numpy(data)))
    _eq(jax.vmap(lambda k: jax.random.fold_in(k, 41))(jks)[:, None],
        threefry_hash_plain(tks, data=41))
    with pytest.raises(ValueError):
        threefry_hash_plain(tks)


def _no_host_copies(monkeypatch):
    """Make the two host->device tensor constructors raise: Python-number
    bounds must become device fills, which a CUDA graph can capture."""
    def refuse(*a, **k):
        raise AssertionError("a bound went through a host copy")
    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0, 7), (-5, 9), (7, 2),
                                    (-2**31, 2**31 - 1),
                                    (np.int64(3), np.int32(1000))])
def test_randint_device_built_bounds(monkeypatch, seed, bounds):
    """Scalar bounds built on the key's device, with no host copy, stay
    ``==`` to ``jax.random.randint``."""
    lo, hi = bounds
    ref = jax.random.randint(jax.random.PRNGKey(seed), (3, 4), int(lo),
                             int(hi), dtype=jnp.int32)
    tk = trandom.PRNGKey(seed, device="cpu")
    _no_host_copies(monkeypatch)
    got = trandom.randint(tk, (3, 4), lo, hi)
    monkeypatch.undo()
    _eq(ref, got)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.5, 2.7), (0.3, 0.30001),
                                    (1e-3, 5e3)])
def test_uniform_device_built_bounds(monkeypatch, seed, bounds):
    """``uniform``'s bounds as device fills, with no host copy, stay
    ``==`` to ``jax.random.uniform``."""
    lo, hi = bounds
    ref = jax.random.uniform(jax.random.PRNGKey(seed), (5, 3), jnp.float32,
                             lo, hi)
    tk = trandom.PRNGKey(seed, device="cpu")
    _no_host_copies(monkeypatch)
    got = trandom.uniform(tk, (5, 3), lo, hi)
    monkeypatch.undo()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
