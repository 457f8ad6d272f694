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
