"""glt_tpu_torch.ops.unique against glt_tpu.ops.unique, compared with ==.

Inputs: duplicate-heavy, all-unique and all-padding id vectors, plus a
multi-call induce sequence (the sampler's hop loop).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.ops import unique as jun
from glt_tpu_torch.ops import unique as tun

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N = 50


def _inputs():
    rng = np.random.default_rng(0)
    dup = rng.integers(0, 6, 40).astype(np.int32)
    dup[rng.random(40) < 0.25] = -1
    return {
        "duplicate_heavy": dup,
        "all_unique": rng.permutation(N)[:40].astype(np.int32),
        "all_padding": np.full((40,), -1, np.int32),
        "one": np.array([7], np.int32),
        "mixed": rng.integers(-1, N, 40).astype(np.int32),
    }


INPUTS = _inputs()


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_unique_first_occurrence(name):
    ids = INPUTS[name]
    j = jun.unique_first_occurrence(jnp.asarray(ids))
    t = tun.unique_first_occurrence(torch.from_numpy(ids))
    _eq(j.uniques, t.uniques)
    _eq(j.inverse, t.inverse)
    _eq(j.count, t.count)
    assert t.uniques.dtype == t.inverse.dtype == torch.int32


def _induce_seq(mod, names, final, to):
    state = (mod.dense_induce_init(N, 200) if mod is jun
             else mod.dense_induce_init(N, 200, device="cpu"))
    locals_ = []
    for i, name in enumerate(names):
        fn = (mod.dense_induce_final if final and i == len(names) - 1
              else mod.dense_induce)
        state, local = fn(state, to(INPUTS[name]))
        locals_.append(local)
    return state, locals_


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("names", [
    ("duplicate_heavy",), ("all_unique",), ("all_padding",),
    ("one", "duplicate_heavy", "mixed"),
    ("all_unique", "all_padding", "duplicate_heavy"),
])
def test_dense_induce(names, final):
    js, jl = _induce_seq(jun, names, final, jnp.asarray)
    ts, tl = _induce_seq(tun, names, final, torch.from_numpy)
    for a, b in zip(jl, tl):
        _eq(a, b)
    _eq(js.node_buf, ts.node_buf)
    _eq(js.count, ts.count)
    if not final:      # the final inducer leaves `seen` stale by contract
        _eq(js.seen, ts.seen)


def test_dense_map_fits_and_band_guard():
    assert tun.dense_map_fits(1000) == jun.dense_map_fits(1000)
    assert tun.dense_map_fits(1 << 29) == jun.dense_map_fits(1 << 29)
    state = tun.dense_induce_init(4, 4, device="cpu")
    too_wide = torch.empty(tun._PROV_BASE, dtype=torch.int32)
    with pytest.raises(ValueError):
        tun.dense_induce(state, too_wide)
