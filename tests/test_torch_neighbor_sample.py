"""glt_tpu_torch.ops.neighbor_sample against glt_tpu's XLA arm.

Same graph, seeds and key through both packages; ``nbrs``, ``eids`` and
``mask`` compare with ``==``.  On the CPU the hop (the draw and the
neighbor read) is kernel B1's plain version (tests/test_torch_kernels.py
holds the kernel against it on the card).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glt_tpu.ops.neighbor_sample import lookup_degrees as jax_degrees
from glt_tpu.ops.neighbor_sample import sample_neighbors as jax_sample
from glt_tpu_torch import random as trandom
from glt_tpu_torch.ops import sample_cuda
from glt_tpu_torch.ops.neighbor_sample import lookup_degrees
from glt_tpu_torch.ops.neighbor_sample import sample_neighbors

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _graph(seed=0, n=64):
    """CSR with a degree-0 row, small rows, and a hub far above fanout."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 9, n)
    deg[0], deg[1], deg[2], deg[n - 1] = 0, 3, 300, 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1])) + 1000
    return indptr, indices, edge_ids


# One width for every set, so jax compiles each op once.
SEED_SETS = {
    "mixed": np.array([0, 1, 2, 5, -1, 2, 63, 7, 1, 30], np.int32),
    "hub": np.array([2, 2, 2, 2, 2, 2, 2, 2, 2, 2], np.int32),
    "padding": np.full((10,), -1, np.int32),
    "deg0": np.array([0, 63, 0, 0, 63, 0, 0, 63, 0, 0], np.int32),
}
COMBOS = list(itertools.product([False, True], [False, True],
                                ["slot", "id"], [False, True]))


def _both(indptr, indices, edge_ids, seeds, fanout, seed, **kw):
    jout = jax_sample(jnp.asarray(indptr, jnp.int32),
                      jnp.asarray(indices, jnp.int32), jnp.asarray(seeds),
                      fanout, jax.random.PRNGKey(seed),
                      edge_ids=(None if edge_ids is None
                                else jnp.asarray(edge_ids, jnp.int32)),
                      force="xla", **kw)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    tout = sample_neighbors(t(indptr), t(indices), t(seeds), fanout,
                            trandom.PRNGKey(seed, device="cpu"),
                            edge_ids=None if edge_ids is None else t(edge_ids),
                            **kw)
    return jout, tout


def _eq(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("with_replacement,with_edge,key_by,explicit",
                         COMBOS)
@pytest.mark.parametrize("seed_set", sorted(SEED_SETS))
def test_sample_neighbors_matches_jax(with_replacement, with_edge, key_by,
                                      explicit, seed_set):
    indptr, indices, edge_ids = _graph()
    for fanout, key_seed in ((4, 0), (15, 7)):
        jout, tout = _both(indptr, indices, edge_ids if explicit else None,
                           SEED_SETS[seed_set], fanout, key_seed,
                           with_replacement=with_replacement,
                           with_edge=with_edge, key_by=key_by)
        _eq(jout.nbrs, tout.nbrs)
        _eq(jout.eids, tout.eids)
        _eq(jout.mask, tout.mask)
        assert tout.nbrs.dtype == torch.int32


EDGE_FANOUTS = (4, 15, 40)


def _edge_graph(n=96):
    """CSR with rows of degree F - 1, F and F + 1 for every fanout of
    ``EDGE_FANOUTS``, a hub above the widest, and a degree-0 last row."""
    rng = np.random.default_rng(1)
    deg = rng.integers(0, 9, n)
    special = [0, 400] + [d for f in EDGE_FANOUTS for d in (f - 1, f, f + 1)]
    deg[:len(special)] = special
    deg[n - 1] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1])) + 1000
    # every special row, padding, the empty last row, ids past the end
    seeds = np.array(list(range(len(special))) + [-1, n - 1, n, n + 3, 1],
                     np.int32)
    return indptr, indices, edge_ids, seeds


@pytest.mark.parametrize("with_replacement,with_edge,key_by,explicit",
                         COMBOS)
@pytest.mark.parametrize("fanout", EDGE_FANOUTS)
def test_sample_neighbors_matches_jax_at_degree_edges(
        with_replacement, with_edge, key_by, explicit, fanout):
    """deg == F and deg == F + 1 (the edges of Floyd's branch), fanout 40
    (past one warp's lanes on the card), in all four draw modes."""
    indptr, indices, edge_ids, seeds = _edge_graph()
    jout, tout = _both(indptr, indices, edge_ids if explicit else None,
                       seeds, fanout, 11, with_replacement=with_replacement,
                       with_edge=with_edge, key_by=key_by)
    _eq(jout.nbrs, tout.nbrs)
    _eq(jout.eids, tout.eids)
    _eq(jout.mask, tout.mask)


def test_degree_cases_and_lookup():
    """deg 0, deg < fanout (full row in CSR order), hub (distinct picks)."""
    indptr, indices, _ = _graph()
    seeds = np.array([0, 1, 2, -1], np.int32)
    _, tout = _both(indptr, indices, None, seeds, 5, 3)
    mask = tout.mask.numpy()
    assert not mask[0].any() and not mask[3].any()
    np.testing.assert_array_equal(tout.nbrs.numpy()[1, :3],
                                  indices[indptr[1]:indptr[1] + 3])
    assert (tout.nbrs.numpy()[1, 3:] == -1).all()
    hub = tout.eids.numpy()[2]
    assert len(set(hub.tolist())) == 5
    assert ((hub >= indptr[2]) & (hub < indptr[3])).all()
    t = torch.from_numpy(indptr.astype(np.int32))
    s = torch.from_numpy(seeds)
    np.testing.assert_array_equal(
        np.asarray(jax_degrees(jnp.asarray(indptr, jnp.int32),
                               jnp.asarray(seeds))),
        lookup_degrees(t, s).numpy())


def test_fanout_must_be_positive():
    indptr, indices, _ = _graph()
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    with pytest.raises(ValueError):
        sample_neighbors(t(indptr), t(indices), t([1]), 0,
                         trandom.PRNGKey(0, device="cpu"))


def test_plain_read_is_the_cpu_path():
    """On CPU tensors the hop takes B1's plain version and never touches
    the kernel library; the kernel's wrapper refuses CPU tensors."""
    before = sample_cuda.sample_neighbors_cuda.launches
    indptr, indices, _ = _graph()
    _, tout = _both(indptr, indices, None, SEED_SETS["mixed"], 4, 0)
    assert sample_cuda.sample_neighbors_cuda.launches == before
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    plain = sample_cuda.sample_neighbors_plain(
        t(indptr), t(indices), t(SEED_SETS["mixed"]), 4,
        trandom.PRNGKey(0, device="cpu"))
    for a, b in zip(tout, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        z = torch.zeros(3, dtype=torch.int32)
        sample_cuda.sample_neighbors_cuda(
            z, z, z, 4, trandom.PRNGKey(0, device="cpu"))
