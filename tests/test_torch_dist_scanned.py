"""glt_tpu_torch's scanned distributed step, its seed blocks and its
epoch function against glt_tpu's, on the CPU.

The setup of ``tests/test_fused_epoch.py``'s distributed half: a
64-node graph whose edges stay within a class, 4 shards, batches of 4
seeds a shard, fanout (3, 3), GraphSAGE 16 x 2 without dropout, Adam
1e-2.  Both packages start from the same parameters
(``params_from_flax``).  The per-slot batches are equal, so the per-slot
losses, accuracies and the final parameters compare within 1e-5 (the
port takes the backward of the mean of the shard losses, ``glt_tpu``
the mean of the shard gradients; optax and torch place Adam's bias
correction differently), and the step counts and seed blocks with
``==``.  Against the port's own steps the comparisons are exact: a
padded slot leaves the state as the real slot alone leaves it, and the
epoch function equals a manual block loop.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.parallel import shard_feature as jax_shard_feature
from glt_tpu.parallel import shard_graph as jax_shard_graph
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo
from glt_tpu_torch.models import GraphSAGE, adam, params_from_flax
from glt_tpu_torch.parallel import (
    Mesh,
    dist_seed_blocks,
    init_dist_state,
    make_dist_train_step,
    make_scanned_dist_train_step,
    run_scanned_dist_epoch,
    shard_feature,
    shard_graph,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, S, CLASSES, DIM, HIDDEN, LR = 64, 4, 4, 8, 16, 1e-2
BS, FANOUTS = 4, [3, 3]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    labels = (np.arange(N) % CLASSES).astype(np.int32)
    src, dst = [], []
    for c in range(CLASSES):
        members = np.where(labels == c)[0]
        for i in members:
            for j in rng.choice(members, 3, replace=False):
                src.append(i)
                dst.append(j)
    ei = np.stack([np.array(src), np.array(dst)])
    feat = np.concatenate(
        [np.eye(CLASSES, dtype=np.float32)[labels],
         rng.normal(0, .1, (N, DIM - CLASSES)).astype(np.float32)], 1)
    jg = jax_shard_graph(JaxTopo(ei, num_nodes=N), S)
    jf = jax_shard_feature(feat, S)
    jlab = jnp.asarray(labels.reshape(S, -1))
    tg = shard_graph(CSRTopo(ei, num_nodes=N), S, device="cpu")
    tf = shard_feature(feat, S, device="cpu")
    tlab = torch.from_numpy(labels.reshape(S, -1))
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=len(FANOUTS), dropout_rate=0.0)
    tx = optax.adam(LR)
    jstate0 = jdt.init_dist_state(jm, tx, jg, jf, jax.random.PRNGKey(0),
                                  FANOUTS, BS)
    return dict(jg=jg, jf=jf, jlab=jlab, tg=tg, tf=tf, tlab=tlab, jm=jm,
                tx=tx, jstate0=jstate0,
                jmesh=JaxMesh(np.array(jax.devices()[:S]), ("shard",)))


def _tstate(d):
    tm = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=len(FANOUTS),
                   dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(d["jstate0"].params))
    return init_dist_state(tm, adam(LR), d["tg"], d["tf"], FANOUTS, BS)


def _tstep(d, scanned=True, **kw):
    make = make_scanned_dist_train_step if scanned else make_dist_train_step
    return make(d["tg"], d["tf"], d["tlab"], Mesh(["cpu"] * S), FANOUTS, BS,
                **kw)


def _jstep(d, **kw):
    return jdt.make_scanned_dist_train_step(
        d["jm"], d["tx"], d["jg"], d["jf"], d["jlab"], d["jmesh"], FANOUTS,
        BS, **kw)


def _real_batch(rng):
    """One batch of BS seeds per shard, each from the shard's own nodes."""
    c = N // S
    return np.stack([rng.choice(np.arange(s * c, (s + 1) * c), BS,
                                replace=False) for s in range(S)])


def _assert_params(jparams, model, tol=1e-5):
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                   rtol=tol, err_msg=k)


def _assert_same_state(a, b):
    """Two port states equal bit for bit: parameters, Adam's state and
    the step counter."""
    assert a.step == b.step
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


# (port knobs, glt_tpu knobs): the plain gather, the dedup gather (with
# leaf blocks, whose repeats it dedups), and the port's B3 serve (its
# plain version here), which glt_tpu's unfused serve equals.
_CASES = {
    "plain": ({}, {}),
    "dedup": ({"dedup_gather": True, "last_hop_dedup": False},
              {"dedup_gather": True, "last_hop_dedup": False}),
    "fused_frontier": ({"fused_frontier": True}, {}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_scanned_dist_step_matches_jax(setup, case):
    tkw, jkw = _CASES[case]
    rng = np.random.default_rng(1)
    blk = np.stack([_real_batch(rng) for _ in range(3)]).astype(np.int64)
    jst, jl, ja = _jstep(setup, **jkw)(setup["jstate0"], blk,
                                       jax.random.PRNGKey(17))
    step = _tstep(setup, **tkw)
    assert step.collective_bytes == _jstep(setup, **jkw).collective_bytes
    tst, tl, ta = step(_tstate(setup), blk,
                       trandom.PRNGKey(17, device="cpu"))
    assert tl.shape == ta.shape == (3,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    assert tst.step == int(jst.step) == 3
    _assert_params(jst.params, tst.model)


@pytest.mark.parametrize("pad_at", [0, 1])
def test_padded_slot_is_a_noop(setup, pad_at):
    """A slot with no real seed on any shard: its loss and accuracy are
    0, and the state is the one the real slot alone gives (the eager
    step under that slot's key), in the port bit for bit and against
    glt_tpu within 1e-5."""
    real = _real_batch(np.random.default_rng(2))
    blk = np.full((2, S, BS), -1, np.int64)
    blk[1 - pad_at] = real
    key = trandom.PRNGKey(3, device="cpu")
    st, losses, accs = _tstep(setup)(_tstate(setup), blk, key)
    assert st.step == 1
    assert float(losses[pad_at]) == float(accs[pad_at]) == 0.0
    assert float(losses[1 - pad_at]) > 0
    alone, loss, _ = _tstep(setup, scanned=False)(
        _tstate(setup), real, trandom.split(key, 2)[1 - pad_at])
    assert float(loss) == float(losses[1 - pad_at])
    _assert_same_state(st, alone)
    jst, jl, _ = _jstep(setup)(setup["jstate0"], blk, jax.random.PRNGKey(3))
    assert int(jst.step) == 1 and float(jl[pad_at]) == 0.0
    _assert_params(jst.params, st.model)
    # An all-padded block moves nothing.
    before = copy.deepcopy(st.model.state_dict())
    st2, l2, _ = _tstep(setup)(st, np.full((2, S, BS), -1), key)
    assert st2.step == 1 and l2.tolist() == [0.0, 0.0]
    for k, v in st2.model.state_dict().items():
        assert torch.equal(v, before[k])


def test_dist_seed_blocks_equal_jax():
    train_idx = np.arange(100) * 3
    a = list(jdt.dist_seed_blocks(train_idx, S, BS, 2,
                                  np.random.default_rng(7)))
    b = list(dist_seed_blocks(train_idx, S, BS, 2,
                              np.random.default_rng(7)))
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape == (2, S, BS)
        np.testing.assert_array_equal(x, y)


def test_run_scanned_dist_epoch_trims_and_resumes(setup):
    """40 seeds at 4 shards x 4 seeds: 3 real slots in 2 blocks of 2.
    The epoch function equals a manual block loop, glt_tpu's within 1e-5,
    and a run resumed at block 1 the uninterrupted run."""
    G, train_idx = 2, np.arange(40)
    base = trandom.PRNGKey(5, device="cpu")
    step = _tstep(setup)
    st, losses, accs = run_scanned_dist_epoch(
        step, _tstate(setup), train_idx, S, BS, G, np.random.default_rng(7),
        base)
    assert losses.shape == accs.shape == (3,) and st.step == 3
    jst, jl, ja = jdt.run_scanned_dist_epoch(
        _jstep(setup), setup["jstate0"], train_idx, S, BS, G,
        np.random.default_rng(7), jax.random.PRNGKey(5))
    np.testing.assert_allclose(losses, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(accs, ja, atol=1e-6)
    assert int(jst.step) == 3
    _assert_params(jst.params, st.model)

    manual, m_losses, seen = _tstate(setup), [], []
    for i, blk in enumerate(dist_seed_blocks(train_idx, S, BS, G,
                                             np.random.default_rng(7))):
        manual, ls, _ = step(manual, blk, trandom.fold_in(base, i))
        m_losses += ls.tolist()
        if i == 0:
            resumed = copy.deepcopy(manual)
    assert losses.tolist() == m_losses[:3]
    _assert_same_state(st, manual)

    hooks = []
    st_r, l_r, _ = run_scanned_dist_epoch(
        step, resumed, train_idx, S, BS, G, np.random.default_rng(7), base,
        start_block=1, on_block=lambda s, i: hooks.append((s.step, i)))
    assert hooks == [(3, 1)]
    assert l_r.tolist() == losses[2:].tolist()
    _assert_same_state(st_r, st)


def test_scanned_step_refuses_what_is_not_ported(setup):
    """``hier_load_factor`` is taken (on this 1-D mesh the route is flat
    and the byte model glt_tpu's); a block of the wrong shape or on the
    device raises before any work."""
    assert _tstep(setup, hier_load_factor=2.0).collective_bytes == \
        _jstep(setup, hier_load_factor=2.0).collective_bytes
    step = _tstep(setup)
    key = trandom.PRNGKey(0, device="cpu")
    with pytest.raises(ValueError, match=r"\[G, 4, 4\]"):
        step(_tstate(setup), np.zeros((2, S, BS + 1), np.int64), key)
    with pytest.raises(ValueError, match=r"\[G, 4, 4\]"):
        step(_tstate(setup), np.zeros((S, BS), np.int64), key)
