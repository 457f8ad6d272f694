"""glt_tpu_torch.models.train against glt_tpu.models.train on the CPU.

Same graph, features, labels, seeds and keys on both sides; the sampled
subgraphs and gathered features are bit-identical, so only float
arithmetic differs: losses, grads and Adam updates compare to 1e-5
(``segment_sum`` and ``index_add_`` add in different orders; optax and
torch place Adam's bias correction differently).  The port against
itself (scanned vs serial) compares to rel 1e-6, as ``glt_tpu``'s own
test does.  Dropout is off in every cross-package case: flax's dropout
bits are not reproduced.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import feature_cache as jcache
from glt_tpu.data import Graph as JaxGraph
from glt_tpu.loader.transform import to_batch as jax_to_batch
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models import train as jtrain
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler import NodeSamplerInput as JaxInput
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Feature, Graph
from glt_tpu_torch.data.feature_cache import cache_init, cache_stats
from glt_tpu_torch.loader.transform import Batch, to_batch
from glt_tpu_torch.models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_eval_step,
    make_cached_gather_xy,
    make_gather_xy,
    make_scanned_node_train_step,
    make_train_step,
    node_seed_blocks,
    params_from_flax,
    run_scanned_epoch,
    seed_cross_entropy,
)
from glt_tpu_torch.sampler import NeighborSampler, NodeSamplerInput

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, DIM, CLASSES, BS, FANOUT, HIDDEN, LR = 60, 8, 3, 16, [4, 4], 16, 1e-2


def _data(seed=0):
    """Clustered graph: edges mostly within a class, noisy one-hot
    features."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(N) % CLASSES).astype(np.int32)
    src = np.repeat(np.arange(N), 4)
    same = rng.random(src.size) < 0.8
    dst = np.where(same, (src + CLASSES * rng.integers(1, 5, src.size)) % N,
                   rng.integers(0, N, src.size))
    feat = np.concatenate(
        [np.eye(CLASSES, dtype=np.float32)[labels],
         rng.normal(0, 0.3, (N, DIM - CLASSES)).astype(np.float32)], 1)
    return np.stack([src, dst]), feat, labels


def _models(sampler_cap, dropout=0.0):
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=len(FANOUT), dropout_rate=dropout)
    x0 = jnp.zeros((sampler_cap, DIM), jnp.float32)
    ei0 = jnp.full((2, 8), -1, jnp.int32)
    params = jm.init({"params": jax.random.PRNGKey(0)}, x0, ei0,
                     jnp.zeros((8,), bool))
    tm = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=len(FANOUT),
                   dropout_rate=dropout)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _pair(node_capacity=None, frontier_cap=None):
    ei, feat, labels = _data()
    kw = dict(batch_size=BS, with_edge=False, node_capacity=node_capacity,
              frontier_cap=frontier_cap)
    js = JaxSampler(JaxGraph(JaxTopo(ei, num_nodes=N)), FANOUT,
                    sample_force="xla", **kw)
    ts = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                         FANOUT, **kw)
    return js, ts, feat, labels


def _assert_params(jparams, model, tol=1e-5):
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(),
                                   atol=tol, rtol=tol, err_msg=k)


def _state_copy(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def _assert_same_state(a, b):
    (ma, oa, sa), (mb, ob, sb) = a, b
    assert sa == sb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_seed_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20, 5)).astype(np.float32)
    y = rng.integers(-1, 5, 20).astype(np.int32)
    mask = rng.random(20) < 0.8
    jl, ja = jtrain.seed_cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                       12, jnp.asarray(mask))
    tl, ta = seed_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(y), 12,
                                torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    none = seed_cross_entropy(torch.from_numpy(logits),
                              torch.full((20,), -1, dtype=torch.int32), 12,
                              torch.from_numpy(mask))
    assert float(none[0]) == 0.0 and float(none[1]) == 0.0


def test_train_step_matches_jax():
    """One step from the same params: loss, grads and post-Adam params
    within 1e-5."""
    js, ts, feat, labels = _pair()
    jm, params, tm = _models(js.node_capacity)
    seeds = np.arange(3, 3 + BS)
    key = jax.random.PRNGKey(4)
    jout = js.sample_from_nodes(JaxInput(seeds), key=key)
    tout = ts.sample_from_nodes(NodeSamplerInput(seeds),
                                key=trandom.PRNGKey(4, device="cpu"))
    gid = np.clip(np.asarray(jout.node), 0, N - 1)
    x = np.where(np.asarray(jout.node)[:, None] >= 0, feat[gid], 0)
    y = np.where(np.asarray(jout.node) >= 0, labels[gid], -1)
    jb = jax_to_batch(jout, x=jnp.asarray(x), y=jnp.asarray(y),
                      batch_size=BS)
    tb = to_batch(tout, x=torch.from_numpy(x.astype(np.float32)),
                  y=torch.from_numpy(y.astype(np.int32)), batch_size=BS)
    np.testing.assert_array_equal(tb.edge_index.numpy(),
                                  np.asarray(jb.edge_index))

    tx = optax.adam(LR)
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))

    def loss_fn(p):
        logits = jm.apply(p, jb.x, jb.edge_index, jb.edge_mask, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jtrain.seed_cross_entropy(logits, jb.y, BS, jb.node_mask)[0]

    jgrads = jax.grad(loss_fn)(params)
    jstate, jloss, jacc = jtrain.make_train_step(jm, tx, BS)(jstate, jb)

    state = create_train_state(tm, adam(LR))
    state, loss, acc = make_train_step(BS)(state, tb)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    assert float(acc) == pytest.approx(float(jacc), rel=1e-6)
    want_g = params_from_flax(jgrads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    _assert_params(jstate.params, tm)
    ev_loss, ev_acc = make_eval_step(BS)(tm, tb)
    assert np.isfinite(float(ev_loss)) and 0.0 <= float(ev_acc) <= 1.0


# (frontier_cap, node_capacity): uncapped; capped with room (the
# 60-node graph never fills 96 slots); capped at 32 of 112, which
# overflows.
_CAPS = {"uncapped": (None, None), "fits": (None, 96), "overflows": (8, 32)}


@pytest.mark.parametrize("route", ["plain", "dedup", "fused"])
@pytest.mark.parametrize("cap", sorted(_CAPS))
def test_scanned_block_matches_jax(route, cap):
    """One [G, B] block through both scanned steps: per-batch losses,
    accuracies and overflow flags, and the params after the block within
    1e-5 (JAX gathers plainly: every port route gives the same x
    bits)."""
    frontier_cap, node_capacity = _CAPS[cap]
    js, ts, feat, labels = _pair(node_capacity, frontier_cap)
    assert ts.capped == (node_capacity is not None)
    jm, params, tm = _models(js.node_capacity)
    tx = optax.adam(LR)
    G = 3
    blk = next(node_seed_blocks(np.arange(N), BS, G,
                                np.random.default_rng(3)))
    jstep = jtrain.make_scanned_node_train_step(jm, tx, js, feat, labels, BS)
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstate, jl, ja, jo = jstep(jstate, blk, jax.random.PRNGKey(9))

    tstep = make_scanned_node_train_step(
        ts, Feature(feat, device="cpu"), labels, BS,
        dedup=route == "dedup", fused_frontier=route == "fused")
    state = create_train_state(tm, adam(LR))
    state, tl, ta, to = tstep(state, blk, trandom.PRNGKey(9, device="cpu"))
    assert state.step == int(jstate.step) == G
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert bool(to.any()) == (cap == "overflows")
    _assert_params(jstate.params, tm)


def test_scanned_step_matches_serial():
    """The port's scanned block == its serial loop with the scan's key
    schedule (sampling, gather, loss, update), rel 1e-6."""
    _, ts, feat, labels = _pair()
    _, _, tm = _models(ts.node_capacity)
    tm2 = copy.deepcopy(tm)
    G = 3
    blk = next(node_seed_blocks(np.arange(48), BS, G,
                                np.random.default_rng(3)))
    base = trandom.PRNGKey(9, device="cpu")
    state, losses, _, ovfs = make_scanned_node_train_step(
        ts, feat, labels, BS)(create_train_state(tm, adam(LR)), blk, base)
    assert int(ovfs.sum()) == 0             # uncapped: never flags

    fe = Feature(feat, device="cpu")
    lab = torch.from_numpy(labels)
    tstep = make_train_step(BS)
    sstate = create_train_state(tm2, adam(LR))
    keys = trandom.split(base, G)
    serial = []
    for i in range(G):
        out = ts.sample_from_nodes(NodeSamplerInput(blk[i]), key=keys[i])
        x = fe.gather(out.node)
        y = torch.where(out.node >= 0, lab[out.node.clamp(0, N - 1).long()],
                        -1)
        sstate, loss, _ = tstep(sstate, to_batch(out, x=x, y=y,
                                                 batch_size=BS))
        serial.append(float(loss))
    assert losses.tolist() == pytest.approx(serial, rel=1e-6)
    for (k, a), b in zip(tm.state_dict().items(), tm2.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, err_msg=k)


def test_padded_batch_is_noop():
    """Fully padded batches move neither params, nor Adam state, nor the
    step counter."""
    _, ts, feat, labels = _pair()
    _, _, tm = _models(ts.node_capacity)
    step = make_scanned_node_train_step(ts, feat, labels, BS)
    state = create_train_state(tm, adam(LR))
    blk = next(node_seed_blocks(np.arange(BS), BS, 2,
                                np.random.default_rng(0)))
    assert (blk[1] == -1).all()
    state, losses, accs, ovfs = step(state, blk,
                                     trandom.PRNGKey(5, device="cpu"))
    assert state.step == 1                  # only the real batch stepped
    assert float(losses[1]) == float(accs[1]) == int(ovfs[1]) == 0
    before = _state_copy(state)
    pad = np.full((3, BS), -1, np.int64)
    state, losses, _, _ = step(state, pad, trandom.PRNGKey(6, device="cpu"))
    _assert_same_state(before, _state_copy(state))
    assert losses.tolist() == [0.0, 0.0, 0.0]
    with pytest.raises(TypeError, match="host"):
        step(state, torch.from_numpy(pad), trandom.PRNGKey(6, device="cpu"))


def test_gather_xy_routes_equal():
    _, ts, feat, labels = _pair()
    perm = np.random.default_rng(1).permutation(N).astype(np.int32)
    rows = torch.from_numpy(feat[np.argsort(perm)])  # rows[perm[i]] = feat[i]
    id2index = torch.from_numpy(perm)
    lab = torch.from_numpy(labels)
    out = ts.sample_from_nodes(NodeSamplerInput(np.arange(5, 5 + BS)))
    got = [make_gather_xy(id2index, dedup=d, fused=f)(rows, lab, out)
           for d, f in ((False, False), (True, False), (False, True))]
    for x, y in got[1:]:
        assert torch.equal(x, got[0][0]) and torch.equal(y, got[0][1])
    node = out.node.numpy()
    want = np.where(node[:, None] >= 0, feat[np.clip(node, 0, N - 1)], 0)
    np.testing.assert_array_equal(got[0][0].numpy(), want)
    np.testing.assert_array_equal(
        got[0][1].numpy(), np.where(node >= 0, labels[np.clip(node, 0, None)],
                                    -1))


def _assert_cache(jc, tc):
    for name in jc._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(jc, name)), getattr(tc, name).numpy(),
            err_msg=name)


@pytest.mark.parametrize("capacity", [8, 64])
def test_cached_gather_xy_matches_jax(capacity):
    """The cached gather over five batches (capacity 8 evicts on every
    batch, 64 holds the graph): ``x``, ``y`` and the whole cache state
    == ``glt_tpu``'s, and ``x`` == the uncached gather's."""
    js, ts, feat, labels = _pair()
    perm = np.random.default_rng(1).permutation(N).astype(np.int32)
    rows = feat[np.argsort(perm)]
    jxy = jtrain.make_cached_gather_xy(jnp.asarray(perm), force="xla")
    txy = make_cached_gather_xy(torch.from_numpy(perm))
    plain = make_gather_xy(torch.from_numpy(perm))
    jc = jcache.cache_init(N, capacity, DIM)
    tc = cache_init(N, capacity, DIM, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(5):
        seeds = rng.integers(-1, N, BS)
        jout = js.sample_from_nodes(JaxInput(seeds))
        tout = ts.sample_from_nodes(NodeSamplerInput(seeds))
        jc, jx, jy = jxy(jc, jnp.asarray(rows), jnp.asarray(labels), jout)
        tc, tx, ty = txy(tc, torch.from_numpy(rows),
                         torch.from_numpy(labels), tout)
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        px, py = plain(torch.from_numpy(rows), torch.from_numpy(labels),
                       tout)
        assert torch.equal(tx, px) and torch.equal(ty, py)
        _assert_cache(jc, tc)
    assert cache_stats(tc)["misses"] > 0 and cache_stats(tc)["hits"] > 0


def test_scanned_block_with_cache_matches_jax():
    """Two blocks through both scanned steps with ``feature_cache=``:
    losses and params within 1e-5, the live cache state ==; the seam
    swaps the cache in, and the cache wins over ``fused_frontier``."""
    js, ts, feat, labels = _pair()
    jm, params, tm = _models(js.node_capacity)
    tx = optax.adam(LR)
    blocks = list(node_seed_blocks(np.arange(N), BS, 2,
                                   np.random.default_rng(3)))
    jstep = jtrain.make_scanned_node_train_step(
        jm, tx, js, feat, labels, BS, feature_cache=jcache.cache_init(
            N, 24, DIM))
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    tstep = make_scanned_node_train_step(
        ts, Feature(feat, device="cpu"), labels, BS, fused_frontier=True,
        feature_cache=cache_init(N, 24, DIM, device="cpu"))
    state = create_train_state(tm, adam(LR))
    for i, blk in enumerate(blocks):
        jstate, jl, ja, _ = jstep(jstate, blk, jax.random.PRNGKey(i))
        state, tl, ta, _ = tstep(state, blk,
                                 trandom.PRNGKey(i, device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
        _assert_cache(jstep.feature_cache(), tstep.feature_cache())
    _assert_params(jstate.params, tm)
    assert state.step == int(jstate.step)
    fresh = cache_init(N, 24, DIM, device="cpu")
    tstep.set_feature_cache(fresh)
    assert tstep.feature_cache() is fresh
    with pytest.raises(ValueError, match="feature_cache"):
        tstep.set_feature_cache(cache_init(N, 24, DIM + 1, device="cpu"))


def test_node_seed_blocks_match_jax():
    idx = np.arange(100, 171)
    for bs, g in ((16, 2), (8, 3), (71, 1)):
        a = list(node_seed_blocks(idx, bs, g, np.random.default_rng(4)))
        b = list(jtrain.node_seed_blocks(idx, bs, g,
                                         np.random.default_rng(4)))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_run_scanned_epoch_trims_and_resumes():
    """Losses trim to the real batches; start_block skips blocks without
    moving the key schedule, so a resumed epoch replays the rest; the
    full epoch agrees with glt_tpu's within 1e-5."""
    js, ts, feat, labels = _pair()
    jm, params, tm = _models(ts.node_capacity)
    tm_resume = copy.deepcopy(tm)
    train_idx = np.arange(40)               # 3 real batches in 2 blocks
    base = trandom.PRNGKey(11, device="cpu")
    step = make_scanned_node_train_step(ts, feat, labels, BS)
    seen = {}

    def hook(state, i):
        seen[i] = _state_copy(state)

    state, losses, accs, ovf = run_scanned_epoch(
        step, create_train_state(tm, adam(LR)), train_idx, BS, 2,
        np.random.default_rng(0), base, on_block=hook)
    assert losses.shape == accs.shape == (3,) and ovf == 0
    assert sorted(seen) == [0, 1] and state.step == 3

    tx = optax.adam(LR)
    jstep = jtrain.make_scanned_node_train_step(jm, tx, js, feat, labels, BS)
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstate, jl, _, jovf = jtrain.run_scanned_epoch(
        jstep, jstate, train_idx, BS, 2, np.random.default_rng(0),
        jax.random.PRNGKey(11))
    np.testing.assert_allclose(losses, jl, atol=1e-5, rtol=1e-5)
    assert jovf == 0
    _assert_params(jstate.params, tm)

    msd, osd, st = seen[0]
    tm_resume.load_state_dict(msd)
    rstate = create_train_state(tm_resume, adam(LR))
    rstate.optimizer.load_state_dict(osd)
    rstate = rstate._replace(step=st)
    rstate, rl, _, _ = run_scanned_epoch(
        step, rstate, train_idx, BS, 2, np.random.default_rng(0), base,
        start_block=1)
    assert rl.shape == (1,) and rstate.step == 3
    assert rl.tolist() == pytest.approx(losses[2:].tolist(), rel=1e-6)


def test_dropout_draws_from_its_own_generator():
    """Dropout draws from its own threefry key, never from torch's
    global generator; the same (dropout_seed, step) gives the same
    update, another seed another.  The scanned block, whose step counter
    lives on the device, draws the masks of the one-batch train step at
    each step."""
    _, ts, feat, labels = _pair()
    _, _, tm = _models(ts.node_capacity, dropout=0.5)
    blk = next(node_seed_blocks(np.arange(48), BS, 2,
                                np.random.default_rng(1)))
    key = trandom.PRNGKey(2, device="cpu")
    runs = []
    for seed in (0, 0, 1):
        m = copy.deepcopy(tm)
        step = make_scanned_node_train_step(ts, feat, labels, BS,
                                            dropout_seed=seed)
        rng_before = torch.get_rng_state()
        _, losses, _, _ = step(create_train_state(m, adam(LR)), blk, key)
        assert torch.equal(torch.get_rng_state(), rng_before)
        runs.append(losses)
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])

    m = copy.deepcopy(tm)
    state = create_train_state(m, adam(LR))
    tstep = make_train_step(BS, dropout_seed=0)
    fe = Feature(feat, device="cpu")
    lab = torch.from_numpy(labels)
    keys = trandom.split(key, 2)
    for i in range(2):
        out = ts.sample_from_nodes(NodeSamplerInput(blk[i]), key=keys[i])
        y = torch.where(out.node >= 0, lab[out.node.clamp(0, N - 1).long()],
                        -1)
        state, loss, _ = tstep(state, to_batch(
            out, x=fe.gather(out.node), y=y, batch_size=BS))
        assert float(loss) == pytest.approx(float(runs[0][i]), rel=1e-6)


def test_step_refuses_mismatched_devices():
    _, ts, feat, labels = _pair()
    for dtype, dim in ((torch.float64, DIM), (torch.float32, DIM + 1)):
        with pytest.raises(ValueError, match="feature_cache"):
            make_scanned_node_train_step(
                ts, feat, labels, BS, feature_cache=cache_init(
                    N, 8, dim, dtype=dtype, device="cpu"))
    meta = torch.nn.Linear(2, 2, device="meta")
    step = make_scanned_node_train_step(ts, feat, labels, BS)
    bad = create_train_state(meta, adam(LR))
    with pytest.raises(ValueError, match="model lives on"):
        step(bad, np.zeros((1, BS), np.int64),
             trandom.PRNGKey(0, device="cpu"))
    assert isinstance(to_batch(ts.sample_from_nodes(
        NodeSamplerInput(np.arange(3)))), Batch)
