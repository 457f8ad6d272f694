"""glt_tpu_torch's heterogeneous graphs across shards against glt_tpu's,
on the CPU.

glt_tpu runs its shard bodies under ``shard_map`` on the suite's virtual
CPU devices; the port runs S shards in lockstep on S x ``"cpu"``.  Same
graphs, seeds and keys on both sides, compared with ``==``:
``shard_hetero_graph``, the sampler's static shapes, and
``DistHeteroNeighborSampler.sample_from_nodes`` over S in {2, 4, 8},
uncapped and capped (α = S and 2.0), both final-hop modes, two
consecutive calls, ``exchange_dropped`` included; then glt_tpu's two
bipartite checks (``tests/test_parallel.py`` ``TestDistHeteroSampler``).
``make_hetero_dist_train_step`` from the same parameters
(``params_from_flax``) takes three steps within 1e-5 of glt_tpu's
losses, accuracies and parameters (other summation orders; Adam's eps
at 1e-3, as ``tests/test_torch_hetero_models.py`` explains); a fully
padded batch leaves the port's state as it was; the loss falls below
0.6 of its first value over 30 steps (``tests/test_dist_train.py``).
The tiered step's loss on a staged batch ``==`` the full-HBM step's,
and three ``HeteroTieredTrainPipeline`` batches match glt_tpu's within
1e-5 with the same stage outputs and no drops.  The twin trains with
``--distributed 2``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from glt_tpu.data.topology import CSRTopo as JaxTopo
from glt_tpu.models.rgat import RGAT as JaxRGAT
from glt_tpu.parallel import dist_feature as jfeat
from glt_tpu.parallel import dist_hetero_sampler as jhet
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.parallel import sharding as jshard
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo
from glt_tpu_torch.examples import rgat_igbh
from glt_tpu_torch.models import RGAT, params_from_flax
from glt_tpu_torch.parallel import (
    DistHeteroNeighborSampler,
    HeteroTieredTrainPipeline,
    Mesh,
    init_hetero_dist_state,
    make_hetero_dist_train_step,
    make_hetero_tiered_train_step,
    shard_feature,
    shard_feature_tiered,
    shard_hetero_graph,
)
from glt_tpu_torch.sampler.hetero_neighbor_sampler import drive_steps

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

ET_UI = ("user", "clicks", "item")
ET_IU = ("item", "rev_clicks", "user")
U, I, CLASSES, BS = 64, 32, 4, 4
LR, ADAM_EPS, TOL = 1e-2, 1e-3, 1e-5
FIELDS = ("node", "row", "col", "edge", "batch", "node_mask", "edge_mask",
          "num_sampled_nodes")


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _jmesh(s):
    return JaxMesh(np.array(jax.devices()[:s]), ("shard",))


def _bipartite():
    """glt_tpu's bipartite user/item fixture (tests/test_dist_train.py):
    a user's items encode its class."""
    rng = np.random.default_rng(0)
    labels = (np.arange(U) % CLASSES).astype(np.int32)
    u_src = np.repeat(np.arange(U), 3)
    i_dst = np.concatenate([
        [(u % CLASSES) + CLASSES * ((u // CLASSES + k) % (I // CLASSES))
         for k in range(3)] for u in range(U)])
    eis = {ET_UI: (np.stack([u_src, i_dst]), U),
           ET_IU: (np.stack([i_dst, u_src]), I)}
    item = np.eye(CLASSES, dtype=np.float32)[np.arange(I) % CLASSES]
    item = np.concatenate([item, rng.normal(0, .1, (I, 12)).astype(
        np.float32)], 1)
    user = rng.normal(0, .1, (U, 16)).astype(np.float32)
    return eis, {"user": user, "item": item}, labels


def _sharded(eis, s):
    return (jhet.shard_hetero_graph(
        {et: JaxTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, s),
        shard_hetero_graph(
            {et: CSRTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, s,
            device="cpu"))


def _seeds(s, it=0, pad=True):
    c = U // s
    out = np.stack([np.random.default_rng(it * s + r).choice(
        np.arange(r * c, (r + 1) * c), BS, replace=False)
        for r in range(s)]).astype(np.int32)
    if pad:
        out[0, -1] = -1
    return out


def _same_out(jo, to, what=""):
    for f in FIELDS:
        jd, td = getattr(jo, f), getattr(to, f)
        assert set(jd) == set(td), (what, f)
        for k in jd:
            _eq(jd[k], td[k], f"{what} {f} {k}")
    if jo.metadata:
        _eq(jo.metadata["exchange_dropped"],
            to.metadata["exchange_dropped"], f"{what} dropped")
    else:
        assert not to.metadata


# -- sharding and sampling -------------------------------------------------------
@pytest.mark.parametrize("s", [2, 4, 8])
def test_shard_hetero_graph_equal(s):
    eis, _, _ = _bipartite()
    js, ts = _sharded(eis, s)
    assert set(js) == set(ts)
    for et in js:
        for f in ("indptr", "indices", "edge_ids"):
            _eq(getattr(js[et], f), getattr(ts[et], f), f"{et} {f}")
        assert (js[et].nodes_per_shard, js[et].num_nodes,
                js[et].num_shards) == (ts[et].nodes_per_shard,
                                       ts[et].num_nodes, ts[et].num_shards)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("alpha", [None, "S", 2.0])
def test_sample_from_nodes_equal(s, alpha):
    """Both final-hop modes, two consecutive calls each (the call
    counter's keys), a padded seed slot; the static shapes agree."""
    eis, _, _ = _bipartite()
    js, ts = _sharded(eis, s)
    elf = float(s) if alpha == "S" else alpha
    for lhd in (True, False):
        kw = dict(batch_size=BS, frontier_cap=16, seed=2,
                  last_hop_dedup=lhd, exchange_load_factor=elf)
        a = jhet.DistHeteroNeighborSampler(js, _jmesh(s), [3, 2], "user",
                                           **kw)
        b = DistHeteroNeighborSampler(ts, Mesh(["cpu"] * s), [3, 2], "user",
                                      **kw)
        assert b.route == a.route
        assert b.edge_types == a.edge_types
        assert b.num_neighbors == a.num_neighbors
        assert b.node_capacity == a.node_capacity
        assert b.hop_widths == a.hop_widths
        for it in range(2):
            seeds = _seeds(s, it)
            _same_out(a.sample_from_nodes(jnp.asarray(seeds)),
                      b.sample_from_nodes(seeds), f"lhd={lhd} call {it}")
        if alpha == "S":
            out = b.sample_from_nodes(_seeds(s))
            assert int(out.metadata["exchange_dropped"].sum()) == 0


def test_lockstep_seam_drives_the_single_device_body():
    """The single-device sampler's body through drive_steps, each
    request answered by the sampler's own one-hop sample, is its
    ``_sample_impl``; the requests come in (hop, sorted edge type)
    order with static widths."""
    from glt_tpu_torch.data import Graph
    from glt_tpu_torch.ops import sample_neighbors
    from glt_tpu_torch.sampler import HeteroNeighborSampler

    eis, _, _ = _bipartite()
    graphs = {et: Graph(CSRTopo(e, num_nodes=n), device="cpu")
              for et, (e, n) in eis.items()}
    samp = HeteroNeighborSampler(graphs, [3, 2], "user", batch_size=BS)
    seeds = {"user": torch.from_numpy(_seeds(2)[0])}
    key = trandom.PRNGKey(4, device="cpu")
    arrays = samp.graph_arrays()
    seen = []

    def one_hop(et, frontier, fanout, k):
        seen.append((et, int(frontier.shape[0]), fanout))
        ip, ix, ei = arrays[et]
        return sample_neighbors(ip, ix, frontier, fanout, k, edge_ids=ei)

    got = drive_steps(samp._sample_steps(samp._widths, samp._capacity,
                                         seeds, key), one_hop)
    want = samp._sample_impl(samp._widths, samp._capacity, arrays, seeds,
                             key)
    for f in ("node", "row", "col", "edge", "node_mask", "edge_mask"):
        for k in getattr(want, f):
            assert torch.equal(getattr(got, f)[k], getattr(want, f)[k])
    w = samp.hop_widths
    assert seen == [(ET_UI, w[0]["user"], 3), (ET_IU, w[1]["item"], 2)]


def _bipartite_small():
    """tests/test_parallel.py's fixture: user u -> items (u % I,
    (u + 1) % I)."""
    u_src = np.repeat(np.arange(32), 2)
    i_dst = np.concatenate([[u % 16, (u + 1) % 16] for u in range(32)])
    return {ET_UI: (np.stack([u_src, i_dst]), 32),
            ET_IU: (np.stack([i_dst, u_src]), 16)}


def _check_edges(out, seeds, s, strict=True):
    users, items = out.node["user"][s].numpy(), out.node["item"][s].numpy()
    m = out.edge_mask[ET_IU][s].numpy()
    row, col = out.row[ET_IU][s].numpy(), out.col[ET_IU][s].numpy()
    if strict:
        assert users[0] == seeds[s, 0] and users[1] == seeds[s, 1]
        assert m.sum() > 0
    for r, c in zip(row[m], col[m]):
        u, it = users[c], items[r]
        assert it in (u % 16, (u + 1) % 16)


def test_bipartite_two_hop():
    _, ts = _sharded(_bipartite_small(), 8)
    samp = DistHeteroNeighborSampler(ts, Mesh(["cpu"] * 8), [2, 2], "user",
                                     batch_size=2)
    seeds = np.stack([[s * 4, s * 4 + 3] for s in range(8)]).astype(np.int32)
    out = samp.sample_from_nodes(seeds)
    for s in range(8):
        _check_edges(out, seeds, s)


def test_bounded_exchange_parity():
    """α = S: nothing drops, structurally exact; α = 2: every emitted
    edge is still an edge, drops counted."""
    _, ts = _sharded(_bipartite_small(), 8)
    seeds = np.stack([[s * 4, s * 4 + 3] for s in range(8)]).astype(np.int32)
    for alpha in (8.0, 2.0):
        samp = DistHeteroNeighborSampler(ts, Mesh(["cpu"] * 8), [2, 2],
                                         "user", batch_size=2,
                                         exchange_load_factor=alpha)
        out = samp.sample_from_nodes(seeds)
        assert out.metadata is not None
        if alpha == 8.0:
            assert int(out.metadata["exchange_dropped"].sum()) == 0
        for s in range(8):
            assert out.node["user"][s][0] == seeds[s, 0]
            _check_edges(out, seeds, s, strict=False)


# -- the train steps -------------------------------------------------------------
def _setup(s=8, tiered=False):
    eis, feats, labels = _bipartite()
    js, ts = _sharded(eis, s)
    jm, tm = _jmesh(s), Mesh(["cpu"] * s)
    jf = {t: jshard.shard_feature(x, s) for t, x in feats.items()}
    tf = {t: shard_feature(x, s, device="cpu") for t, x in feats.items()}
    if tiered:
        jf["item"] = jfeat.shard_feature_tiered(feats["item"], s, 0.25)
        tf["item"] = shard_feature_tiered(feats["item"], s, 0.25,
                                          device="cpu")
    lab = labels.reshape(s, -1)
    kw = dict(batch_size=BS, frontier_cap=32, seed=0)
    jsam = jhet.DistHeteroNeighborSampler(js, jm, [3, 3], "user", **kw)
    tsam = DistHeteroNeighborSampler(ts, tm, [3, 3], "user", **kw)
    jmodel = JaxRGAT(edge_types=[ET_IU, ET_UI], hidden_features=16,
                     out_features=CLASSES, target_type="user", num_layers=2,
                     conv="gat", dropout_rate=0.0)
    tx = optax.adam(LR, eps=ADAM_EPS)
    jstate = jdt.init_hetero_dist_state(jmodel, tx, jsam, jf,
                                        jax.random.PRNGKey(0))
    return dict(s=s, jm=jm, tm=tm, jf=jf, tf=tf, lab=lab, jsam=jsam,
                tsam=tsam, jmodel=jmodel, tx=tx, jstate=jstate, feats=feats)


def _tstate(d, feats=None):
    model = RGAT([ET_IU, ET_UI], {"user": 16, "item": 16}, 16, CLASSES,
                 "user", num_layers=2, conv="gat", dropout_rate=0.0)
    model.load_state_dict(params_from_flax(d["jstate"].params))
    return init_hetero_dist_state(
        model, lambda ps: torch.optim.Adam(list(ps), lr=LR, eps=ADAM_EPS),
        d["tsam"], d["tf"] if feats is None else feats)


def _params_close(jparams, model):
    got = model.state_dict()
    want = params_from_flax(jparams)
    assert set(want) == set(got)
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), k)


def test_three_steps_match_jax():
    d = _setup()
    jstep = jdt.make_hetero_dist_train_step(
        d["jmodel"], d["tx"], d["jsam"], d["jf"], jnp.asarray(d["lab"]),
        d["jm"], batch_size=BS)
    tstep = make_hetero_dist_train_step(d["tsam"], d["tf"],
                                        torch.from_numpy(d["lab"]), d["tm"],
                                        BS)
    jst, tst = d["jstate"], _tstate(d)
    for it in range(3):
        seeds = _seeds(8, it, pad=it == 1)
        jst, jl, ja = jstep(jst, jnp.asarray(seeds),
                            jax.random.PRNGKey(100 + it))
        tst, tl, ta = tstep(tst, seeds, trandom.PRNGKey(100 + it,
                                                        device="cpu"))
        _close(float(tl), float(jl), f"loss {it}")
        _close(float(ta), float(ja), f"acc {it}")
    assert tst.step == int(jst.step) == 3
    _params_close(jst.params, tst.model)
    with pytest.raises(TypeError, match="host array"):
        tstep(tst, torch.from_numpy(seeds).to("meta"),
              trandom.PRNGKey(0, device="cpu"))


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def test_padded_batch_leaves_state_unchanged():
    """On a fresh state (the step creates Adam's state, which must be
    the fresh one it stands for) and after a real step."""
    d = _setup(4)
    step = make_hetero_dist_train_step(d["tsam"], d["tf"],
                                       torch.from_numpy(d["lab"]), d["tm"],
                                       BS)
    st = _tstate(d)
    pad = np.full((4, BS), -1, np.int64)
    key = trandom.PRNGKey(3, device="cpu")
    for before_real in (False, True):
        if before_real:
            st, _, _ = step(st, _seeds(4), key)
        (ma, oa, sa) = _snapshot(st)
        st, loss, acc = step(st, pad, key)
        mb, ob, sb = _snapshot(st)
        assert sa == sb and float(loss) == float(acc) == 0.0
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
        for i, state in ob["state"].items():
            for k, v in state.items():
                want = (oa["state"][i][k] if i in oa["state"]
                        else torch.zeros_like(v))
                assert torch.equal(v, want), (i, k)
    assert st.step == 1


def test_hetero_dist_train_loss_drops():
    """glt_tpu's test of the same name on the port: 30 steps of the
    bipartite R-GAT, the loss below 0.6 of its first value."""
    eis, _, labels = _bipartite()
    _, ts = _sharded(eis, 8)
    rng = np.random.default_rng(0)
    feats = {"user": shard_feature(rng.normal(0, .1, (U, CLASSES)).astype(
                 np.float32), 8, device="cpu"),
             "item": shard_feature(np.eye(CLASSES, dtype=np.float32)[
                 np.arange(I) % CLASSES], 8, device="cpu")}
    samp = DistHeteroNeighborSampler(ts, Mesh(["cpu"] * 8), [3, 3], "user",
                                     batch_size=BS, frontier_cap=32, seed=0)
    torch.manual_seed(0)
    model = RGAT([ET_IU, ET_UI], {"user": CLASSES, "item": CLASSES}, 16,
                 CLASSES, "user", num_layers=2, conv="gat", dropout_rate=0.0)
    state = init_hetero_dist_state(model, lambda ps: torch.optim.Adam(
        list(ps), lr=LR), samp, feats)
    step = make_hetero_dist_train_step(samp, feats, torch.from_numpy(
        labels.reshape(8, -1)), Mesh(["cpu"] * 8), BS)
    losses = []
    for it in range(30):
        state, loss, _ = step(state, _seeds(8, it, pad=False),
                              trandom.PRNGKey(100 + it, device="cpu"))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


def test_tiered_step_equals_full_and_pipeline_matches_jax():
    """A staged batch through the tiered step gives the full-HBM step's
    loss and accuracy; three pipeline batches (stage outputs, drops,
    cold-row peaks) match glt_tpu's, their losses, accuracies and the
    final parameters within 1e-5."""
    d = _setup(tiered=True)
    lab_t = torch.from_numpy(d["lab"])
    full_f = {t: shard_feature(x, 8, device="cpu")
              for t, x in d["feats"].items()}
    train_tier = make_hetero_tiered_train_step(d["tsam"], d["tf"], lab_t,
                                               d["tm"], BS)
    train_full = make_hetero_tiered_train_step(d["tsam"], full_f, lab_t,
                                               d["tm"], BS)
    pipe = HeteroTieredTrainPipeline(d["tsam"], train_tier, d["tf"], d["tm"])
    jtrain = jdt.make_hetero_tiered_train_step(
        d["jmodel"], d["tx"], d["jsam"], d["jf"], jnp.asarray(d["lab"]),
        d["jm"], batch_size=BS)
    jpipe = jdt.HeteroTieredTrainPipeline(d["jsam"], jtrain, d["jf"],
                                          d["jm"])
    try:
        seeds = _seeds(8, 0, pad=False)
        key = trandom.PRNGKey(3, device="cpu")
        out, fut = pipe._sample_and_stage(seeds, key)
        jout = d["jsam"].sample_from_nodes(jnp.asarray(seeds),
                                           key=jax.random.PRNGKey(3))
        _same_out(jout, out, "stage")
        staged, _, _ = fut.result()
        jstaged = jpipe._stage_cold_async(jout).result()
        _eq(jstaged["item"][1], staged["item"][1], "slots")
        live = np.asarray(jstaged["item"][1]) >= 0
        _eq(np.asarray(jstaged["item"][0])[live],
            staged["item"][0].numpy()[live], "staged rows")
        k = trandom.PRNGKey(4, device="cpu")
        _, lt, at = train_tier(_tstate(d), out, staged, k)
        _, lf, af = train_full(_tstate(d, full_f), out, {}, k)
        assert torch.equal(lt, lf) and torch.equal(at, af)

        batches = [_seeds(8, it, pad=False) for it in range(3)]
        jst, jl, ja = jpipe.run_epoch(d["jstate"], batches,
                                      jax.random.PRNGKey(5))
        tst, tl, ta = pipe.run_epoch(_tstate(d), batches,
                                     trandom.PRNGKey(5, device="cpu"))
        _close(torch.stack(tl).numpy(), np.asarray(jl), "losses")
        _close(torch.stack(ta).numpy(), np.asarray(ja), "accs")
        assert tst.step == int(jst.step) == 3
        _params_close(jst.params, tst.model)
        assert pipe.flush_dropped() == jpipe.flush_dropped() == 0
        assert pipe.max_cold_rows == jpipe.max_cold_rows
        assert set(pipe.last_dropped) == {"item"}
    finally:
        pipe.close()
        jpipe.close()


def test_twin_trains_distributed_on_cpu():
    _, epochs = rgat_igbh.main(["--device", "cpu", "--distributed", "2",
                                "--epochs", "2"])
    (l0, a0), (l1, a1) = epochs
    assert l0.shape == (7,) and np.isfinite(l0).all() and np.isfinite(
        l1).all()
    assert l1.mean() < l0.mean()
    assert 0.0 <= a1.mean() <= 1.0
