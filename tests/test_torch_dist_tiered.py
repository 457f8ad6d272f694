"""glt_tpu_torch's host-tiered distributed path against glt_tpu's, on
the CPU.

The JAX side runs its shard bodies under ``shard_map`` on four of the
suite's virtual CPU devices; the port runs the same four shards in turn
on 4 x ``"cpu"``.  Same features, ids, partitions and keys on both
sides, compared with ``==``: ``shard_feature_tiered`` and its store
constructor, the tiered ``DistDataset`` load, ``exchange_gather_hot``
(no staging, dense and compact staging, dedup on and off, the port's B3
serve on and off), the tiered ``exchange_gather_xy``, the cold routing
and its compaction (past the cap included), and the serves of
``HostColdStore`` and ``DiskColdStore`` (raw, int8 and bf16 stores).
Then ``TieredTrainPipeline`` from the same parameters
(``params_from_flax``): each batch's sample, slots, ids and drops ``==``,
three batches' losses, accuracies and parameters within 1e-5 for each
branch of the gather, and a resume from ``start_batch`` ``==`` to the
run it resumes.  Port-only checks: the tiered gather equals the gather
of the whole table, a ``DiskColdStore`` epoch equals a ``HostColdStore``
one, a zero-row cold placeholder is refused without a store, and the
staging thread overlaps the host gather with the training step.
"""
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from glt_tpu.distributed import DistDataset as JaxDataset
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.parallel import dist_feature as jfeat
from glt_tpu.parallel import dist_sampler as jsamp
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.partition import FrequencyPartitioner
from glt_tpu.store import DiskColdStore as JaxDiskColdStore
from glt_tpu.store import DiskFeatureStore as JaxStore
from glt_tpu.store import write_feature_store as jax_write
from glt_tpu_torch import random as trandom
from glt_tpu_torch.distributed import DistDataset
from glt_tpu_torch.models import GraphSAGE, adam, params_from_flax
from glt_tpu_torch.obs import metrics
from glt_tpu_torch.parallel import (
    DistNeighborSampler,
    HostColdStore,
    Mesh,
    TieredShardedFeature,
    TieredTrainPipeline,
    cold_gather_host,
    compact_cold_requests,
    exchange_gather,
    exchange_gather_hot,
    exchange_gather_xy,
    init_dist_state,
    make_tiered_train_step,
    merge_cold,
    route_cold_requests,
    shard_feature,
    shard_feature_tiered,
    shard_feature_tiered_from_store,
)
from glt_tpu_torch.store import DiskColdStore, DiskFeatureStore

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

S = 4
N, CLASSES, HIDDEN, LR = 96, 4, 16, 1e-2
BS, FANOUTS = 4, [3, 3]
DIM = 6


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _jmesh(s=S):
    return JaxMesh(np.array(jax.devices()[:s]), ("shard",))


def _shard_map(fn, n_in, n_out):
    spec = P("shard")
    return jax.jit(jax.shard_map(
        fn, mesh=_jmesh(), in_specs=(spec,) * n_in,
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False))


def _feat(n=N, d=DIM, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _ids(c, b=20, seed=9):
    """Per-shard global ids: own and remote, hot and cold, duplicates
    and padding."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, S * c, (S, b)).astype(np.int32)
    ids[:, 5] = ids[:, 4]
    ids[:, -3:] = -1
    return ids


# -- the tiered feature ------------------------------------------------------
@pytest.mark.parametrize("n,ratio,dtype", [
    (96, 0.25, None), (90, 0.25, None), (96, 0.0, None), (96, 1.0, None),
    (97, 0.6, np.float16)])
def test_shard_feature_tiered_equal(n, ratio, dtype):
    x = _feat(n)
    jf = jfeat.shard_feature_tiered(x, S, ratio, dtype=dtype)
    tf = shard_feature_tiered(x, S, ratio, dtype=dtype, device="cpu")
    assert isinstance(tf, TieredShardedFeature)
    assert (jf.nodes_per_shard, jf.hot_per_shard, jf.num_shards) == (
        tf.nodes_per_shard, tf.hot_per_shard, tf.num_shards)
    assert tf.dim == jf.dim == DIM
    _eq(jf.hot, tf.hot, "hot")
    _eq(jf.cold, tf.cold, "cold")


def test_from_store_equal(tmp_path):
    x = _feat()
    root = jax_write(str(tmp_path / "st"), x)
    jf = jfeat.shard_feature_tiered_from_store(JaxStore(root), S, 0.25)
    tf = shard_feature_tiered_from_store(DiskFeatureStore(root), S, 0.25,
                                         device="cpu")
    _eq(jf.hot, tf.hot, "hot")
    assert tf.cold.shape == jf.cold.shape == (S, 0, DIM)
    assert (tf.nodes_per_shard, tf.hot_per_shard) == (
        jf.nodes_per_shard, jf.hot_per_shard)
    odd = jax_write(str(tmp_path / "odd"), _feat(90))
    with pytest.raises(ValueError, match="not divisible"):
        shard_feature_tiered_from_store(DiskFeatureStore(odd), S, 0.25,
                                        device="cpu")


# -- the tiered exchanges ----------------------------------------------------
def _staging(jf, ids, dedup, cold_cap):
    """glt_tpu's cold routing of ``ids`` and both staged forms served
    from its HostColdStore: ``(req, dense [S, S*b, d], rows, slots,
    cids, dropped)`` as numpy."""
    c, h = jf.nodes_per_shard, jf.hot_per_shard

    def body(i):
        req = jfeat.route_cold_requests(i[0], c, h, S, "shard", dedup=dedup)
        slots, cids, dropped = jfeat.compact_cold_requests(req, cold_cap)
        return req[None], slots[None], cids[None], dropped[None]

    req, slots, cids, dropped = (np.asarray(a) for a in _shard_map(
        body, 1, 4)(jnp.asarray(ids)))
    store = jfeat.HostColdStore(jf)
    dense = np.stack([store.serve(s, req[s]) for s in range(S)])
    rows = np.stack([store.serve(s, cids[s]) for s in range(S)])
    return req, dense, rows, slots, cids, dropped


@pytest.mark.parametrize("form", ["none", "dense", "compact"])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("fused_frontier", [False, True])
def test_exchange_gather_hot_equal(form, dedup, fused_frontier):
    x = _feat()
    jf = jfeat.shard_feature_tiered(x, S, 0.25)
    tf = shard_feature_tiered(x, S, 0.25, device="cpu")
    c, h = jf.nodes_per_shard, jf.hot_per_shard
    ids = _ids(c)
    _, dense, rows, slots, _, _ = _staging(jf, ids, dedup, 24)
    assert (dense != 0).any() and (rows != 0).any()

    def body(hot, i, dn, rw, sl):
        kw = {"dense": dict(staged_resp=dn[0]),
              "compact": dict(staged_rows=rw[0], staged_slots=sl[0]),
              "none": {}}[form]
        return jfeat.exchange_gather_hot(i[0], hot[0], c, h, S, "shard",
                                         dedup=dedup, **kw)[None]

    want = np.asarray(_shard_map(body, 5, 1)(
        jf.hot, jnp.asarray(ids), jnp.asarray(dense), jnp.asarray(rows),
        jnp.asarray(slots)))

    def t(a):
        return torch.from_numpy(np.array(a))

    kw = {"dense": dict(staged_resp=t(dense)),
          "compact": dict(staged_rows=t(rows), staged_slots=t(slots)),
          "none": {}}[form]
    got = exchange_gather_hot(t(ids), tf.hot, c, h, S, dedup=dedup,
                              fused_frontier=fused_frontier, **kw)
    for s in range(S):
        _eq(want[s], got[s], f"shard {s}")


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_exchange_gather_xy_tiered_equal(dedup, fused):
    x = _feat(seed=2)
    jf = jfeat.shard_feature_tiered(x, S, 0.25)
    tf = shard_feature_tiered(x, S, 0.25, device="cpu")
    c, h = jf.nodes_per_shard, jf.hot_per_shard
    labels = np.random.default_rng(3).integers(0, 50, (S, c)).astype(
        np.int32)
    labels[0, :2] = [-2**31, 2**31 - 1]
    ids = _ids(c, seed=4)
    ids[0, :2] = [0, 1]
    _, _, rows, slots, _, _ = _staging(jf, ids, dedup, 24)

    def body(hot, lb, i, rw, sl):
        xx, yy = jfeat.exchange_gather_xy(
            i[0], hot[0], lb[0], c, S, "shard", hot_per_shard=h,
            staged_rows=rw[0], staged_slots=sl[0], dedup=dedup, fused=fused)
        return xx[None], yy[None]

    jx, jy = (np.asarray(a) for a in _shard_map(body, 5, 2)(
        jf.hot, jnp.asarray(labels), jnp.asarray(ids), jnp.asarray(rows),
        jnp.asarray(slots)))

    def t(a):
        return torch.from_numpy(np.array(a))

    for ff in (False, True):
        got = exchange_gather_xy(t(ids), tf.hot, t(labels), c, S,
                                 hot_per_shard=h, staged_rows=t(rows),
                                 staged_slots=t(slots), dedup=dedup,
                                 fused=fused, fused_frontier=ff)
        for s in range(S):
            _eq(jx[s], got[s][0], f"shard {s} x")
            _eq(jy[s], got[s][1], f"shard {s} y")
    assert got[0][1][:2].tolist() == [-2**31, 2**31 - 1]


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("cold_cap", [3, 24, 200])
def test_route_and_compact_equal(dedup, cold_cap):
    x = _feat()
    jf = jfeat.shard_feature_tiered(x, S, 0.25)
    c, h = jf.nodes_per_shard, jf.hot_per_shard
    ids = _ids(c, b=30, seed=6)
    # Shard 1 asks for many of shard 2's cold rows: drops at a small cap.
    ids[1, :18] = 2 * c + h + np.arange(18) % (c - h)
    req, _, _, slots, cids, dropped = _staging(jf, ids, dedup, cold_cap)
    t_req = route_cold_requests(torch.from_numpy(ids), c, h, S, dedup=dedup)
    for s in range(S):
        _eq(req[s], t_req[s], f"req {s}")
        ts, ti, td = compact_cold_requests(t_req[s], cold_cap)
        _eq(slots[s], ts, f"slots {s}")
        _eq(cids[s], ti, f"ids {s}")
        _eq(dropped[s], td, f"dropped {s}")
    if cold_cap == 3:
        assert (dropped > 0).any()
    if cold_cap == 200:
        assert (dropped == 0).all()


def test_host_cold_store_serves_equal():
    x = _feat()
    jf = jfeat.shard_feature_tiered(x, S, 0.25)
    tf = shard_feature_tiered(x, S, 0.25, device="cpu")
    jst, tst = jfeat.HostColdStore(jf), HostColdStore(tf)
    assert (tst.dim, tst.dtype) == (jst.dim, jst.dtype)
    rng = np.random.default_rng(7)
    c, h = tf.nodes_per_shard, tf.hot_per_shard
    with ThreadPoolExecutor(2) as pool:
        for s in range(S):
            req = rng.integers(-1, c - h, 40)
            _eq(jst.serve(s, req), tst.serve(s, req), f"serve {s}")
            out = np.zeros((req.size, DIM), np.float32)
            for fu in tst.serve_into(out, s, req, pool=pool, row_chunk=7):
                fu.result()
            _eq(jst.serve(s, req), out, f"serve_into {s}")
    half = HostColdStore(tf, shard_ids=(0, 1))
    _eq(half.serve(1, req), tst.serve(1, req))
    with pytest.raises(KeyError, match="not local"):
        half.serve(3, req)


@pytest.mark.parametrize("codec", ["raw", "int8", "bf16"])
@pytest.mark.parametrize("budget_rows", [None, 5])
def test_disk_cold_store_serves_equal(tmp_path, codec, budget_rows):
    x = _feat(seed=8)
    root = jax_write(str(tmp_path / codec), x, codec=codec)
    jstore, tstore = JaxStore(root), DiskFeatureStore(root)
    c, h = N // S, N // S // 4
    budget = None if budget_rows is None else budget_rows * tstore.row_nbytes
    jd = JaxDiskColdStore(jstore, c, h, dram_budget_bytes=budget)
    td = DiskColdStore(tstore, c, h, dram_budget_bytes=budget)
    def jserve(s, req):
        # glt_tpu keeps bf16 codes as ml_dtypes.bfloat16, the port as
        # their uint16 bits: compare the bits.
        return jd.serve(s, req).view(td.dtype)

    try:
        assert td.dim == jd.dim
        assert td.dtype.itemsize == jd.dtype.itemsize
        assert td.dtype == (np.uint16 if codec == "bf16" else jd.dtype)
        rng = np.random.default_rng(9)
        for _ in range(2):
            for s in range(S):
                req = rng.integers(-1, c - h, 12)
                _eq(jserve(s, req), td.serve(s, req), f"{codec} {s}")
        req = np.array([0, -1, 5, 3, -1, 0, c - h - 1])
        out = np.zeros((req.size, DIM), td.dtype)
        with ThreadPoolExecutor(2) as pool:
            for fu in td.serve_into(out, 2, req, pool=pool, row_chunk=2):
                fu.result()
        _eq(jserve(2, req), out, "serve_into")
        if codec == "raw":
            host = HostColdStore(shard_feature_tiered(x, S, h / c,
                                                      device="cpu"))
            _eq(host.serve(2, req), out, "vs HostColdStore")
        with pytest.raises(KeyError, match="not local"):
            DiskColdStore(tstore, c, h, shard_ids=(0,)).serve(1, req)
        if budget is not None:
            assert td.stager.stats()["resident_bytes"] <= budget
    finally:
        jd.close()
        td.close()


def test_tiered_gather_matches_full():
    """Hot exchange + staged cold rows == the exchange over the whole
    table, row for row (the port's run of glt_tpu's test of the name),
    by the merge overlay and by the compact scatter."""
    x = _feat(seed=11)
    full = shard_feature(x, S, device="cpu")
    tf = shard_feature_tiered(x, S, 0.25, device="cpu")
    c, h = tf.nodes_per_shard, tf.hot_per_shard
    ids = torch.from_numpy(_ids(c, seed=12))
    want = exchange_gather(ids, full.rows, c, S)
    got = exchange_gather_hot(ids, tf.hot, c, h, S)
    cold = torch.from_numpy(cold_gather_host(tf, ids.numpy()))
    store = HostColdStore(tf)
    comp = [compact_cold_requests(r, 40)
            for r in route_cold_requests(ids, c, h, S)]
    rows = torch.stack([torch.from_numpy(store.serve(s, comp[s][1].numpy()))
                        for s in range(S)])
    compact = exchange_gather_hot(ids, tf.hot, c, h, S, staged_rows=rows,
                                  staged_slots=[p[0] for p in comp])
    assert (cold != 0).any()
    for s in range(S):
        assert torch.equal(merge_cold(got[s], cold[s], ids[s], c, h),
                           want[s])
        assert torch.equal(compact[s], want[s])


# -- the dataset and the pipeline --------------------------------------------
def _clustered_graph(seed=0):
    """Edges within a class; feature row i encodes label(i)."""
    rng = np.random.default_rng(seed)
    labels = (np.arange(N) % CLASSES).astype(np.int32)
    src, dst = [], []
    for c in range(CLASSES):
        members = np.where(labels == c)[0]
        for i in members:
            for j in rng.choice(members, 3, replace=False):
                src.append(i)
                dst.append(j)
    feat = np.concatenate([np.eye(CLASSES, dtype=np.float32)[labels],
                           rng.normal(0, .1, (N, 4)).astype(np.float32)], 1)
    return np.stack([np.array(src), np.array(dst)]), feat, labels


@pytest.fixture(scope="module")
def part(tmp_path_factory):
    ei, feat, labels = _clustered_graph()
    root = str(tmp_path_factory.mktemp("tiered_parts"))
    probs = [np.random.default_rng(r).random(N) for r in range(S)]
    FrequencyPartitioner(root, S, N, ei, node_feat=feat, probs=probs,
                         chunk_size=8).partition()
    return root, labels


def _load_both(part, ratio=0.25):
    root, labels = part
    return (JaxDataset.load(root, hot_ratio=ratio, labels=labels),
            DistDataset.load(root, hot_ratio=ratio, labels=labels,
                             device="cpu"))


def test_dist_dataset_tiered_load_equal(part):
    jd, td = _load_both(part)
    assert isinstance(td.feature, TieredShardedFeature)
    jf, tf = jd.feature, td.feature
    assert (jf.nodes_per_shard, jf.hot_per_shard, jf.num_shards) == (
        tf.nodes_per_shard, tf.hot_per_shard, tf.num_shards)
    assert tf.hot_per_shard == round(tf.nodes_per_shard * 0.25)
    _eq(jf.hot, tf.hot, "hot")
    _eq(jf.cold, tf.cold, "cold")
    _eq(jd.labels, td.labels, "labels")
    for f in ("indptr", "indices", "edge_ids"):
        _eq(getattr(jd.graph, f), getattr(td.graph, f), f)
    # The tiered rows are the whole load's, split.
    full = DistDataset.load(part[0], labels=part[1], device="cpu").feature
    c, h = tf.nodes_per_shard, tf.hot_per_shard
    assert torch.equal(full.rows[:, :h], tf.hot)
    _eq(full.rows[:, h:], tf.cold)
    assert c == full.nodes_per_shard


# branch: (feature, step and pipeline knobs).  "xy" gathers features and
# labels in one exchange, the port serving the hot rows through B3's
# plain version; "xy_dedup" sends unique ids; "split" builds the tiered
# features over two extra rows, so its shards are wider than the
# graph's and the step takes the hot gather and a label exchange.
_BRANCHES = {
    "xy": {},
    "xy_dedup": {"dedup_gather": True},
    "split": {},
}


def _setup(part, branch, cold_cap=None):
    jd, td = _load_both(part)
    jf, tf = jd.feature, td.feature
    kw = _BRANCHES[branch]
    if branch == "split":
        full = np.concatenate([np.concatenate([np.asarray(jf.hot[s]),
                                               jf.cold[s]])
                               for s in range(S)])
        full = np.concatenate([full, np.zeros((2, full.shape[1]),
                                              np.float32)])
        jf = jfeat.shard_feature_tiered(full, S, 0.25)
        tf = shard_feature_tiered(full, S, 0.25, device="cpu")
        assert tf.nodes_per_shard != td.graph.nodes_per_shard
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=len(FANOUTS), dropout_rate=0.0)
    tx = optax.adam(LR)
    jstate = jdt.init_dist_state(jm, tx, jd.graph, jf, jax.random.PRNGKey(0),
                                 FANOUTS, BS)
    tm = GraphSAGE(tf.dim, HIDDEN, CLASSES, num_layers=len(FANOUTS),
                   dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(jstate.params))
    tstate = init_dist_state(tm, adam(LR), td.graph, tf, FANOUTS, BS)
    jmesh, tmesh = _jmesh(), Mesh(["cpu"] * S)
    jsam = jsamp.DistNeighborSampler(jd.graph, jmesh, num_neighbors=FANOUTS,
                                     batch_size=BS)
    tsam = DistNeighborSampler(td.graph, tmesh, num_neighbors=FANOUTS,
                               batch_size=BS)
    assert tsam.route == jsam.route
    jtrain = jdt.make_tiered_train_step(jm, tx, jd.graph, jf, jd.labels,
                                        jmesh, BS, **kw)
    ttrain = make_tiered_train_step(td.graph, tf, td.labels, tmesh, BS,
                                    fused_frontier=branch == "xy", **kw)
    pkw = dict(kw, cold_cap=cold_cap)
    jpipe = jdt.TieredTrainPipeline(jsam, jtrain, jf, jmesh, **pkw)
    tpipe = TieredTrainPipeline(tsam, ttrain, tf, tmesh, **pkw)
    batches = td.split_seeds(np.arange(N), BS, shuffle=True, seed=1)
    return jstate, tstate, jpipe, tpipe, batches, tf


def _assert_params(jparams, model, tol=1e-5):
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                   rtol=tol, err_msg=k)


@pytest.mark.parametrize("branch,cold_cap", [("xy", 5), ("xy_dedup", None)])
def test_stage_equal(part, branch, cold_cap):
    """Each batch's sample, compact slots and ids, drops and staged rows
    equal glt_tpu's for the same key (a small cap drops requests)."""
    _, _, jpipe, tpipe, batches, _ = _setup(part, branch, cold_cap)
    try:
        for b in range(2):
            key = 30 + b
            jout = jpipe.sampler.sample_from_nodes(
                jnp.asarray(batches[b]), key=jax.random.PRNGKey(key))
            jslots, jids, jdrop = jpipe._route(jout.node)
            jrows, _ = jpipe._stage_cold_async(jout).result()
            tout, fut = tpipe._sample_and_stage(
                batches[b], trandom.PRNGKey(key, device="cpu"))
            rows, slots, _, _ = fut.result()
            for f in ("node", "row", "col", "edge", "node_mask",
                      "edge_mask", "num_sampled_nodes", "num_sampled_edges"):
                _eq(getattr(jout, f), getattr(tout, f), f)
            _eq(jslots, slots, "slots")
            _eq(jdrop, tpipe.last_dropped, "dropped")
            live = np.asarray(jslots) >= 0
            _eq(np.asarray(jrows)[live], rows.numpy()[live], "rows")
        assert tpipe.flush_dropped() == jpipe.flush_dropped()
        assert tpipe.max_cold_rows == jpipe.max_cold_rows
        if cold_cap is not None:
            assert tpipe.dropped_total > 0
    finally:
        jpipe.close()
        tpipe.close()


@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_pipeline_three_batches_match_jax(part, branch):
    jstate, tstate, jpipe, tpipe, batches, _ = _setup(part, branch)
    try:
        jstate, jl, ja = jpipe.run_epoch(jstate, list(batches[:3]),
                                         jax.random.PRNGKey(5))
        tstate, tl, ta = tpipe.run_epoch(tstate, list(batches[:3]),
                                         trandom.PRNGKey(5, device="cpu"))
        np.testing.assert_allclose(torch.stack(tl).numpy(),
                                   np.asarray(jl), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(torch.stack(ta).numpy(),
                                   np.asarray(ja), atol=1e-6)
        assert tstate.step == int(jstate.step) == 3
        _assert_params(jstate.params, tstate.model)
        assert tpipe.flush_dropped() == jpipe.flush_dropped() == 0
    finally:
        jpipe.close()
        tpipe.close()


def test_start_batch_resumes_equal(part):
    """Batch 0 alone, then batches 1.. with ``start_batch=1``, equals
    one run of all of them (batch ``i`` keys on its position), and
    ``on_batch`` fires per trained batch."""
    _, state_a, _, pipe, batches, tf = _setup(part, "xy")
    _, state_b, _, _, _, _ = _setup(part, "xy")
    key = trandom.PRNGKey(9, device="cpu")
    hooks = []
    try:
        state_a, la, _ = pipe.run_epoch(state_a, list(batches[:4]), key)
        state_b, lb0, _ = pipe.run_epoch(state_b, list(batches[:1]), key)
        state_b, lb, _ = pipe.run_epoch(
            state_b, list(batches[:4]), key, start_batch=1,
            on_batch=lambda st, i: hooks.append((st.step, i)))
    finally:
        pipe.close()
    assert hooks == [(2, 1), (3, 2), (4, 3)]
    assert torch.equal(torch.stack(la), torch.stack(lb0 + lb))
    assert state_a.step == state_b.step == 4
    for k, v in state_a.model.state_dict().items():
        assert torch.equal(v, state_b.model.state_dict()[k]), k
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        pipe.run_epoch(state_a, [], key, supervisor=object())


def test_disk_cold_store_epoch_equals_host(part, tmp_path):
    """The pipeline over a DiskColdStore (a DRAM budget of 8 rows:
    misses, installs and evictions on the epoch's path) trains the same
    epochs bit for bit as over the HostColdStore, and publishes the
    ``glt.store.*`` gauges after each."""
    _, st_h, _, pipe_h, batches, tf = _setup(part, "xy")
    _, st_d, _, _, _, _ = _setup(part, "xy")
    full = np.concatenate([np.concatenate([tf.hot[s].numpy(), tf.cold[s]])
                           for s in range(S)])
    root = jax_write(str(tmp_path / "pipe_store"), full)
    store = DiskFeatureStore(root)
    disk = DiskColdStore(store, tf.nodes_per_shard, tf.hot_per_shard,
                         dram_budget_bytes=8 * store.row_nbytes,
                         stage_threads=2)
    pipe_d = TieredTrainPipeline(pipe_h.sampler, pipe_h.train_step, tf,
                                 pipe_h.mesh, cold_store=disk)
    metrics.reset()
    metrics.enable()
    try:
        for epoch in range(2):
            key = trandom.PRNGKey(epoch, device="cpu")
            st_h, lh, ah = pipe_h.run_epoch(st_h, list(batches), key)
            st_d, ld, ad = pipe_d.run_epoch(st_d, list(batches), key)
            assert torch.equal(torch.stack(lh), torch.stack(ld)), epoch
            assert torch.equal(torch.stack(ah), torch.stack(ad))
        snap = metrics.snapshot()
        assert snap["glt.store.budget_bytes"] == 8 * store.row_nbytes
        assert "glt.store.hit_rate" in snap
        st = disk.stager.stats()
        assert st["bytes_from_disk"] > 0
        assert st["resident_bytes"] <= 8 * store.row_nbytes
    finally:
        metrics.disable()
        metrics.reset()
        pipe_d.close()
        pipe_h.close()


def test_zero_row_cold_placeholder_refused_without_store(part, tmp_path):
    _, _, _, pipe, _, tf = _setup(part, "xy")
    pipe.close()
    full = np.concatenate([np.concatenate([tf.hot[s].numpy(), tf.cold[s]])
                           for s in range(S)])
    store = DiskFeatureStore(jax_write(str(tmp_path / "guard"), full))
    f3 = shard_feature_tiered_from_store(
        store, S, tf.hot_per_shard / tf.nodes_per_shard, device="cpu")
    assert f3.cold.shape == (S, 0, tf.dim)
    with pytest.raises(ValueError, match="cold_store"):
        TieredTrainPipeline(pipe.sampler, pipe.train_step, f3, pipe.mesh)
    disk = DiskColdStore(store, f3.nodes_per_shard, f3.hot_per_shard)
    TieredTrainPipeline(pipe.sampler, pipe.train_step, f3, pipe.mesh,
                        cold_store=disk).close()


def test_cold_gather_overlaps_compute(part, monkeypatch):
    """The staging thread gathers batch k's cold rows while the main
    thread trains batch k - 1: with a host delay d added to each batch's
    gather AND to each train step, an epoch grows by about n * d, not the
    2 * n * d of the two run in turn."""
    _, state, _, pipe, batches, _ = _setup(part, "xy")
    batches = list(batches)
    n = len(batches)
    key = trandom.PRNGKey(0, device="cpu")

    def epoch():
        nonlocal state
        t0 = time.perf_counter()
        state, _, _ = pipe.run_epoch(state, batches, key)
        return time.perf_counter() - t0

    try:
        epoch()
        base = min(epoch() for _ in range(2))
        delay = 0.05
        serve_into = pipe.cold_store.serve_into
        train = pipe.train_step

        def slow_serve(out, shard, req, **kw):
            if shard == 0:              # once a batch
                time.sleep(delay)
            return serve_into(out, shard, req, **kw)

        def slow_train(*args):
            time.sleep(delay)
            return train(*args)

        monkeypatch.setattr(pipe.cold_store, "serve_into", slow_serve)
        pipe.train_step = slow_train
        added = epoch() - base
    finally:
        pipe.close()
    injected = 2 * n * delay
    assert added < 0.75 * injected, (
        f"cold gather not overlapped: {injected:.2f} s injected on two "
        f"threads, {added:.2f} s landed on the epoch (base {base:.2f} s)")
