"""The port's 2-D (host, chip) mesh, hierarchical routing and ring
exchange against glt_tpu's, on the CPU.

Mirrors ``tests/test_hier_routing.py``: the topology seam (without
glt_tpu's ``GLT_ROUTE_FORCE`` cases: the port has no env override), the
cross-host cap, the byte models ``==`` glt_tpu's, the 2-D mesh, and
every "flat vs hier bit identity": one exchange hop (uncapped, capped,
a degenerate 1 x 8 grid forced hier), the feature and feature+label
exchanges, the tiered cold path, the distributed step, the scanned step,
the step with B3's serve (its plain version here) and the hetero step.
The port's hier output ``==`` its flat output, and each exchange ``==``
glt_tpu's hier output on the suite's 8 virtual CPU devices (the port
runs 8 x ``"cpu"``); the steps match glt_tpu's losses, accuracies and
parameters within 1e-5 (an other summation order, Adam's bias
correction placed differently; the hetero step at Adam's eps 1e-3, as
``tests/test_torch_hetero_models.py`` explains).  Then ``collective='ring'`` ``==``
glt_tpu's ring (``tests/test_parallel.py`` ``TestRingExchange``), and
``DistNeighborSampler`` on the 2-D mesh ``==`` glt_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from glt_tpu.data.topology import CSRTopo as JaxTopo
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models.rgat import RGAT as JaxRGAT
from glt_tpu.parallel import dist_feature as jfeat
from glt_tpu.parallel import dist_sampler as jsamp
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.parallel import multihost as jmh
from glt_tpu.parallel import dist_hetero_sampler as jhet
from glt_tpu.parallel import sharding as jshard
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo
from glt_tpu_torch.models import RGAT, GraphSAGE, adam, params_from_flax
from glt_tpu_torch.parallel import (
    DistHeteroNeighborSampler,
    DistNeighborSampler,
    Mesh,
    exchange_byte_model,
    exchange_gather,
    exchange_gather_hot,
    exchange_gather_xy,
    exchange_one_hop,
    global_mesh_2d,
    hier_request_cap,
    init_dist_state,
    init_hetero_dist_state,
    make_dist_train_step,
    make_hetero_dist_train_step,
    make_scanned_dist_train_step,
    mesh_axis_sizes,
    resolve_mesh_axes,
    route_cold_requests,
    shard_feature,
    shard_graph,
    shard_hetero_graph,
)
from glt_tpu_torch.parallel.dist_sampler import _topology_choice
from glt_tpu_torch.parallel.dist_train import dist_step_byte_model
from glt_tpu_torch.parallel.multihost import mesh_axes

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N_DEV = 8
TOL = 1e-5
FIELDS = ("node", "row", "col", "edge", "node_mask", "edge_mask",
          "num_sampled_nodes", "num_sampled_edges")


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# -- seam and static models ----------------------------------------------------
def test_topology_choice_seam():
    ax2 = ("host", "chip")
    # 1-D meshes pin flat, even when forced.
    for route, shape in (("auto", None), ("hier", (2, 4))):
        assert _topology_choice(route, "shard", shape) == "flat"
        assert jsamp._topology_choice(route, "shard", shape) == "flat"
    # A real 2-D grid defaults hier; degenerate grids default flat but
    # can be forced; bucketing tokens are not topology; no shape, flat.
    cases = [("auto", (2, 4), "hier"), ("sort", (2, 4), "hier"),
             ("onepass", (2, 2), "hier"), ("auto", (1, 8), "flat"),
             ("auto", (8, 1), "flat"), ("hier", (1, 8), "hier"),
             ("flat", (2, 4), "flat"), ("auto", None, "flat")]
    for route, shape, want in cases:
        assert _topology_choice(route, ax2, shape) == want
        assert jsamp._topology_choice(route, ax2, shape) == want


def test_hier_request_cap_bounds():
    cases = [((8, 4, 8), 8), ((8, 4, 1000), 32), ((8, 4, 1000, 0.5), 16),
             ((8, 4, 4, 0.5), 4), ((1, 1, 1, 0.01), 1)]
    for args, want in cases:
        assert hier_request_cap(*args) == jsamp.hier_request_cap(*args) \
            == want


def test_exchange_byte_model_split():
    per_slot = (1 + 6) * 4
    ici_f, dcn_f = exchange_byte_model("flat", 2, 4, 8, 6)
    assert (ici_f, dcn_f) == (3 * 8 * per_slot, 1 * 4 * 8 * per_slot)
    ici_h, dcn_h = exchange_byte_model("hier", 2, 4, 8, 6, hier_cap=8)
    assert (ici_h, dcn_h) == (3 * 2 * 8 * per_slot, 1 * 8 * per_slot)
    assert dcn_h < dcn_f
    for args in (("flat", 3, 2, 17, 9), ("hier", 3, 2, 17, 9),
                 ("hier", 2, 4, 5, 3, 7, 2), ("flat", 1, 8, 40, 129)):
        assert exchange_byte_model(*args) == \
            jsamp.exchange_byte_model(*args)
    with pytest.raises(ValueError, match="topology"):
        exchange_byte_model("ring", 2, 4, 8, 6)


@pytest.mark.parametrize("route,hlf", [("flat", None), ("hier", None),
                                       ("auto", None), ("auto", 0.5)])
def test_dist_step_byte_model_prefers_hier_dcn(route, hlf):
    kw = dict(nodes_per_shard=8, num_shards=8, num_neighbors=[3, 3],
              batch_size=4, frontier_cap=None, feature_dim=8,
              axis_name=("host", "chip"), mesh_shape=(2, 4), route=route,
              hier_load_factor=hlf)
    got = dist_step_byte_model(**kw)
    assert got == jdt.dist_step_byte_model(**kw)
    flat = dist_step_byte_model(**dict(kw, route="flat"))
    assert got["topology"] == ("flat" if route == "flat" else "hier")
    if got["topology"] == "hier":
        assert got["dcn"] < flat["dcn"]
    # 1-D meshes attribute everything to ICI.
    one_d = dict(kw, axis_name="shard", mesh_shape=None)
    assert dist_step_byte_model(**one_d) == jdt.dist_step_byte_model(
        **one_d)
    assert dist_step_byte_model(**one_d)["dcn"] == 0


def test_global_mesh_2d_shape_and_validation():
    mesh = global_mesh_2d(["cpu"] * N_DEV, num_hosts=2)
    jm = jmh.global_mesh_2d(num_hosts=2)
    assert tuple(mesh.axis_names) == tuple(jm.axis_names) == ("host", "chip")
    assert mesh.shape == dict(jm.shape) == {"host": 2, "chip": 4}
    assert mesh.size == N_DEV and str(mesh.device) == "cpu"
    assert mesh_axes(mesh) == resolve_mesh_axes(mesh) == ("host", "chip")
    assert mesh_axis_sizes(mesh, ("host", "chip")) == (2, 4)
    # Row-major: the flat order is the 1-D mesh's.
    assert mesh.devices == Mesh(["cpu"] * N_DEV).devices
    assert Mesh([["cpu"] * 2] * 3, ("host", "chip")).shape == {
        "host": 3, "chip": 2}
    one_d = Mesh(["cpu"] * N_DEV)
    assert mesh_axes(one_d) == "shard"
    assert mesh_axis_sizes(one_d, "shard") is None
    for h in (3, 0):
        with pytest.raises(ValueError, match="not divisible"):
            global_mesh_2d(["cpu"] * N_DEV, num_hosts=h)
    # Default rows = the process count (1 here): degenerate but valid.
    assert global_mesh_2d(["cpu"] * N_DEV).shape == {"host": 1,
                                                     "chip": N_DEV}
    with pytest.raises(ValueError, match="one row of devices a host"):
        Mesh(["cpu"] * 4, ("host", "chip"))
    with pytest.raises(ValueError, match="differ in length"):
        Mesh([["cpu"] * 2, ["cpu"]], ("host", "chip"))


# -- shared fixtures -------------------------------------------------------------
def _cluster(n=64, classes=4, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) % classes).astype(np.int32)
    src, dst = [], []
    for c in range(classes):
        members = np.where(labels == c)[0]
        for i in members:
            for j in rng.choice(members, 3, replace=False):
                src.append(i)
                dst.append(j)
    ei = np.stack([np.array(src), np.array(dst)])
    feat = np.eye(classes, dtype=np.float32)[labels]
    feat = np.concatenate(
        [feat, rng.normal(0, .1, (n, dim - classes)).astype(np.float32)],
        1)
    return ei, feat, labels


def _frontier(n, b=8, seed=3):
    """[S, b] frontier with cross-chip duplicates (hub ids 0 and 1 in
    every shard's list) and one padded slot."""
    rng = np.random.default_rng(seed)
    ids = np.stack([
        np.concatenate([[0, 1],
                        rng.integers(0, n, size=b - 2)]).astype(np.int32)
        for _ in range(N_DEV)])
    ids[0, -1] = -1
    return ids


def _meshes(h):
    return jmh.global_mesh_2d(num_hosts=h), global_mesh_2d(["cpu"] * N_DEV,
                                                           num_hosts=h)


def _shard_call(mesh, body, *arrays):
    axis_name = resolve_mesh_axes(mesh)
    spec = P(axis_name)

    def wrapped(*blks):
        out = body(*[b[0] for b in blks])
        return jax.tree.map(lambda x: x[None], out)

    fn = jax.jit(jax.shard_map(
        wrapped, mesh=mesh, in_specs=(spec,) * len(arrays),
        out_specs=spec, check_vma=False))
    return jax.tree.map(np.asarray, fn(*arrays))


# -- exchange primitives: port flat == port hier == glt_tpu hier ---------------
@pytest.mark.parametrize("num_hosts,remote_cap", [(2, None), (2, 5),
                                                  (1, None)])
def test_exchange_one_hop_flat_hier_bit_identity(num_hosts, remote_cap):
    ei, _, _ = _cluster()
    jm, tm = _meshes(num_hosts)
    ax = resolve_mesh_axes(jm)
    ms = mesh_axis_sizes(jm, ax)
    jg = jshard.shard_graph(JaxTopo(ei, num_nodes=64), N_DEV)
    tg = shard_graph(CSRTopo(ei, num_nodes=64), N_DEV, device="cpu")
    seeds = _frontier(64)
    key = jax.random.PRNGKey(5)

    def body(ip, ix, e, s):
        k = jax.random.fold_in(key, lax.axis_index(ax))
        nbrs, eids, _, dropped = jsamp.exchange_one_hop(
            s, ip, ix, e, jg.nodes_per_shard, N_DEV, 3, k, ax,
            remote_cap=remote_cap, route="hier", mesh_shape=ms)
        return nbrs, eids, dropped[None]

    want = _shard_call(jm, body, jg.indptr, jg.indices, jg.edge_ids,
                       jnp.asarray(seeds))
    tk = trandom.PRNGKey(5, device="cpu")
    keys = [trandom.fold_in(tk, s) for s in range(N_DEV)]
    got = {}
    for route in ("flat", "hier"):
        got[route] = exchange_one_hop(
            torch.from_numpy(seeds), tg.indptr, tg.indices, tg.edge_ids,
            tg.nodes_per_shard, N_DEV, 3, keys, remote_cap=remote_cap,
            route=route, mesh_shape=tuple(tm.shape.values()),
            axis_name=resolve_mesh_axes(tm))
    for s in range(N_DEV):
        for i, what in ((0, "nbrs"), (1, "eids")):
            assert torch.equal(got["flat"][s][i], got["hier"][s][i])
            _eq(want[i][s], got["hier"][s][i], f"shard {s} {what}")
        _eq(want[2][s], got["hier"][s][3].reshape(1), f"shard {s} dropped")
    # Padded seed slots stay inert under both topologies.
    assert not got["flat"][0][2][-1].any()


@pytest.mark.parametrize("dedup", [False, True])
def test_exchange_gather_flat_hier_bit_identity(dedup):
    _, feat, _ = _cluster()
    jm, tm = _meshes(2)
    ax = resolve_mesh_axes(jm)
    ms = mesh_axis_sizes(jm, ax)
    jf = jshard.shard_feature(feat, N_DEV)
    tf = shard_feature(feat, N_DEV, device="cpu")
    ids = _frontier(feat.shape[0])

    def body(i, rows):
        return jfeat.exchange_gather(i, rows, jf.nodes_per_shard, N_DEV, ax,
                                     dedup=dedup, route="hier",
                                     mesh_shape=ms)

    want = _shard_call(jm, body, jnp.asarray(ids), jf.rows)
    got = {r: exchange_gather(torch.from_numpy(ids), tf.rows,
                              tf.nodes_per_shard, N_DEV, dedup=dedup,
                              route=r, mesh_shape=ms)
           for r in ("flat", "hier")}
    ref = np.where((ids >= 0)[..., None], feat[np.maximum(ids, 0)], 0.0)
    for s in range(N_DEV):
        assert torch.equal(got["flat"][s], got["hier"][s])
        _eq(want[s], got["hier"][s], f"shard {s}")
        _eq(ref[s].astype(np.float32), got["hier"][s])


@pytest.mark.parametrize("fused", [True, False])
def test_exchange_gather_xy_flat_hier_bit_identity(fused):
    _, feat, labels = _cluster()
    jm, tm = _meshes(2)
    ax = resolve_mesh_axes(jm)
    ms = mesh_axis_sizes(jm, ax)
    jf = jshard.shard_feature(feat, N_DEV)
    tf = shard_feature(feat, N_DEV, device="cpu")
    lab = labels.reshape(N_DEV, tf.nodes_per_shard)
    ids = _frontier(feat.shape[0])

    def body(i, rows, lcol):
        return jfeat.exchange_gather_xy(i, rows, lcol, jf.nodes_per_shard,
                                        N_DEV, ax, fused=fused,
                                        route="hier", mesh_shape=ms)

    wx, wy = _shard_call(jm, body, jnp.asarray(ids), jf.rows,
                         jnp.asarray(lab))
    got = {r: exchange_gather_xy(torch.from_numpy(ids), tf.rows,
                                 torch.from_numpy(lab), tf.nodes_per_shard,
                                 N_DEV, fused=fused, route=r, mesh_shape=ms)
           for r in ("flat", "hier")}
    ref_y = np.where(ids >= 0, labels[np.maximum(ids, 0)], 0)
    for s in range(N_DEV):
        for i in (0, 1):
            assert torch.equal(got["flat"][s][i], got["hier"][s][i])
        _eq(wx[s], got["hier"][s][0], f"shard {s} x")
        _eq(wy[s], got["hier"][s][1], f"shard {s} y")
        _eq(ref_y[s].astype(np.int32), got["hier"][s][1])


def test_tiered_cold_path_flat_hier_bit_identity():
    """route_cold_requests + host staging + exchange_gather_hot under
    both topologies: the request layouts differ ([S*b] flat, [H*hier_cap]
    hier, smaller), the gathered rows do not; the hier request vector
    equals glt_tpu's."""
    _, feat, _ = _cluster()
    jm, tm = _meshes(2)
    ax = resolve_mesh_axes(jm)
    ms = mesh_axis_sizes(jm, ax)
    n, d = feat.shape
    c = n // N_DEV
    hot = c // 2
    blocks = torch.from_numpy(feat.reshape(N_DEV, c, d))
    ids = _frontier(n)
    want = _shard_call(jm, lambda i: jfeat.route_cold_requests(
        i, c, hot, N_DEV, ax, route="hier", mesh_shape=ms),
        jnp.asarray(ids))
    shapes, got = {}, {}
    for route in ("flat", "hier"):
        req = route_cold_requests(torch.from_numpy(ids), c, hot, N_DEV,
                                  route=route, mesh_shape=ms)
        if route == "hier":
            for s in range(N_DEV):
                _eq(want[s], req[s], f"shard {s} cold requests")
        shapes[route] = req[0].shape[0]
        rows, slots = [], []
        for s in range(N_DEV):
            cold = torch.nonzero(req[s] >= 0).reshape(-1)
            sl = torch.full((shapes[route],), -1, dtype=torch.int32)
            sl[: cold.numel()] = cold.to(torch.int32)
            rw = torch.zeros((shapes[route], d))
            rw[: cold.numel()] = blocks[s, hot:][req[s][cold].long()]
            rows.append(rw)
            slots.append(sl)
        got[route] = exchange_gather_hot(
            torch.from_numpy(ids), blocks[:, :hot], c, hot, N_DEV,
            staged_rows=rows, staged_slots=slots, route=route,
            mesh_shape=ms)
    ref = np.where((ids >= 0)[..., None], feat[np.maximum(ids, 0)], 0.0)
    for s in range(N_DEV):
        assert torch.equal(got["flat"][s], got["hier"][s])
        _eq(ref[s].astype(np.float32), got["hier"][s])
    assert shapes["hier"] < shapes["flat"]


# -- train steps: port flat == port hier, both within 1e-5 of glt_tpu ----------
def _dist_setup2d(bs=4):
    ei, feat, labels = _cluster()
    jm, tm = _meshes(2)
    jg = jshard.shard_graph(JaxTopo(ei, num_nodes=64), N_DEV)
    tg = shard_graph(CSRTopo(ei, num_nodes=64), N_DEV, device="cpu")
    jf = jshard.shard_feature(feat, N_DEV)
    tf = shard_feature(feat, N_DEV, device="cpu")
    lab = labels.reshape(N_DEV, tg.nodes_per_shard)
    rng = np.random.default_rng(1)
    seeds = np.stack([rng.choice(np.arange(s * 8, (s + 1) * 8), bs,
                                 replace=False)
                      for s in range(N_DEV)]).astype(np.int32)
    seeds[0, -1] = -1
    jmodel = JaxSAGE(hidden_features=16, out_features=4, num_layers=2,
                     dropout_rate=0.0)
    jstate = jdt.init_dist_state(jmodel, optax.adam(1e-2), jg, jf,
                                 jax.random.PRNGKey(0), [3, 3], bs)
    return dict(jm=jm, tm=tm, jg=jg, tg=tg, jf=jf, tf=tf, lab=lab,
                seeds=seeds, jmodel=jmodel, jstate=jstate, bs=bs)


def _tstate(d):
    model = GraphSAGE(8, 16, 4, num_layers=2, dropout_rate=0.0)
    model.load_state_dict(params_from_flax(d["jstate"].params))
    return init_dist_state(model, adam(1e-2), d["tg"], d["tf"], [3, 3],
                           d["bs"])


def _same_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_dist_train_step_flat_hier_bit_identity():
    d = _dist_setup2d()
    base_j, base_t = jax.random.PRNGKey(17), trandom.PRNGKey(17,
                                                             device="cpu")
    runs = {}
    for route in ("flat", "hier"):
        st = _tstate(d)
        step = make_dist_train_step(d["tg"], d["tf"],
                                    torch.from_numpy(d["lab"]), d["tm"],
                                    [3, 3], d["bs"], route=route)
        losses, accs = [], []
        for i in range(2):
            st, loss, acc = step(st, d["seeds"], trandom.fold_in(base_t, i))
            losses.append(loss)
            accs.append(acc)
            if i == 0:
                first = {k: v.clone() for k, v in
                         st.model.state_dict().items()}
        runs[route] = (st, torch.stack(losses), torch.stack(accs),
                       step.collective_bytes, first)
    assert torch.equal(runs["flat"][1], runs["hier"][1])
    assert torch.equal(runs["flat"][2], runs["hier"][2])
    assert _same_params(runs["flat"][0], runs["hier"][0])
    bf, bh = runs["flat"][3], runs["hier"][3]
    assert bf["topology"] == "flat" and bh["topology"] == "hier"
    assert bh["dcn"] < bf["dcn"]
    jstep = jdt.make_dist_train_step(d["jmodel"], optax.adam(1e-2), d["jg"],
                                     d["jf"], jnp.asarray(d["lab"]),
                                     d["jm"], [3, 3], d["bs"], route="hier")
    assert jstep.collective_bytes == bh
    # glt_tpu's first step (one compile) against the port's.
    jst, loss, acc = jstep(d["jstate"], jnp.asarray(d["seeds"]),
                           jax.random.fold_in(base_j, 0))
    _close(runs["hier"][1][0], float(loss), "loss")
    _close(runs["hier"][2][0], float(acc), "acc")
    for k, v in params_from_flax(jst.params).items():
        _close(runs["hier"][4][k].numpy(), v.numpy(), k)


def test_scanned_dist_step_flat_hier_bit_identity():
    d = _dist_setup2d()
    blk = np.stack([d["seeds"]] * 2)
    blk[1, :, 0] += 1
    key = trandom.PRNGKey(29, device="cpu")
    runs = {}
    for route in ("flat", "hier"):
        step = make_scanned_dist_train_step(
            d["tg"], d["tf"], torch.from_numpy(d["lab"]), d["tm"], [3, 3],
            d["bs"], route=route)
        assert step.collective_bytes["topology"] == route
        runs[route] = step(_tstate(d), blk, key)
    for i in (1, 2):
        assert torch.equal(runs["flat"][i], runs["hier"][i])
    assert runs["hier"][0].step == 2
    assert _same_params(runs["flat"][0], runs["hier"][0])


def test_dist_fused_frontier_flat_hier_bit_identity():
    """B3's serve (its plain version on the CPU) inside the 2-D mesh's
    step: flat and hier equal, and equal to the step without it."""
    d = _dist_setup2d()
    key = trandom.PRNGKey(7, device="cpu")
    runs = {}
    for route, ff in (("flat", True), ("hier", True), ("hier", False)):
        step = make_dist_train_step(d["tg"], d["tf"],
                                    torch.from_numpy(d["lab"]), d["tm"],
                                    [3, 3], d["bs"], fused_frontier=ff,
                                    route=route)
        runs[route, ff] = step(_tstate(d), d["seeds"], key)
    for other in (("hier", True), ("hier", False)):
        a, b = runs["flat", True], runs[other]
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        assert _same_params(a[0], b[0])


# -- hetero: the bipartite user/item fixture -------------------------------------
ADAM_EPS = 1e-3   # see tests/test_torch_hetero_models.py
ET_UI = ("user", "clicks", "item")
ET_IU = ("item", "rev_clicks", "user")


def _bipartite():
    U, I, classes = 64, 32, 4
    rng = np.random.default_rng(0)
    labels = (np.arange(U) % classes).astype(np.int32)
    u_src = np.repeat(np.arange(U), 3)
    i_dst = np.concatenate([
        [(u % classes) + classes * ((u // classes + k) % (I // classes))
         for k in range(3)] for u in range(U)])
    eis = {ET_UI: (np.stack([u_src, i_dst]), U),
           ET_IU: (np.stack([i_dst, u_src]), I)}
    user = rng.normal(0, .1, (U, classes)).astype(np.float32)
    item = np.eye(classes, dtype=np.float32)[np.arange(I) % classes]
    return eis, {"user": user, "item": item}, labels


def test_hetero_dist_train_flat_hier_bit_identity():
    eis, feats, labels = _bipartite()
    jm, tm = _meshes(2)
    bs, classes = 4, 4
    jsh = jhet.shard_hetero_graph(
        {et: JaxTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, N_DEV)
    tsh = shard_hetero_graph(
        {et: CSRTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, N_DEV,
        device="cpu")
    jf = {t: jshard.shard_feature(x, N_DEV) for t, x in feats.items()}
    tf = {t: shard_feature(x, N_DEV, device="cpu") for t, x in feats.items()}
    lab = labels.reshape(N_DEV, -1)
    jmodel = JaxRGAT(edge_types=[ET_IU, ET_UI], hidden_features=16,
                     out_features=classes, target_type="user", num_layers=2,
                     conv="gat", dropout_rate=0.0)
    tx = optax.adam(1e-2, eps=ADAM_EPS)
    jsamp_h = jhet.DistHeteroNeighborSampler(jsh, jm, [3, 3], "user",
                                             batch_size=bs, frontier_cap=32,
                                             seed=0, route="hier")
    jst = jdt.init_hetero_dist_state(jmodel, tx, jsamp_h, jf,
                                     jax.random.PRNGKey(0))
    seeds = np.stack([
        np.random.default_rng(s).choice(np.arange(s * 8, (s + 1) * 8), bs,
                                        replace=False)
        for s in range(N_DEV)]).astype(np.int32)
    runs = {}
    for route in ("flat", "hier"):
        samp = DistHeteroNeighborSampler(tsh, tm, [3, 3], "user",
                                         batch_size=bs, frontier_cap=32,
                                         seed=0, route=route)
        model = RGAT([ET_IU, ET_UI], {"user": 4, "item": 4}, 16, classes,
                     "user", num_layers=2, conv="gat", dropout_rate=0.0)
        model.load_state_dict(params_from_flax(jst.params))
        st = init_hetero_dist_state(model, lambda ps: torch.optim.Adam(
            list(ps), lr=1e-2, eps=ADAM_EPS), samp, tf)
        step = make_hetero_dist_train_step(samp, tf, torch.from_numpy(lab),
                                           tm, bs, route=route)
        losses = []
        for it in range(2):
            st, loss, _ = step(st, seeds,
                               trandom.PRNGKey(100 + it, device="cpu"))
            losses.append(loss)
            if it == 0:
                first = {k: v.clone() for k, v in
                         st.model.state_dict().items()}
        runs[route] = (st, torch.stack(losses), first)
    assert torch.equal(runs["flat"][1], runs["hier"][1])
    assert _same_params(runs["flat"][0], runs["hier"][0])
    jstep = jdt.make_hetero_dist_train_step(jmodel, tx, jsamp_h, jf,
                                            jnp.asarray(lab), jm,
                                            batch_size=bs, route="hier")
    # glt_tpu's first step (one compile) against the port's.
    jst, loss, _ = jstep(jst, jnp.asarray(seeds), jax.random.PRNGKey(100))
    _close(runs["hier"][1][0], float(loss), "loss")
    for k, v in params_from_flax(jst.params).items():
        _close(runs["hier"][2][k].numpy(), v.numpy(), k)


# -- the ring and the 2-D sampler against glt_tpu --------------------------------
def _ring_topo(n):
    src = np.repeat(np.arange(n), 2)
    dst = np.concatenate([[(i + 1) % n, (i + 2) % n] for i in range(n)])
    return np.stack([src, dst])


def test_ring_matches_semantics():
    """glt_tpu's TestRingExchange on the port: on a degree == fanout
    graph the ring gives every seed its whole neighborhood."""
    n = 64
    sg = shard_graph(CSRTopo(_ring_topo(n), num_nodes=n), N_DEV,
                     device="cpu")
    samp = DistNeighborSampler(sg, Mesh(["cpu"] * N_DEV), num_neighbors=[2],
                               batch_size=4, collective="ring", seed=3)
    seeds = np.zeros((N_DEV, 4), np.int32)
    for s in range(N_DEV):
        seeds[s] = [(s * 8 + 5 + k * 11) % n for k in range(4)]
    out = samp.sample_from_nodes(seeds)
    node, row, col = out.node.numpy(), out.row.numpy(), out.col.numpy()
    emask = out.edge_mask.numpy()
    for s in range(N_DEV):
        for seed in seeds[s]:
            got = sorted(node[s, row[s, e]] for e in np.where(emask[s])[0]
                         if node[s, col[s, e]] == seed)
            assert got == sorted([(seed + 1) % n, (seed + 2) % n])


def _sampler_pair(two_d, s, **kw):
    """glt_tpu's and the port's sampler over ``s`` shards, on a 1-D mesh
    or a 2 x (s / 2) one."""
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, 64, 300), rng.integers(0, 64, 300)])
    jg = jshard.shard_graph(JaxTopo(ei, num_nodes=64), s)
    tg = shard_graph(CSRTopo(ei, num_nodes=64), s, device="cpu")
    devs = np.array(jax.devices()[:s])
    if two_d:
        jm = JaxMesh(devs.reshape(2, s // 2), ("host", "chip"))
        tm = global_mesh_2d(["cpu"] * s, num_hosts=2)
    else:
        jm = JaxMesh(devs, ("shard",))
        tm = Mesh(["cpu"] * s)
    return (jsamp.DistNeighborSampler(jg, jm, num_neighbors=[3, 2],
                                      batch_size=4, **kw),
            DistNeighborSampler(tg, tm, num_neighbors=[3, 2], batch_size=4,
                                **kw))


@pytest.mark.parametrize("two_d,s,kw", [
    (False, 4, {"collective": "ring"}),
    (True, 4, {"collective": "ring", "exchange_load_factor": 2.0}),
    (True, 8, {}),
    (True, 8, {"route": "flat"}),
    (True, 8, {"hier_load_factor": 0.5}),
    (True, 8, {"exchange_load_factor": 2.0, "hier_load_factor": 0.5}),
])
def test_dist_sampler_ring_and_2d_equal_jax(two_d, s, kw):
    """Two consecutive calls: every field and the drops ``==``."""
    js, ts = _sampler_pair(two_d, s, **kw)
    assert ts.route == js.route
    seeds = np.random.default_rng(4).integers(0, 64, (s, 4)).astype(
        np.int32)
    seeds[1, -1] = -1
    for _ in range(2):
        jo, to = js.sample_from_nodes(jnp.asarray(seeds)), \
            ts.sample_from_nodes(seeds)
        for f in FIELDS:
            _eq(getattr(jo, f), getattr(to, f), f)
        if jo.metadata is None:
            assert to.metadata is None
        else:
            _eq(jo.metadata["exchange_dropped"],
                to.metadata["exchange_dropped"], "dropped")
