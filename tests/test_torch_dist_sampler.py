"""glt_tpu_torch.parallel's sharding, routing, sampling exchange and
feature exchange against glt_tpu.parallel, shard by shard.

JAX runs each shard body under ``shard_map`` on the suite's virtual CPU
devices; the port runs the same shards in turn on S x ``"cpu"``.  Same
graph, seeds and keys on both sides; every field compares with ``==``:
routing plans (sort and one-pass, with a cap that drops), one exchange
hop (uncapped and capped, fused on and off), the multi-hop sample
(dense and sort dedup, both final-hop modes, a frontier cap), two
consecutive ``DistNeighborSampler`` calls, the sharded blocks, and the
feature and feature+label exchanges, labels at the int32 extremes
included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.parallel import dist_feature as jfeat
from glt_tpu.parallel import dist_sampler as jsamp
from glt_tpu.parallel import sharding as jshard
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo
from glt_tpu_torch.parallel import (
    DistNeighborSampler,
    Mesh,
    build_routing,
    dist_sample_multi_hop,
    exchange_gather,
    exchange_gather_xy,
    exchange_one_hop,
    put_sharded,
    shard_feature,
    shard_graph,
)
from glt_tpu_torch.parallel.dist_sampler import (
    _bucket_by_owner_onepass,
    _bucket_by_owner_sort,
    _bucket_payload,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, DIM = 400, 6
I32_MIN, I32_MAX = -2**31, 2**31 - 1
FIELDS = ("node", "row", "col", "edge", "batch", "node_mask", "edge_mask",
          "num_sampled_nodes", "num_sampled_edges")


def _coo(n=N, seed=0):
    """Power-law-ish COO in shuffled order with a hub and isolated
    nodes, so edge ids are not CSR positions."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, n), 40)
    deg[:3] = [0, 120, 1]
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    perm = rng.permutation(src.size)
    return np.stack([src[perm], dst[perm]])


@pytest.fixture(scope="module")
def graphs():
    ei = _coo()
    jt, tt = JaxTopo(ei, num_nodes=N), CSRTopo(ei, num_nodes=N)
    return {s: (jshard.shard_graph(jt, s), shard_graph(tt, s, device="cpu"))
            for s in (2, 4)}


def _jmesh(s):
    return JaxMesh(np.array(jax.devices()[:s]), ("shard",))


def _seeds(s, b, c, seed=3):
    """Per-shard seed rows mixing own and remote ids, duplicates and
    padding."""
    rng = np.random.default_rng(seed + s)
    out = rng.integers(0, N, (s, b)).astype(np.int32)
    for r in range(s):
        own = np.arange(r * c, min((r + 1) * c, N))
        out[r, : b // 3] = rng.choice(own, b // 3)
    out[:, -2:] = -1
    out[0, 2] = out[0, 3]
    return out


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _shard_map(fn, s, n_in, n_out):
    spec = P("shard")
    return jax.jit(jax.shard_map(
        fn, mesh=_jmesh(s), in_specs=(spec,) * n_in + (P(),),
        out_specs=(spec,) * n_out if n_out > 1 else spec, check_vma=False))


def test_shard_graph_and_feature(graphs):
    feat = np.random.default_rng(1).standard_normal((N, DIM)).astype(
        np.float32)
    for s, (jg, tg) in graphs.items():
        for f in ("indptr", "indices", "edge_ids"):
            _eq(getattr(jg, f), getattr(tg, f), f)
        assert (jg.nodes_per_shard, jg.num_nodes, jg.num_shards) == (
            tg.nodes_per_shard, tg.num_nodes, tg.num_shards)
        ids = np.array([-1, 0, 5, N - 1, tg.nodes_per_shard], np.int32)
        _eq(jg.owner_of(jnp.asarray(ids)), tg.owner_of(torch.from_numpy(ids)))
        jf = jshard.shard_feature(feat, s)
        tf = shard_feature(feat, s, device="cpu")
        _eq(jf.rows, tf.rows)
        assert jf.nodes_per_shard == tf.nodes_per_shard
        placed = put_sharded(tg, Mesh(["cpu"] * s))
        _eq(placed.indices, tg.indices)


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("route", ["sort", "onepass"])
@pytest.mark.parametrize("cap", [None, 3])
def test_build_routing(s, route, cap):
    rng = np.random.default_rng(s * 7 + (cap or 0))
    c = -(-N // s)
    ids = rng.integers(0, N, 40).astype(np.int32)
    ids[rng.random(40) < 0.2] = -1
    j = jax.jit(lambda i: jsamp.build_routing(i, c, s, cap=cap,
                                              route=route))(ids)
    t = build_routing(torch.from_numpy(ids), c, s, cap=cap, route=route)
    for f in ("buckets", "slot", "valid", "dropped"):
        _eq(getattr(j, f), getattr(t, f), f)
    if cap is not None:
        assert int(t.dropped) > 0      # the cap is small enough to drop
    payload = rng.integers(0, 1000, 40).astype(np.int32)
    k = 40 if cap is None else cap
    _eq(jsamp._bucket_payload(j, jnp.asarray(payload), s, k),
        _bucket_payload(t, torch.from_numpy(payload), s, k), "payload")


def test_sort_equals_onepass_adversarial():
    """Every id owned by one shard: the largest rank and overflow."""
    ids = torch.arange(30, 62, dtype=torch.int32) % 10 + 30
    owner = torch.full((32,), 3, dtype=torch.int32)
    a = _bucket_by_owner_sort(ids, owner, 8, 4)
    b = _bucket_by_owner_onepass(ids, owner, 8, 4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.dropped) == 28


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_exchange_one_hop(graphs, s, capped, fused):
    jg, tg = graphs[s]
    c, b, fanout = tg.nodes_per_shard, 24, 5
    remote_cap = 4 if capped else None
    seeds = _seeds(s, b, c)

    def body(ip, ix, ei, sd, key):
        k = jax.random.fold_in(key, lax.axis_index("shard"))
        nb, e, m, d = jsamp.exchange_one_hop(
            sd[0], ip[0], ix[0], ei[0], c, s, fanout, k, "shard",
            remote_cap=remote_cap, fused=fused)
        return nb[None], e[None], m[None], d[None]

    jout = _shard_map(body, s, 4, 4)(jg.indptr, jg.indices, jg.edge_ids,
                                     jnp.asarray(seeds),
                                     jax.random.PRNGKey(11))
    key = trandom.PRNGKey(11, device="cpu")
    tout = exchange_one_hop(
        torch.from_numpy(seeds), tg.indptr, tg.indices, tg.edge_ids, c, s,
        fanout, [trandom.fold_in(key, r) for r in range(s)],
        remote_cap=remote_cap, fused=fused)
    for r in range(s):
        for name, ja, ta in zip(("nbrs", "eids", "mask", "dropped"),
                                jout, tout[r]):
            _eq(np.asarray(ja)[r], ta, f"shard {r} {name}")
    if capped:
        assert sum(int(t[3]) for t in tout) > 0


def _jax_multi_hop(jg, tg, s, seeds, fanouts, **kw):
    c = tg.nodes_per_shard

    def body(ip, ix, ei, sd, key):
        k = jax.random.fold_in(key, lax.axis_index("shard"))
        out = jsamp.dist_sample_multi_hop(
            ip[0], ix[0], ei[0], sd[0], k, fanouts, c, s, "shard", **kw)
        return jax.tree.map(lambda x: x[None], out)

    fn = jax.jit(jax.shard_map(
        body, mesh=_jmesh(s), in_specs=(P("shard"),) * 4 + (P(),),
        out_specs=P("shard"), check_vma=False))
    return fn(jg.indptr, jg.indices, jg.edge_ids, jnp.asarray(seeds),
              jax.random.PRNGKey(5))


def _compare_outputs(jout, touts):
    for r, t in enumerate(touts):
        for f in FIELDS:
            _eq(np.asarray(getattr(jout, f))[r], getattr(t, f),
                f"shard {r} {f}")
        if jout.metadata is None:
            assert t.metadata is None
        else:
            _eq(np.asarray(jout.metadata["exchange_dropped"])[r],
                t.metadata["exchange_dropped"], "exchange_dropped")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dedup", ["dense", "sort"])
@pytest.mark.parametrize("last_hop_dedup", [True, False])
def test_dist_sample_multi_hop(graphs, s, dedup, last_hop_dedup):
    jg, tg = graphs[s]
    fanouts, b = [4, 3], 8
    seeds = _seeds(s, b, tg.nodes_per_shard)
    jout = _jax_multi_hop(jg, tg, s, seeds, fanouts, dedup=dedup,
                          last_hop_dedup=last_hop_dedup)
    key = trandom.PRNGKey(5, device="cpu")
    touts = dist_sample_multi_hop(
        tg.indptr, tg.indices, tg.edge_ids, torch.from_numpy(seeds),
        [trandom.fold_in(key, r) for r in range(s)], fanouts,
        tg.nodes_per_shard, s, dedup=dedup, last_hop_dedup=last_hop_dedup)
    _compare_outputs(jout, touts)


@pytest.mark.parametrize("case", ["frontier_cap", "capped", "capped_sort"])
def test_dist_sample_multi_hop_caps(graphs, case):
    s = 4
    jg, tg = graphs[s]
    fanouts, b = [5, 4, 2], 8
    kw = {"frontier_cap": 24} if case == "frontier_cap" else {
        "exchange_load_factor": 0.5,
        "dedup": "sort" if case == "capped_sort" else "dense"}
    seeds = _seeds(s, b, tg.nodes_per_shard)
    jout = _jax_multi_hop(jg, tg, s, seeds, fanouts, **kw)
    key = trandom.PRNGKey(5, device="cpu")
    touts = dist_sample_multi_hop(
        tg.indptr, tg.indices, tg.edge_ids, torch.from_numpy(seeds),
        [trandom.fold_in(key, r) for r in range(s)], fanouts,
        tg.nodes_per_shard, s, **kw)
    _compare_outputs(jout, touts)
    if case != "frontier_cap":
        assert sum(int(t.metadata["exchange_dropped"]) for t in touts) > 0


@pytest.mark.parametrize("s", [2, 4])
def test_sampler_consecutive_calls(graphs, s):
    jg, tg = graphs[s]
    fanouts, b = [3, 3], 6
    jsam = jsamp.DistNeighborSampler(jg, _jmesh(s), num_neighbors=fanouts,
                                     batch_size=b, seed=2)
    tsam = DistNeighborSampler(tg, Mesh(["cpu"] * s), num_neighbors=fanouts,
                               batch_size=b, seed=2)
    assert tsam.route == jsam.route
    for call in range(2):
        seeds = _seeds(s, b, tg.nodes_per_shard, seed=call)
        jout = jsam.sample_from_nodes(jnp.asarray(seeds))
        tout = tsam.sample_from_nodes(seeds)
        for f in FIELDS:
            _eq(getattr(jout, f), getattr(tout, f), f"call {call} {f}")


def _gather_ids(s, c, b=20, seed=9):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, s * c, (s, b)).astype(np.int32)
    ids[:, 5] = ids[:, 4]                  # duplicates
    ids[:, -3:] = -1
    return ids


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("fused_frontier", [False, True])
def test_exchange_gather(s, dedup, fused_frontier):
    c = -(-N // s)
    rows = np.random.default_rng(s).standard_normal((s, c, DIM)).astype(
        np.float32)
    ids = _gather_ids(s, c)

    def body(rw, i, _):
        return jfeat.exchange_gather(i[0], rw[0], c, s, "shard",
                                     dedup=dedup)[None]

    jx = _shard_map(body, s, 2, 1)(jnp.asarray(rows), jnp.asarray(ids),
                                   jnp.zeros(()))
    tx = exchange_gather(torch.from_numpy(ids), torch.from_numpy(rows), c,
                         s, dedup=dedup, fused_frontier=fused_frontier)
    for r in range(s):
        _eq(np.asarray(jx)[r], tx[r], f"shard {r}")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_exchange_gather_xy(s, dedup, fused):
    c = -(-N // s)
    rng = np.random.default_rng(s + 1)
    rows = rng.standard_normal((s, c, DIM)).astype(np.float32)
    labels = rng.integers(0, 50, (s, c)).astype(np.int32)
    # Labels whose bits are a NaN, -0.0 and a NaN payload as f32.
    labels[0, :3] = [I32_MIN, -1, I32_MAX]
    ids = _gather_ids(s, c)
    ids[0, :3] = [0, 1, 2]

    def body(rw, lb, i, _):
        x, y = jfeat.exchange_gather_xy(i[0], rw[0], lb[0], c, s, "shard",
                                        dedup=dedup, fused=fused)
        return x[None], y[None]

    jx, jy = _shard_map(body, s, 3, 2)(jnp.asarray(rows),
                                       jnp.asarray(labels),
                                       jnp.asarray(ids), jnp.zeros(()))
    txy = exchange_gather_xy(torch.from_numpy(ids), torch.from_numpy(rows),
                             torch.from_numpy(labels), c, s, dedup=dedup,
                             fused=fused)
    for r in range(s):
        _eq(np.asarray(jx)[r], txy[r][0], f"shard {r} x")
        _eq(np.asarray(jy)[r], txy[r][1], f"shard {r} y")
    assert txy[0][1][:3].tolist() == [I32_MIN, -1, I32_MAX]


def test_mesh_refuses_what_is_not_ported():
    """A 2-D (host, chip) mesh builds; distinct devices still raise,
    naming the step of the queue item they wait for."""
    mesh2 = Mesh([["cpu"] * 2] * 2, ("host", "chip"))
    assert mesh2.size == 4 and mesh2.shape == {"host": 2, "chip": 2}
    with pytest.raises(NotImplementedError, match="queue A item 7, step 5"):
        Mesh(["cpu", "cpu:0"])
    with pytest.raises(NotImplementedError, match="queue A item 7, step 5"):
        Mesh([["cpu", "cpu:0"]] * 2, ("host", "chip"))
    with pytest.raises(ValueError):
        Mesh([])
    mesh = Mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.shape == {"shard": 3}
    assert str(mesh.device) == "cpu"
