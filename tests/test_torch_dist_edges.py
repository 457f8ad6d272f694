"""glt_tpu_torch's distributed seed-edge and subgraph sampling against
glt_tpu's, on the CPU.

JAX runs each shard body under ``shard_map`` on four of the suite's
virtual CPU devices; the port runs the same four shards in turn on 4 x
``"cpu"``.  Same graph, seeds and keys on both sides; every field
compares with ``==``: the sorted edge views, ``dist_edge_exists`` (fused
and not), ``DistNeighborSampler.sample_from_edges`` (no negatives,
binary and triplet, amounts 1 and 2, strict over ``trials`` rounds and
not, a bounded exchange), ``dist_node_subgraph`` and
``DistNeighborSampler.subgraph``.  Then, on the port alone: strict
negatives are non-edges of the CSR, and induced edges are CSR edges.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.parallel import dist_sampler as jsamp
from glt_tpu.parallel import sharding as jshard
from glt_tpu.sampler import NegativeSampling as JaxNeg
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo
from glt_tpu_torch.parallel import (
    DistNeighborSampler,
    Mesh,
    build_sorted_edge_view,
    dist_edge_exists,
    dist_node_subgraph,
    shard_graph,
)
from glt_tpu_torch.sampler import NegativeSampling

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

S, N, B = 4, 400, 10
FANOUTS = [3, 2]
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
def graph():
    ei = _coo()
    topo = CSRTopo(ei, num_nodes=N)
    return (jshard.shard_graph(JaxTopo(ei, num_nodes=N), S),
            shard_graph(topo, S, device="cpu"), topo)


def _jmesh():
    return JaxMesh(np.array(jax.devices()[:S]), ("shard",))


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _is_edge(topo, s, d) -> bool:
    lo, hi = topo.indptr[s], topo.indptr[s + 1]
    return bool((topo.indices[lo:hi] == d).any())


def _edges(topo, rng, n=B):
    """Per-shard seed edges: real edges (sources anywhere), padding."""
    src = np.full((S, n), -1, np.int32)
    dst = np.full((S, n), -1, np.int32)
    rows = np.repeat(np.arange(N), np.diff(topo.indptr))
    for s in range(S):
        pick = rng.choice(rows.size, n - 2, replace=False)
        src[s, : n - 2] = rows[pick]
        dst[s, : n - 2] = topo.indices[pick]
    return src, dst


def _samplers(jg, tg, **kw):
    js = jsamp.DistNeighborSampler(jg, _jmesh(), num_neighbors=FANOUTS,
                                   batch_size=B, seed=4, **kw)
    ts = DistNeighborSampler(tg, Mesh(["cpu"] * S), num_neighbors=FANOUTS,
                             batch_size=B, seed=4, **kw)
    assert ts.route == js.route
    return js, ts


def test_sorted_edge_view_equal(graph):
    jg, tg, _ = graph
    for s in range(S):
        jr, jd = jsamp.build_sorted_edge_view(jg.indptr[s], jg.indices[s])
        tr, td = build_sorted_edge_view(tg.indptr[s], tg.indices[s])
        _eq(jr, tr, f"rows {s}")
        _eq(jd, td, f"dsts {s}")


@pytest.mark.parametrize("fused", [True, False])
def test_dist_edge_exists_equal(graph, fused):
    jg, tg, topo = graph
    rng = np.random.default_rng(1)
    src, dst = _edges(topo, rng, 40)
    src[:, 20:30] = rng.integers(0, N, (S, 10))     # mostly non-edges
    dst[:, 20:30] = rng.integers(0, N, (S, 10))
    src[:, 30] = -1                                  # padding source
    spec = P("shard")

    def body(ip, ix, sr, ds):
        rs, dd = jsamp.build_sorted_edge_view(ip[0], ix[0])
        return jsamp.dist_edge_exists(rs, dd, sr[0], ds[0], tg.nodes_per_shard,
                                      S, "shard", fused=fused)[None]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=_jmesh(), in_specs=(spec,) * 4, out_specs=spec,
        check_vma=False))(jg.indptr, jg.indices, jnp.asarray(src),
                          jnp.asarray(dst)))
    views = [build_sorted_edge_view(ip, ix)
             for ip, ix in zip(tg.indptr, tg.indices)]
    got = dist_edge_exists([v[0] for v in views], [v[1] for v in views],
                           torch.from_numpy(src), torch.from_numpy(dst),
                           tg.nodes_per_shard, S, fused=fused)
    for s in range(S):
        _eq(want[s], got[s], f"shard {s}")
        host = [src[s, i] >= 0 and _is_edge(topo, src[s, i], dst[s, i])
                for i in range(src.shape[1])]
        assert got[s].tolist() == host
    assert all(bool(g[:18].all()) for g in got)


# (mode, amount, strict, sampler knobs)
_EDGE_CASES = [
    (None, 0, False, {}),
    ("binary", 1, False, {}),
    ("binary", 1, True, {}),
    ("binary", 2, True, {"last_hop_dedup": False}),
    ("triplet", 2, False, {}),
    ("triplet", 1, True, {"exchange_load_factor": 2.0}),
]


@pytest.mark.parametrize("case", range(len(_EDGE_CASES)))
def test_sample_from_edges_equal(graph, case):
    mode, amount, strict, kw = _EDGE_CASES[case]
    jg, tg, topo = graph
    js, ts = _samplers(jg, tg, **kw)
    src, dst = _edges(topo, np.random.default_rng(case))
    for call in range(2):
        jneg = None if mode is None else JaxNeg(mode, amount)
        tneg = None if mode is None else NegativeSampling(mode, amount)
        key = 40 + call
        jout = js.sample_from_edges(jnp.asarray(src), jnp.asarray(dst),
                                    neg_sampling=jneg,
                                    key=jax.random.PRNGKey(key),
                                    strict=strict, trials=2)
        tout = ts.sample_from_edges(src, dst, neg_sampling=tneg,
                                    key=trandom.PRNGKey(key, device="cpu"),
                                    strict=strict, trials=2)
        for f in FIELDS:
            _eq(getattr(jout, f), getattr(tout, f), f"call {call} {f}")
        assert set(jout.metadata) == set(tout.metadata)
        for k in jout.metadata:
            _eq(jout.metadata[k], tout.metadata[k], f"call {call} {k}")
    # The default key advances the call counter, as glt_tpu's.
    jout = js.sample_from_edges(jnp.asarray(src), jnp.asarray(dst))
    tout = ts.sample_from_edges(src, dst)
    for f in FIELDS:
        _eq(getattr(jout, f), getattr(tout, f), f"default key {f}")


@pytest.mark.parametrize("mode", ["binary", "triplet"])
def test_strict_negatives_are_non_edges(graph, mode):
    """With enough rounds every strict negative is a non-edge of the
    CSR (padding stays padding)."""
    _, tg, topo = graph
    ts = DistNeighborSampler(tg, Mesh(["cpu"] * S), num_neighbors=FANOUTS,
                             batch_size=B)
    src, dst = _edges(topo, np.random.default_rng(7))
    out = ts.sample_from_edges(src, dst, NegativeSampling(mode, 2),
                               key=trandom.PRNGKey(3, device="cpu"),
                               strict=True, trials=6)
    checked = 0
    for s in range(S):
        node = out.node[s].numpy()
        if mode == "binary":
            eli = out.metadata["edge_label_index"][s].numpy()
            lab = out.metadata["edge_label"][s].numpy()
            pairs = [(node[a], node[b]) for (a, b), l in zip(eli.T, lab)
                     if l == 0 and a >= 0]
        else:
            si = out.metadata["src_index"][s].numpy()
            neg = out.metadata["dst_neg_index"][s].numpy()
            pairs = [(node[si[i]], node[n]) for i in range(B)
                     for n in neg[i] if si[i] >= 0 and n >= 0]
        for a, b in pairs:
            assert not _is_edge(topo, a, b), (s, a, b)
        checked += len(pairs)
    assert checked == S * (B - 2) * 2


@pytest.mark.parametrize("fused", [True, False])
def test_dist_node_subgraph_equal(graph, fused):
    jg, tg, _ = graph
    rng = np.random.default_rng(5)
    nodes = np.full((S, 24), -1, np.int32)
    for s in range(S):
        nodes[s, :20] = rng.choice(N, 20, replace=False)
    nodes[0, :2] = [1, 2]                  # the hub, a degree-1 node
    spec = P("shard")

    def body(ip, ix, ei, nd):
        out = jsamp.dist_node_subgraph(ip[0], ix[0], ei[0], nd[0], 16,
                                       tg.nodes_per_shard, S, "shard",
                                       fused=fused)
        return tuple(o[None] for o in out)

    want = [np.asarray(a) for a in jax.jit(jax.shard_map(
        body, mesh=_jmesh(), in_specs=(spec,) * 4, out_specs=(spec,) * 4,
        check_vma=False))(jg.indptr, jg.indices, jg.edge_ids,
                          jnp.asarray(nodes))]
    got = dist_node_subgraph(tg.indptr, tg.indices, tg.edge_ids,
                             torch.from_numpy(nodes), 16,
                             tg.nodes_per_shard, S, fused=fused)
    for s in range(S):
        for i, name in enumerate(("rows", "cols", "eids", "mask")):
            _eq(want[i][s], got[s][i], f"shard {s} {name}")


@pytest.mark.parametrize("max_degree", [8, 64])
def test_subgraph_equal_and_induced(graph, max_degree):
    jg, tg, topo = graph
    js, ts = _samplers(jg, tg)
    rng = np.random.default_rng(max_degree)
    seeds = rng.integers(0, N, (S, B)).astype(np.int32)
    seeds[:, -2:] = -1
    jout = js.subgraph(jnp.asarray(seeds), max_degree=max_degree,
                       key=jax.random.PRNGKey(2))
    tout = ts.subgraph(seeds, max_degree=max_degree,
                       key=trandom.PRNGKey(2, device="cpu"))
    for f in ("node", "row", "col", "edge", "batch", "node_mask",
              "edge_mask", "num_sampled_nodes"):
        _eq(getattr(jout, f), getattr(tout, f), f)
    assert tout.num_sampled_edges is None
    _eq(jout.metadata["mapping"], tout.metadata["mapping"], "mapping")
    # Induced edges are CSR edges; at max degree 64 every CSR edge among
    # a node set of degree <= 64 is there.
    for s in range(S):
        node = tout.node[s].numpy()
        m = tout.edge_mask[s].numpy()
        r, c = tout.row[s].numpy()[m], tout.col[s].numpy()[m]
        for a, b in zip(node[r], node[c]):
            assert _is_edge(topo, a, b)
        if max_degree == 64:
            live = node[node >= 0]
            inside = set(live.tolist())
            want = sum(int(np.isin(topo.indices[topo.indptr[v]:
                                                topo.indptr[v + 1]],
                                   list(inside)).sum())
                       for v in live if np.diff(topo.indptr)[v] <= 64)
            small = {v for v in live if np.diff(topo.indptr)[v] <= 64}
            got = sum(1 for a in node[r] if a in small)
            assert got == want
