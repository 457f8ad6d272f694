"""The port's heterogeneous data path against glt_tpu's on the CPU.

Same graphs (each package's own synthetic datasets, whose arrays must
be equal), seeds, labels, weights and keys on both sides; ``==`` for
``hetero_hop_widths``, the type helpers, the hetero ``Dataset``,
``HeteroNeighborSampler.sample_from_nodes`` (fanout list and dict,
``frontier_cap`` on and off, both ``last_hop_dedup`` modes, the dense
and the sort inducer) and consecutive ``_next_key`` calls,
``sample_from_edges`` (binary, triplet and no negatives, weighted,
same-type and cross-type seed edges, metadata included), both hetero
loaders' batches over shuffled epochs, and hetero messages both ways.
The JAX sampler runs its XLA arm (``GLT_SAMPLE_FORCE=xla``), as
``glt_tpu``'s own tests run it on the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from examples import datasets as jax_datasets
from glt_tpu import typing as jtyping
from glt_tpu.distributed import sample_message as jmsg
from glt_tpu.loader.hetero_link_loader import (
    HeteroLinkNeighborLoader as JaxLinkLoader,
)
from glt_tpu.loader.hetero_neighbor_loader import (
    HeteroNeighborLoader as JaxLoader,
)
from glt_tpu.sampler import EdgeSamplerInput as JaxEdgeInput
from glt_tpu.sampler import NegativeSampling as JaxNeg
from glt_tpu.sampler import NodeSamplerInput as JaxNodeInput
from glt_tpu.sampler import hetero_neighbor_sampler as jhns
from glt_tpu_torch import random as trandom
from glt_tpu_torch import typing as ttyping
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.distributed import (
    hetero_batch_to_message,
    message_to_batch,
    message_to_hetero_batch,
)
from glt_tpu_torch.examples import datasets as tdatasets
from glt_tpu_torch.loader import (
    HeteroBatch,
    HeteroLinkNeighborLoader,
    HeteroNeighborLoader,
)
from glt_tpu_torch.sampler import (
    EdgeSamplerInput,
    HeteroNeighborSampler,
    NegativeSampling,
    NodeSamplerInput,
    hetero_hop_widths,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

SCALE = 0.01          # the datasets' floors: 200 papers, 150 authors, ...
FIELDS = ("node", "row", "col", "edge", "batch", "node_mask", "edge_mask",
          "num_sampled_nodes")
CITES = ("paper", "cites", "paper")
WRITES = ("author", "writes", "paper")


@pytest.fixture(scope="module", autouse=True)
def _xla_sampler():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLT_SAMPLE_FORCE", "xla")
        yield


@pytest.fixture(scope="module")
def igbh():
    jds, jidx, jc = jax_datasets.synthetic_igbh(scale=SCALE)
    tds, tidx, tc = tdatasets.synthetic_igbh(scale=SCALE, device="cpu")
    assert jc == tc
    np.testing.assert_array_equal(jidx, tidx)
    return jds, tds


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert tuple(b.shape) == tuple(np.shape(a)), what
    np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=what)


def _eq_dict(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert sorted(a) == sorted(b), what
    for k in a:
        _eq(a[k], b[k], f"{what}[{k}]")


def _compare_out(jout, tout):
    for f in FIELDS:
        _eq_dict(getattr(jout, f), getattr(tout, f), f)
    assert tout.input_type == jout.input_type
    jm, tm = jout.metadata or {}, tout.metadata or {}
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _eq(jm[k], tm[k], k)


def _compare_batches(jb, tb):
    assert jb.batch_size == tb.batch_size
    assert jb.input_type == tb.input_type
    for f in ("x", "y", "edge_index", "edge_id", "node", "node_mask",
              "edge_mask", "batch"):
        _eq_dict(getattr(jb, f), getattr(tb, f), f)
    assert sorted(jb.metadata or {}) == sorted(tb.metadata or {})
    for k in jb.metadata or {}:
        _eq(jb.metadata[k], tb.metadata[k], k)


def test_type_helpers_match_jax():
    for et in (CITES, WRITES, ("paper", "rev_writes", "author"), ("a", "r", "b")):
        assert ttyping.reverse_edge_type(et) == jtyping.reverse_edge_type(et)
        assert ttyping.as_str(et) == jtyping.as_str(et)
        assert ttyping.edge_type_from_str(ttyping.as_str(et)) == et
    assert ttyping.as_str("paper") == "paper"
    for bad in (("a", "b"), 3):
        with pytest.raises(ValueError):
            ttyping.as_str(bad)
    with pytest.raises(ValueError):
        ttyping.edge_type_from_str("a__b")


@pytest.mark.parametrize("fanouts,seed_widths,cap", [
    ([3, 2], {"paper": 8}, None),
    ([5, 5], {"paper": 64}, 100),
    ("dict", {"author": 4, "paper": 6}, None),
    ([2, 0, 3], {"institute": 5}, 7),
])
def test_hetero_hop_widths_match_jax(igbh, fanouts, seed_widths, cap):
    jds, tds = igbh
    ets = tds.get_edge_types()
    if fanouts == "dict":
        nn = {et: [i + 1, 2] for i, et in enumerate(ets)}
    else:
        nn = {et: list(fanouts) for et in ets}
    hops = max(len(v) for v in nn.values())
    assert (hetero_hop_widths(ets, nn, seed_widths, hops, cap)
            == jhns.hetero_hop_widths(ets, nn, seed_widths, hops, cap))


@pytest.mark.parametrize("name", ["synthetic_mag", "synthetic_igbh"])
def test_synthetic_datasets_match_jax(name):
    jds, jidx, jc = getattr(jax_datasets, name)(scale=0.02, seed=3)
    tds, tidx, tc = getattr(tdatasets, name)(scale=0.02, seed=3,
                                             device="cpu")
    assert jc == tc
    np.testing.assert_array_equal(jidx, tidx)
    assert tds.is_hetero and jds.is_hetero
    assert tds.get_node_types() == jds.get_node_types()
    assert tds.get_edge_types() == jds.get_edge_types()
    for et in jds.get_edge_types():
        jt, tt = jds.get_graph(et).topo, tds.get_graph(et).topo
        for name in ("indptr", "indices", "edge_ids"):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(jt, name), err_msg=name)
        assert tds.get_graph(et).num_nodes == jds.get_graph(et).num_nodes
    for t in jds.get_node_types():
        jf, tf = jds.get_node_feature(t), tds.get_node_feature(t)
        assert tuple(tf.shape) == tuple(jf.shape)
        np.testing.assert_array_equal(tf.hot_rows.numpy(),
                                      np.asarray(jf.hot_rows))
        jl, tl = jds.get_node_label(t), tds.get_node_label(t)
        assert (jl is None) == (tl is None)
        if jl is not None:
            np.testing.assert_array_equal(tl, jl)


def test_hetero_dataset_matches_jax():
    """dict inputs to every init method (the port raised on them)."""
    from glt_tpu.data import Dataset as JaxDataset

    rng = np.random.default_rng(0)
    ei = {("u", "buys", "i"): np.stack([rng.integers(0, 6, 20),
                                        rng.integers(0, 9, 20)]),
          ("i", "sim", "i"): np.stack([rng.integers(0, 9, 15),
                                       rng.integers(0, 9, 15)])}
    n = {"u": 6, "i": 9}
    feats = {"u": rng.normal(size=(6, 3)).astype(np.float32),
             "i": rng.normal(size=(9, 5)).astype(np.float32)}
    efeats = {et: rng.normal(size=(e.shape[1], 2)).astype(np.float32)
              for et, e in ei.items()}
    labels = {"i": rng.integers(0, 3, 9)}
    jds = (JaxDataset().init_graph(ei, num_nodes=n).init_node_features(feats)
           .init_edge_features(efeats).init_node_labels(labels))
    tds = (Dataset(device="cpu").init_graph(ei, num_nodes=n)
           .init_node_features(feats).init_edge_features(efeats)
           .init_node_labels(labels))
    assert tds.is_hetero
    assert tds.get_node_types() == jds.get_node_types() == ["i", "u"]
    assert tds.get_edge_types() == jds.get_edge_types()
    for et in ei:
        np.testing.assert_array_equal(tds.get_graph(et).indptr.numpy(),
                                      np.asarray(jds.get_graph(et).indptr))
        assert tds.get_graph(et).num_nodes == jds.get_graph(et).num_nodes
        np.testing.assert_array_equal(
            tds.get_edge_feature(et).hot_rows.numpy(),
            np.asarray(jds.get_edge_feature(et).hot_rows))
    for t in n:
        np.testing.assert_array_equal(
            tds.get_node_feature(t).gather(np.array([2, -1, 0])).numpy(),
            np.asarray(jds.get_node_feature(t).gather(np.array([2, -1, 0]))))
    np.testing.assert_array_equal(tds.get_node_label("i"),
                                  jds.get_node_label("i"))
    assert tds.get_node_label("u") is None and tds.get_graph(CITES) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdatasets.synthetic_mag(scale=SCALE)


# (fanouts, frontier_cap, last_hop_dedup, inducer)
_NODE_CASES = [
    ("list", None, True, "dense"),
    ("dict", 12, True, "dense"),
    ("list", None, False, "dense"),
    ("dict", 12, False, "sort"),
]


@pytest.mark.parametrize("fanouts,cap,dedup,inducer", _NODE_CASES)
def test_sample_from_nodes_matches_jax(igbh, fanouts, cap, dedup, inducer):
    jds, tds = igbh
    ets = tds.get_edge_types()
    nn = ([3, 2] if fanouts == "list"
          else {et: [2 + i % 2, 1 + i % 3] for i, et in enumerate(ets)})
    kw = dict(batch_size=8, frontier_cap=cap, seed=5, last_hop_dedup=dedup)
    js = jhns.HeteroNeighborSampler(jds.graph, nn, "paper", **kw)
    ts = HeteroNeighborSampler(tds.graph, nn, "paper", **kw)
    assert ts.node_capacity == js.node_capacity
    assert ts.hop_widths == js.hop_widths
    assert ts._num_nodes_by_type == js._num_nodes_by_type
    if inducer == "sort":
        # Before the first trace: every type takes the sort inducer.
        js._num_nodes_by_type = {}
        ts._num_nodes_by_type = {}
    # Under the call counter (a full batch; one with duplicates, padding
    # and the last paper), then an explicit key.
    for seeds in (np.arange(8) * 3, np.array([5, 5, 0, 199, 5, -1])):
        _compare_out(js.sample_from_nodes(JaxNodeInput(seeds)),
                     ts.sample_from_nodes(NodeSamplerInput(seeds)))
    seeds = np.array([1, 2, 3])
    _compare_out(
        js.sample_from_nodes(JaxNodeInput(seeds), key=jax.random.PRNGKey(17)),
        ts.sample_from_nodes(NodeSamplerInput(seeds),
                             key=trandom.PRNGKey(17, device="cpu")))


def test_next_key_matches_jax(igbh):
    jds, tds = igbh
    js = jhns.HeteroNeighborSampler(jds.graph, [2], "paper", seed=9)
    ts = HeteroNeighborSampler(tds.graph, [2], "paper", seed=9)
    for _ in range(3):
        np.testing.assert_array_equal(
            ts._next_key().numpy(),
            np.asarray(js._next_key()).astype(np.int64))


def _weight(n, seed=3):
    w = np.random.default_rng(seed).random(n).astype(np.float32)
    w[np.arange(n) % 4 == 0] = 0.0
    return w


# (seed edge type, mode, amount, weighted, labels)
_EDGE_CASES = [
    (WRITES, "binary", 2, True, True),
    (CITES, "triplet", 2, True, False),
    (CITES, None, 0, False, True),
]


@pytest.mark.parametrize("et,mode,amount,weighted,labels", _EDGE_CASES)
def test_sample_from_edges_matches_jax(igbh, et, mode, amount, weighted,
                                       labels):
    jds, tds = igbh
    kw = dict(batch_size=6, seed=4)
    js = jhns.HeteroNeighborSampler(jds.graph, [2, 2], et[0], **kw)
    ts = HeteroNeighborSampler(tds.graph, [2, 2], et[0], **kw)
    w = _weight(tds.get_graph(CITES).num_nodes) if weighted else None
    jneg = None if mode is None else JaxNeg(mode, amount, weight=w)
    tneg = None if mode is None else NegativeSampling(mode, amount, weight=w)
    edges = np.stack(jds.get_graph(et).topo.to_coo())
    rng = np.random.default_rng(11)
    for num in (6, 4):                  # a full batch, then a partial one
        pos = rng.integers(0, edges.shape[1], num)
        lab = rng.integers(0, 3, num).astype(np.int32) if labels else None
        want = js.sample_from_edges(JaxEdgeInput(
            edges[0, pos], edges[1, pos], lab, input_type=et,
            neg_sampling=jneg))
        got = ts.sample_from_edges(EdgeSamplerInput(
            edges[0, pos], edges[1, pos], lab, input_type=et,
            neg_sampling=tneg))
        _compare_out(want, got)
    with pytest.raises(ValueError, match="input_type"):
        ts.sample_from_edges(EdgeSamplerInput(edges[0, :2], edges[1, :2]))


@pytest.fixture(scope="module")
def loader_epochs(igbh):
    """Two shuffled epochs of 21 paper seeds in batches of 8 (a partial
    last batch), prefetch 2, through both packages' loaders."""
    jds, tds = igbh
    seeds = np.random.default_rng(2).permutation(200)[:21]
    kw = dict(batch_size=8, shuffle=True, seed=6, prefetch=2,
              frontier_cap=16)
    jl = JaxLoader(jds, [3, 2], ("paper", seeds), **kw)
    tl = HeteroNeighborLoader(tds, [3, 2], ("paper", seeds), **kw)
    assert len(tl) == len(jl) == 3
    return [(list(jl), list(tl)) for _ in range(2)]


def test_hetero_loader_epochs_match_jax(igbh, loader_epochs):
    """x of every type with features, y, edges, masks: equal."""
    for jbs, tbs in loader_epochs:
        assert len(jbs) == len(tbs) == 3
        for jb, tb in zip(jbs, tbs):
            assert isinstance(tb, HeteroBatch)
            _compare_batches(jb, tb)
    with pytest.raises(ValueError, match="node_type"):
        HeteroNeighborLoader(igbh[1], [2], np.arange(3))


def test_hetero_link_loader_matches_jax(igbh):
    jds, tds = igbh
    edges = np.stack(jds.get_graph(WRITES).topo.to_coo())
    eli = edges[:, np.random.default_rng(3).integers(0, edges.shape[1], 13)]
    lab = (np.arange(13) % 2).astype(np.int32)
    kw = dict(batch_size=5, shuffle=True, seed=2)
    jl = JaxLinkLoader(jds, [2], (WRITES, eli), edge_label=lab,
                       neg_sampling=JaxNeg("binary", 1), **kw)
    tl = HeteroLinkNeighborLoader(tds, [2], (WRITES, eli), edge_label=lab,
                                  neg_sampling=NegativeSampling("binary", 1),
                                  **kw)
    jbs, tbs = list(jl), list(tl)
    assert len(jbs) == len(tbs) == 3
    for jb, tb in zip(jbs, tbs):
        _compare_batches(jb, tb)
        # positives decode to their seed edges
        eli_b = tb.metadata["edge_label_index"].numpy()
        src = tb.node["author"].numpy()[eli_b[0, :tb.batch_size]]
        dst = tb.node["paper"].numpy()[eli_b[1, :tb.batch_size]]
        pairs = set(zip(eli[0].tolist(), eli[1].tolist()))
        assert set(zip(src.tolist(), dst.tolist())) <= pairs


def test_hetero_messages_match_jax(loader_epochs):
    """A loader batch (the partial one) flattened by both packages gives
    the same message; each package's ``message_to_batch`` rebuilds a
    hetero batch from it (the port raised on hetero messages); bf16 x
    survives the trip."""
    jb, tb = loader_epochs[0][0][-1], loader_epochs[0][1][-1]
    jm, tm = jmsg.hetero_batch_to_message(jb), hetero_batch_to_message(tb)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_array_equal(tm[k], np.asarray(jm[k]), err_msg=k)
    back = message_to_batch(tm, device="cpu")
    assert isinstance(back, HeteroBatch)
    _compare_batches(jmsg.message_to_batch(jm), back)
    bf = HeteroBatch(**{**tb.__dict__, "x": {
        t: v.to(torch.bfloat16) for t, v in tb.x.items()}})
    back = message_to_hetero_batch(hetero_batch_to_message(bf), device="cpu")
    for t, v in bf.x.items():
        assert back.x[t].dtype == torch.bfloat16
        assert torch.equal(back.x[t], v)
