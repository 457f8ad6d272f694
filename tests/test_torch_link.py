"""The port's link and subgraph paths against glt_tpu's on the CPU.

Same graph, features, seeds, labels, weights and keys on both sides.
``==`` for ``sample_one_hop``, ``sample_from_edges`` (binary, triplet
and no negatives; with and without labels and weights: node, row, col,
every metadata key), ``subgraph()``, both loaders' batches over an
epoch (partial last batch included) and ``link_seed_blocks``.  The
scanned link and subgraph steps and each example twin's scanned epoch
compare losses and parameters within 1e-5 relative, with the weights
carried across by ``params_from_flax``: ``index_add_`` and
``segment_sum`` add in different orders, optax and torch place Adam's
bias correction differently, and optax's ``sigmoid_binary_cross_entropy``
and ``F.binary_cross_entropy_with_logits`` round differently.  The JAX
sampler runs its XLA arm (``sample_force="xla"``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples import datasets as jax_datasets
from examples import graph_sage_unsup_ppi as jax_unsup
from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Graph as JaxGraph
from glt_tpu.loader import LinkNeighborLoader as JaxLinkLoader
from glt_tpu.loader import SubGraphLoader as JaxSubGraphLoader
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models import train as jtrain
from glt_tpu.sampler import EdgeSamplerInput as JaxEdgeInput
from glt_tpu.sampler import NegativeSampling as JaxNeg
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler import NodeSamplerInput as JaxNodeInput
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Dataset, Graph
from glt_tpu_torch.examples import datasets as tdatasets
from glt_tpu_torch.examples import graph_sage_unsup_ppi as tunsup
from glt_tpu_torch.examples import seal_link_pred as tseal
from glt_tpu_torch.loader import LinkNeighborLoader, SubGraphLoader
from glt_tpu_torch.models import (
    GraphSAGE,
    adam,
    create_train_state,
    link_seed_blocks,
    make_scanned_link_train_step,
    make_scanned_subgraph_train_step,
    params_from_flax,
)
from glt_tpu_torch.sampler import (
    EdgeSamplerInput,
    NegativeSampling,
    NeighborSampler,
    NodeSamplerInput,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, DIM = 90, 8
FIELDS = ("node", "row", "col", "edge", "batch", "node_mask", "edge_mask",
          "num_sampled_nodes", "num_sampled_edges")
RTOL = 1e-5


def _coo(seed=0):
    """Power-law-ish COO in shuffled order (explicit edge ids after the
    CSR sort), a hub, isolated nodes; features and labels."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, N), 40)
    deg[:3] = [0, 45, 1]
    src = np.repeat(np.arange(N), deg)
    dst = rng.integers(0, N, src.size)
    perm = rng.permutation(src.size)
    feat = rng.normal(size=(N, DIM)).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    return np.stack([src[perm], dst[perm]]), feat, labels


def _graphs(edges="explicit"):
    ei, feat, labels = _coo()
    if edges == "positional":
        ei = ei[:, np.argsort(ei[0], kind="stable")]
    jg = JaxGraph(JaxTopo(ei, num_nodes=N), with_sorted_columns=True)
    tg = Graph(CSRTopo(ei, num_nodes=N), device="cpu")
    assert (tg.gather_edge_ids is None) == (edges == "positional")
    return jg, tg, ei


def _datasets():
    ei, feat, labels = _coo()
    jds = (JaxDataset().init_graph(ei, num_nodes=N, with_sorted_columns=True)
           .init_node_features(feat).init_node_labels(labels))
    tds = (Dataset(device="cpu").init_graph(ei, num_nodes=N)
           .init_node_features(feat).init_node_labels(labels))
    return jds, tds, ei


def _eq(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert tuple(b.shape) == tuple(np.shape(a)), what
    np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=what)


def _compare_out(jout, tout):
    for f in FIELDS:
        _eq(getattr(jout, f), getattr(tout, f), f)
    jm, tm = jout.metadata or {}, tout.metadata or {}
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _eq(jm[k], tm[k], k)


def _weight(seed=3):
    w = np.random.default_rng(seed).random(N).astype(np.float32)
    w[np.arange(N) % 3 == 0] = 0.0
    return w


def _neg(pkg, mode, weighted, amount=2):
    if mode is None:
        return None
    cls = JaxNeg if pkg == "jax" else NegativeSampling
    return cls(mode, amount, weight=_weight() if weighted else None)


@pytest.mark.parametrize("edges", ["positional", "explicit"])
def test_sample_one_hop_matches_jax(edges):
    jg, tg, _ = _graphs(edges)
    js = JaxSampler(jg, [4], batch_size=8, sample_force="xla")
    ts = NeighborSampler(tg, [4], batch_size=8)
    srcs = np.array([1, 0, 5, -1, 89, 17, 1], np.int32)
    for fanout in (3, 7):
        want = js.sample_one_hop(jnp.asarray(srcs), fanout)
        got = ts.sample_one_hop(srcs, fanout)
        for name in ("nbrs", "eids", "mask"):
            _eq(getattr(want, name), getattr(got, name), name)
    key = 7
    want = js.sample_one_hop(jnp.asarray(srcs), 5, key=jax.random.PRNGKey(key))
    got = ts.sample_one_hop(torch.from_numpy(srcs), 5,
                            key=trandom.PRNGKey(key, device="cpu"))
    _eq(want.nbrs, got.nbrs, "nbrs with a key")


# (mode, labels, weighted, amount, edge ids)
_EDGE_CASES = [
    ("binary", False, False, 1, "explicit"),
    ("binary", True, False, 2, "explicit"),
    ("binary", False, True, 2, "explicit"),
    ("binary", True, True, 1, "explicit"),
    ("binary", True, True, 1, "positional"),
    ("triplet", False, False, 2, "explicit"),
    ("triplet", False, False, 2, "positional"),
    ("triplet", True, True, 3, "explicit"),
    (None, False, False, 0, "explicit"),
    (None, True, False, 0, "explicit"),
    (None, True, False, 0, "positional"),
]


@pytest.mark.parametrize("mode,labels,weighted,amount,edges", _EDGE_CASES)
def test_sample_from_edges_matches_jax(mode, labels, weighted, amount,
                                       edges):
    jg, tg, ei = _graphs(edges)
    q = 8
    kw = dict(batch_size=q, seed=4)
    js = JaxSampler(jg, [3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tg, [3, 2], **kw)
    rng = np.random.default_rng(11)
    jneg, tneg = (_neg("jax", mode, weighted, amount),
                  _neg("torch", mode, weighted, amount))
    # A full batch, then a partial one (padded positives), then one that
    # holds the hub and an isolated node; the sampler's key counter
    # advances across the calls on both sides.
    for num in (q, 5, 3):
        pos = rng.integers(0, ei.shape[1], num)
        row, col = ei[0, pos], ei[1, pos]
        if num == 3:
            row, col = np.array([1, 0, 1]), np.array([0, 1, 2])
        lab = rng.integers(0, 3, num).astype(np.int32) if labels else None
        want = js.sample_from_edges(JaxEdgeInput(row, col, lab,
                                                 neg_sampling=jneg))
        got = ts.sample_from_edges(EdgeSamplerInput(row, col, lab,
                                                    neg_sampling=tneg))
        _compare_out(want, got)
        assert int(got.metadata["num_pos"]) == num
    if mode == "binary":
        lab_out = got.metadata["edge_label"].numpy()
        assert (lab_out[3:q] == -1).all() and (lab_out[q:] == 0).all()


def test_sample_from_edges_last_hop_leaf_block_and_sort_dedup():
    jg, tg, ei = _graphs()
    kw = dict(batch_size=6, seed=2, last_hop_dedup=False, dedup="sort")
    js = JaxSampler(jg, [3, 3], sample_force="xla", **kw)
    ts = NeighborSampler(tg, [3, 3], **kw)
    row, col = ei[0, 10:16], ei[1, 10:16]
    for mode in ("binary", "triplet"):
        want = js.sample_from_edges(JaxEdgeInput(
            row, col, neg_sampling=JaxNeg(mode, 1)))
        got = ts.sample_from_edges(EdgeSamplerInput(
            row, col, neg_sampling=NegativeSampling(mode, 1)))
        _compare_out(want, got)


def test_hetero_link_input_raises():
    """The homogeneous sampler ignores ``input_type``, as glt_tpu's does
    (it raised while hetero graphs were not ported)."""
    jg, tg, ei = _graphs()
    js = JaxSampler(jg, [2], batch_size=4, sample_force="xla")
    ts = NeighborSampler(tg, [2], batch_size=4)
    et = ("u", "to", "v")
    inp = EdgeSamplerInput(ei[0, :4], ei[1, :4], input_type=et)
    want = js.sample_from_edges(JaxEdgeInput(ei[0, :4], ei[1, :4],
                                             input_type=et))
    got = ts.sample_from_edges(inp)
    _compare_out(want, got)
    assert len(inp) == 4 and len(inp[1:3]) == 2


@pytest.mark.parametrize("edges,max_degree", [("explicit", 4),
                                              ("positional", 64)])
def test_subgraph_matches_jax(edges, max_degree):
    jg, tg, _ = _graphs(edges)
    kw = dict(batch_size=6, seed=9, with_edge=edges == "explicit")
    js = JaxSampler(jg, [3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tg, [3, 2], **kw)
    for seeds in ([1, 0, 4, 4, 60], [7, 2, 89, 1, 33, 5]):
        want = js.subgraph(JaxNodeInput(np.array(seeds)),
                           max_degree=max_degree)
        got = ts.subgraph(NodeSamplerInput(np.array(seeds)),
                          max_degree=max_degree)
        _compare_out(want, got)
    with pytest.raises(ValueError, match="last_hop_dedup"):
        NeighborSampler(tg, [2], batch_size=4,
                        last_hop_dedup=False).subgraph(
            NodeSamplerInput(np.array([1])))


def _compare_batches(jb, tb):
    assert jb.batch_size == tb.batch_size
    for f in ("x", "y", "edge_index", "edge_id", "node", "node_mask",
              "edge_mask", "batch"):
        _eq(getattr(jb, f), getattr(tb, f), f)
    assert sorted(tb.metadata) == sorted(jb.metadata)
    for k in jb.metadata:
        _eq(jb.metadata[k], tb.metadata[k], k)


@pytest.mark.parametrize("mode,labels,weighted", [
    ("binary", True, False), ("triplet", False, True), (None, True, False)])
def test_link_loader_epochs_match_jax(mode, labels, weighted):
    """Two shuffled epochs of 23 seed edges in batches of 5 (a partial
    last batch each epoch)."""
    jds, tds, ei = _datasets()
    sel = np.random.default_rng(2).integers(0, ei.shape[1], 23)
    eli = ei[:, sel]
    lab = (np.arange(23) % 3).astype(np.int32) if labels else None
    kw = dict(batch_size=5, shuffle=True, seed=6, frontier_cap=12)
    jl = JaxLinkLoader(jds, [3, 2], eli, edge_label=lab,
                       neg_sampling=_neg("jax", mode, weighted), **kw)
    jl.sampler.sample_force = "xla"
    tl = LinkNeighborLoader(tds, [3, 2], eli, edge_label=lab,
                            neg_sampling=_neg("torch", mode, weighted), **kw)
    assert len(tl) == len(jl) == 5
    for _ in range(2):
        jbs, tbs = list(jl), list(tl)
        assert len(tbs) == len(jbs) == 5
        for jb, tb in zip(jbs, tbs):
            _compare_batches(jb, tb)
        assert tbs[-1].batch_size == 3


def test_subgraph_loader_epoch_matches_jax():
    jds, tds, _ = _datasets()
    seeds = np.random.default_rng(1).integers(0, N, 14)
    kw = dict(batch_size=4, max_degree=8, shuffle=True, seed=3)
    jl = JaxSubGraphLoader(jds, [3, 2], seeds, **kw)
    jl.sampler.sample_force = "xla"
    tl = SubGraphLoader(tds, [3, 2], seeds, **kw)
    jbs, tbs = list(jl), list(tl)
    assert len(tbs) == len(jbs) == 4 and tbs[-1].batch_size == 2
    for jb, tb in zip(jbs, tbs):
        _compare_batches(jb, tb)


def test_link_seed_blocks_match_jax():
    ei = np.random.default_rng(0).integers(0, 50, (2, 37))
    want = list(jtrain.link_seed_blocks(ei, 4, 3, np.random.default_rng(5)))
    got = list(link_seed_blocks(ei, 4, 3, np.random.default_rng(5)))
    assert len(got) == len(want) == 4
    for (ws, wd, wn), (gs, gd, gn) in zip(want, got):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gd, wd)
        assert gn == wn
    assert got[-1][2] == 1 and (got[-1][0][1:] == -1).all()


# -- the scanned steps ---------------------------------------------------
def _models(in_dim, hidden, out, layers=2):
    jm = JaxSAGE(hidden_features=hidden, out_features=out,
                 num_layers=layers, dropout_rate=0.0)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((4, in_dim), jnp.float32),
                     jnp.full((2, 4), -1, jnp.int32), jnp.zeros((4,), bool))
    tm = GraphSAGE(in_dim, hidden, out, num_layers=layers, dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(params))
    return jm, params, tm


def _assert_params(jparams, model):
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=RTOL, err_msg=k)


def _triplet_loss_jax(z, meta):
    si, dp, dn = (meta["src_index"], meta["dst_pos_index"],
                  meta["dst_neg_index"])
    last = z.shape[0] - 1
    zs = z[jnp.clip(si, 0, last)]
    pos = (zs * z[jnp.clip(dp, 0, last)]).sum(-1)
    neg = (zs[:, None] * z[jnp.clip(dn, 0, last)]).sum(-1)
    valid = (si >= 0)[:, None] & (dp >= 0)[:, None] & (dn >= 0)
    ce = jax.nn.softplus(neg - pos[:, None])
    return jnp.where(valid, ce, 0).sum() / jnp.maximum(valid.sum(), 1)


def _triplet_loss_torch(z, meta):
    si, dp, dn = (meta["src_index"].long(), meta["dst_pos_index"].long(),
                  meta["dst_neg_index"].long())
    last = z.shape[0] - 1
    zs = z[si.clamp(0, last)]
    pos = (zs * z[dp.clamp(0, last)]).sum(-1)
    neg = (zs[:, None] * z[dn.clamp(0, last)]).sum(-1)
    valid = (si >= 0)[:, None] & (dp >= 0)[:, None] & (dn >= 0)
    ce = torch.nn.functional.softplus(neg - pos[:, None])
    return torch.where(valid, ce, 0).sum() / valid.sum().clamp(min=1)


@pytest.mark.parametrize("mode,weighted", [("binary", False),
                                           ("binary", True),
                                           ("triplet", False)])
def test_scanned_link_step_matches_jax(mode, weighted):
    """A block of 3 batches whose last batch is fully padded: in binary
    mode it still trains on its negatives, and Adam steps in every mode
    (no no-op, unlike the node step).  Then a second, full block."""
    jds, tds, ei = _datasets()
    q, lr = 6, 1e-2
    kw = dict(batch_size=q, frontier_cap=10, with_edge=False)
    js = JaxSampler(jds.get_graph(), [3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tds.get_graph(), [3, 2], **kw)
    jm, params, tm = _models(DIM, 16, 8)
    tx = optax.adam(lr)
    jloss, tloss = ((jax_unsup.unsup_dot_loss, tunsup.unsup_dot_loss)
                    if mode == "binary"
                    else (_triplet_loss_jax, _triplet_loss_torch))
    jstep = jtrain.make_scanned_link_train_step(
        jm, tx, js, jds.get_node_feature(), jloss,
        _neg("jax", mode, weighted, 1), group=3)
    tstep = make_scanned_link_train_step(
        ts, tds.get_node_feature(), tloss, _neg("torch", mode, weighted, 1))
    state = create_train_state(tm, adam(lr))
    opt_state = tx.init(params)
    rng = np.random.default_rng(4)
    src = np.full((3, q), -1, np.int64)
    dst = np.full((3, q), -1, np.int64)
    pos = rng.integers(0, ei.shape[1], 9)
    src.reshape(-1)[:9], dst.reshape(-1)[:9] = ei[0, pos], ei[1, pos]
    blocks = [(src, dst)] + [
        (b[0], b[1]) for b in link_seed_blocks(ei[:, :18], q, 3, rng)]
    for i, (sb, db) in enumerate(blocks):
        params, opt_state, jl = jstep(params, opt_state, sb, db,
                                      jax.random.PRNGKey(20 + i))
        state, tl = tstep(state, sb, db, trandom.PRNGKey(20 + i,
                                                         device="cpu"))
        assert tl.shape == (3,)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=RTOL)
        _assert_params(params, tm)
        if i == 0 and mode == "binary":
            assert float(tl[2]) > 0.0     # the padded batch's negatives
    assert state.step == 6


def _seal_loss_jax(z, out, y):
    si = out.metadata["seed_index"].reshape(y.shape[0], 2)
    zs = z[jnp.clip(si, 0, z.shape[0] - 1)]
    logit = (zs[:, 0] * zs[:, 1]).sum(-1)
    valid = (y >= 0) & (si >= 0).all(axis=1)
    ce = optax.sigmoid_binary_cross_entropy(
        logit, jnp.clip(y, 0, 1).astype(jnp.float32))
    return jnp.where(valid, ce, 0).sum() / jnp.maximum(valid.sum(), 1)


def test_scanned_subgraph_step_matches_jax():
    """A block of 3 seed-pair batches, the last fully padded (Adam still
    steps), then a full block."""
    jds, tds, ei = _datasets()
    b, lr = 4, 1e-2
    kw = dict(batch_size=2 * b, with_edge=True)
    js = JaxSampler(jds.get_graph(), [3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tds.get_graph(), [3, 2], **kw)
    jm, params, tm = _models(DIM, 16, 8)
    tx = optax.adam(lr)
    jstep = jtrain.make_scanned_subgraph_train_step(
        jm, tx, js, jds.get_node_feature(), _seal_loss_jax, max_degree=6)
    tstep = make_scanned_subgraph_train_step(ts, tds.get_node_feature(),
                                             tseal.pair_loss, max_degree=6)
    state = create_train_state(tm, adam(lr))
    opt_state = tx.init(params)
    rng = np.random.default_rng(8)
    for i, real in enumerate((2, 3)):
        sb = np.full((3, 2 * b), -1, np.int64)
        yb = np.full((3, b), -1, np.int64)
        sb[:real] = rng.integers(0, N, (real, 2 * b))
        yb[:real] = rng.integers(0, 2, (real, b))
        params, opt_state, jl = jstep(params, opt_state, sb, yb,
                                      jax.random.PRNGKey(i))
        state, tl = tstep(state, sb, yb, trandom.PRNGKey(i, device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=RTOL)
        _assert_params(params, tm)
    assert state.step == 6


# -- the example twins ---------------------------------------------------
def test_synthetic_ppi_matches_jax():
    jds, jei = jax_datasets.synthetic_ppi(scale=0.0, dim=6, seed=3)
    tds, tei = tdatasets.synthetic_ppi(scale=0.0, dim=6, seed=3,
                                       device="cpu")
    np.testing.assert_array_equal(tei, jei)
    jg, tg = jds.get_graph(), tds.get_graph()
    for f in ("indptr", "indices", "sorted_indices"):
        _eq(getattr(jg, f), getattr(tg, f), f)
    np.testing.assert_array_equal(tds.get_node_feature().hot_rows.numpy(),
                                  np.asarray(jds.get_node_feature().hot_rows))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdatasets.synthetic_ppi(scale=0.0)      # the card by default


def test_unsup_twin_scanned_epochs_match_jax():
    """The JAX example's scanned path (its ``--group > 0`` branch) and
    the twin's ``train_scanned``, two epochs over 24 edges at batch 8,
    G = 2, fanout (3, 2): the second block of each epoch ends in a fully
    padded batch."""
    args = tunsup.parse_args(["--device", "cpu", "--epochs", "2",
                              "--batch-size", "8", "--group", "2",
                              "--fanout", "3", "2"])
    jds, jei = jax_datasets.synthetic_ppi(scale=0.0, dim=DIM)
    tds, tei = tdatasets.synthetic_ppi(scale=0.0, dim=DIM, device="cpu")
    jei, tei = jei[:, :24], tei[:, :24]
    jm, params, tm = _models(DIM, 64, 64)
    tx = optax.adam(1e-3)
    sampler = JaxSampler(jds.get_graph(), args.fanout,
                         batch_size=args.batch_size, frontier_cap=4096,
                         with_edge=False, sample_force="xla")
    step = jtrain.make_scanned_link_train_step(
        jm, tx, sampler, jds.get_node_feature(), jax_unsup.unsup_dot_loss,
        JaxNeg("binary", 1), group=args.group)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    want = []
    for epoch in range(args.epochs):
        losses, nbs, batches = [], [], 0
        for sb, db, nb in jtrain.link_seed_blocks(jei, args.batch_size,
                                                  args.group, rng):
            params, opt_state, ls = step(
                params, opt_state, sb, db,
                jax.random.fold_in(jax.random.PRNGKey(epoch), batches))
            losses.append(ls)
            nbs.append(nb)
            batches += nb
        flat = np.asarray(jnp.concatenate(losses))
        want.append(flat[np.concatenate([np.arange(nb) + i * args.group
                                         for i, nb in enumerate(nbs)])])
    state, got = tunsup.train_scanned(args, tds, tei, model=tm)
    assert [g.shape for g in got] == [(3,), (3,)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)
    _assert_params(params, state.model)


def test_seal_twin_scanned_epoch_matches_jax():
    """The JAX example's ``run_scanned`` loop and the twin's, one epoch
    over 20 candidate links at batch 4, G = 2 (the last block holds one
    real batch and one fully padded)."""
    args = tseal.parse_args(["--device", "cpu", "--epochs", "1",
                             "--batch-size", "4", "--group", "2"])
    jds, jei = jax_datasets.synthetic_ppi(scale=0.0, dim=DIM)
    tds, tei = tdatasets.synthetic_ppi(scale=0.0, dim=DIM, device="cpu")
    n = tds.get_graph().num_nodes
    links, labels = tseal.candidate_links(tei, n, 10,
                                          np.random.default_rng(0))
    bs, G = args.batch_size, args.group
    jm, params, tm = _models(DIM, 32, 32)
    tx = optax.adam(1e-3)
    sampler = JaxSampler(jds.get_graph(), [8, 8], batch_size=bs * 2,
                         with_edge=True, sample_force="xla")
    step = jtrain.make_scanned_subgraph_train_step(
        jm, tx, sampler, jds.get_node_feature(), _seal_loss_jax,
        max_degree=16)
    opt_state = tx.init(params)
    rng = np.random.default_rng(1)
    order = rng.permutation(labels.shape[0])
    losses, nbs = [], []
    for lo in range(0, labels.shape[0], bs * G):
        sel = order[lo: lo + bs * G]
        sb = np.full((G, bs * 2), -1, np.int64)
        yb = np.full((G, bs), -1, np.int64)
        sb.reshape(-1)[: sel.shape[0] * 2] = links.T[sel].reshape(-1)
        yb.reshape(-1)[: sel.shape[0]] = labels[sel]
        params, opt_state, ls = step(
            params, opt_state, sb, yb,
            jax.random.fold_in(jax.random.PRNGKey(0), lo))
        losses.append(ls)
        nbs.append(-(-sel.shape[0] // bs))
    flat = np.asarray(jnp.concatenate(losses))
    want = flat[np.concatenate([np.arange(b) + i * G
                                for i, b in enumerate(nbs)])]
    state, got = tseal.run_scanned(args, tds, links, labels,
                                   np.random.default_rng(1), model=tm)
    assert got[0].shape == (5,)
    np.testing.assert_allclose(got[0], want, rtol=RTOL, atol=RTOL)
    _assert_params(params, state.model)
