"""Per-layer trimming of a sampled block to the hops the seeds' loss
reads (``hop_prefixes``, ``layer_spans``, ``GraphSAGE``/``GAT``'s
``bounds=``, the scanned node step).

Blocks come from the port's ``NeighborSampler`` in each of its layouts:
the dense and sort inducers, an occupancy cap (overflowing batches
included), the leaf block (``last_hop_dedup=False``) and a frontier cap;
each mode samples a full batch, a ragged one and one with duplicate
seeds.  The trimmed forward's seed rows, and the gradients of a loss
over them, are held to the whole block's (with dropout under one key:
the masks are prefix-stable) and, dropout off, to ``glt_tpu``'s
GraphSAGE.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu_torch import obs
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.models import (
    GAT,
    GraphSAGE,
    adam,
    create_train_state,
    make_scanned_node_train_step,
    node_seed_blocks,
    scatter_mean,
)
from glt_tpu_torch.models.conv import layer_spans
from glt_tpu_torch.sampler import (
    NeighborSampler,
    NodeSamplerInput,
    hop_prefixes,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, DEG, DIM, HIDDEN, CLASSES, BS, FANOUT = 2000, 8, 8, 16, 5, 16, [4, 3, 2]

#: mode -> sampler keywords.  The capped buffer holds 300 of the 656
#: rows a block can reach, which some batches overflow.
MODES = {
    "dense": dict(dedup="dense"),
    "sort": dict(dedup="sort"),
    "capped": dict(dedup="dense", node_capacity=300),
    "sort_capped": dict(dedup="sort", node_capacity=300),
    "leaf": dict(dedup="dense", last_hop_dedup=False),
    "frontier_cap": dict(dedup="dense", frontier_cap=24),
}


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(N), DEG)
    dst = rng.integers(0, N, src.size)
    feat = rng.standard_normal((N, DIM)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    return np.stack([src, dst]), feat, labels


def _sampler(mode):
    ei, feat, labels = _graph()
    s = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                        FANOUT, batch_size=BS, with_edge=False,
                        **MODES[mode])
    return s, feat, labels


def _bounds(s):
    return hop_prefixes(s.batch_size, s.num_neighbors, s.frontier_cap,
                        s.node_capacity)


def _seed_sets():
    rng = np.random.default_rng(1)
    full = rng.choice(N, BS, replace=False)
    ragged = np.full(BS, -1)
    ragged[:10] = rng.choice(N, 10, replace=False)
    dup = rng.choice(N, BS, replace=False)
    dup[5:9] = dup[0]
    return {"full": full, "ragged": ragged, "duplicates": dup}


def _blocks(mode, n_keys=4):
    """``(sampler, feat, labels, [(seeds, out)])``: each seed set under
    ``n_keys`` keys."""
    s, feat, labels = _sampler(mode)
    outs = []
    for name, seeds in _seed_sets().items():
        for k in range(n_keys):
            key = trandom.PRNGKey(10 * k + len(name), device="cpu")
            outs.append((seeds, s.sample_from_nodes(NodeSamplerInput(seeds),
                                                    key=key)))
    return s, feat, labels, outs


def _inputs(out, feat):
    node = out.node.long()
    x = torch.from_numpy(feat)[node.clamp(min=0)]
    x = torch.where((node >= 0)[:, None], x, 0)
    return x, torch.stack([out.row, out.col]), out.edge_mask


# -- the layout the bounds rely on -------------------------------------------
@pytest.mark.parametrize("mode", sorted(MODES))
def test_hop_prefixes_bound_the_layout(mode):
    """Every valid hop-k edge's destination lies below ``nodes[k]`` and
    its source below ``nodes[k + 1]``; every valid edge into a node
    reached within k hops lies in the slots ``[0, edges[k])``; the
    prefixes end at the block's rows and slots, and stay upper bounds of
    the counts (a frontier or occupancy cap only lowers these)."""
    s, _, _, outs = _blocks(mode)
    nodes, edges = _bounds(s)
    assert len(nodes) == len(FANOUT) + 1 and len(edges) == len(FANOUT)
    assert nodes[-1] == s.node_capacity and edges[-1] == s.edge_capacity
    assert nodes[0] == BS
    overflowed = 0
    for _, out in outs:
        row, col = out.row.long(), out.col.long()
        mask = out.edge_mask
        assert row.shape[0] == edges[-1]
        reached = np.minimum(np.cumsum(out.num_sampled_nodes.numpy()),
                             s.node_capacity)
        lo = 0
        for k, hi in enumerate(edges):
            m = mask[lo:hi]
            assert bool((col[lo:hi][m] < nodes[k]).all())
            assert bool((col[lo:hi][m] >= 0).all())
            assert bool((row[lo:hi][m] < nodes[k + 1]).all())
            lo = hi
        slot = torch.arange(row.shape[0])
        for k in range(len(edges)):
            assert reached[k] <= nodes[k]
            into = mask & (col < int(reached[k]))
            assert bool((slot[into] < edges[k]).all())
        if out.metadata is not None:
            overflowed += int(out.metadata["overflow"])
    if "capped" in mode:
        assert overflowed > 0


def test_hop_prefixes_values():
    assert hop_prefixes(1024, [15, 10, 5]) == (
        [1024, 16384, 169984, 937984], [15360, 168960, 936960])
    # A frontier cap narrows the widths; an occupancy cap clips the rows.
    assert hop_prefixes(4, [3, 2], frontier_cap=5) == ([4, 16, 26], [12, 22])
    assert hop_prefixes(4, [3, 2], node_capacity=20) == ([4, 16, 20],
                                                         [12, 36])


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
def test_layer_spans(layers):
    bounds = hop_prefixes(4, [3, 2, 2])           # nodes 4, 16, 40, 88
    spans = layer_spans(layers, 88, 84, bounds)
    assert spans[-1][1] == 4 and spans[-1][2] == 12
    for (_, out_rows, _), (in_rows, _, _) in zip(spans, spans[1:]):
        assert out_rows == in_rows
    assert spans[0][0] == (88 if layers >= 3 else bounds.nodes[layers])
    assert layer_spans(layers, 88, 84) == [None] * layers
    with pytest.raises(ValueError, match="hop prefixes"):
        layer_spans(layers, 87, 84, bounds)


# -- the trimmed forward -------------------------------------------------------
def _models(kind, dropout, dtype=None, layers=len(FANOUT)):
    torch.manual_seed(0)
    if kind == "sage":
        return GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=layers,
                         dropout_rate=dropout, dtype=dtype)
    return GAT(DIM, HIDDEN, CLASSES, num_layers=layers, heads=2,
               dropout_rate=dropout, dtype=dtype)


def _seed_loss(logits, out, labels):
    """CE summed over the batch's unique seeds, rows ``[0, count)``."""
    c0 = int(out.num_sampled_nodes[0])
    y = torch.from_numpy(labels)[out.node[:c0].long()]
    return F.cross_entropy(logits[:c0], y.long(), reduction="sum")


def _grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _assert_trim_matches(model, s, feat, labels, outs, dropout_key):
    bounds = _bounds(s)
    for i, (_, out) in enumerate(outs):
        x, ei, mask = _inputs(out, feat)
        key = (None if dropout_key is None
               else trandom.fold_in(dropout_key, i))
        full = model(x, ei, mask, dropout_key=key)
        gf = _grads(model, _seed_loss(full, out, labels))
        trim = model(x, ei, mask, dropout_key=key, bounds=bounds)
        gt = _grads(model, _seed_loss(trim, out, labels))
        assert trim.shape == (bounds.nodes[0], CLASSES)
        c0 = int(out.num_sampled_nodes[0])
        torch.testing.assert_close(trim[:c0], full[:c0], rtol=1e-6,
                                   atol=1e-6)
        for k in gf:
            torch.testing.assert_close(gt[k], gf[k], rtol=1e-5, atol=1e-6,
                                       msg=k)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trimmed_sage_matches_whole_block(mode, dropout):
    s, feat, labels, outs = _blocks(mode)
    key = trandom.PRNGKey(7, device="cpu") if dropout else None
    _assert_trim_matches(_models("sage", dropout), s, feat, labels, outs,
                         key)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trimmed_gat_matches_whole_block(mode):
    s, feat, labels, outs = _blocks(mode, n_keys=2)
    _assert_trim_matches(_models("gat", 0.5), s, feat, labels, outs,
                         trandom.PRNGKey(8, device="cpu"))


@pytest.mark.parametrize("layers", [1, 2, 4])
def test_trimmed_sage_other_depths(layers):
    """A stack shallower or deeper than the block's hops trims by the
    same rule (a prefix past the listed hops is the whole block)."""
    s, feat, labels, outs = _blocks("dense", n_keys=2)
    _assert_trim_matches(_models("sage", 0.5, layers=layers), s, feat,
                         labels, outs, trandom.PRNGKey(9, device="cpu"))


def test_trimmed_sage_bf16_matches_whole_block():
    s, feat, labels, outs = _blocks("dense", n_keys=2)
    _assert_trim_matches(_models("sage", 0.5, dtype=torch.bfloat16), s,
                         feat, labels, outs, trandom.PRNGKey(4, device="cpu"))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_trimmed_sage_matches_jax(mode):
    """Dropout off: the trimmed forward's seed rows against
    ``glt_tpu``'s GraphSAGE over the whole block (as
    ``test_torch_models.test_graphsage_forward``, 1e-5)."""
    import jax
    from glt_tpu_torch.models import params_from_flax

    s, feat, _, outs = _blocks(mode, n_keys=2)
    bounds = _bounds(s)
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=len(FANOUT))
    for _, out in outs:
        x, ei, mask = _inputs(out, feat)
        jx, jei, jmask = (jnp.asarray(t.numpy()) for t in (x, ei, mask))
        params = jm.init({"params": jax.random.PRNGKey(0)}, jx, jei, jmask)
        tm = GraphSAGE(DIM, HIDDEN, CLASSES, num_layers=len(FANOUT))
        tm.load_state_dict(params_from_flax(params))
        ref = np.asarray(jm.apply(params, jx, jei, jmask, train=False))
        with torch.no_grad():
            got = tm(x, ei, mask, bounds=bounds)
        c0 = int(out.num_sampled_nodes[0])
        np.testing.assert_allclose(got[:c0].numpy(), ref[:c0], atol=1e-5,
                                   rtol=1e-5)


def _whole_block_forward(model, x, ei, mask, key):
    """``GraphSAGE.forward`` and ``SAGEConv.forward`` as they stood
    before the layers took hop prefixes."""
    last = len(model.convs) - 1
    keys = None
    if key is not None and model.dropout_rate > 0.0 and last:
        keys = trandom.split(key, last)
    for i, conv in enumerate(model.convs):
        n = x.shape[0]
        msgs = x.index_select(0, ei[0].clamp(0, max(n - 1, 0)).long())
        agg = scatter_mean(msgs, ei[1], n, mask)
        if conv.dtype is None:
            x = conv.lin_self(x) + conv.lin_nbr(agg)
        else:
            dt, bias = conv.dtype, conv.lin_self.bias
            x = (F.linear(x.to(dt), conv.lin_self.weight.to(dt),
                          None if bias is None else bias.to(dt))
                 + F.linear(agg.to(dt), conv.lin_nbr.weight.to(dt))).float()
        if i != last:
            x = torch.relu(x)
            if keys is not None:
                x = model._dropout(x, keys[i])
    return x


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_forward_without_bounds_is_unchanged(dropout, dtype):
    """Without ``bounds`` the forward and its gradients are the earlier
    whole-block forward's, bit for bit."""
    s, feat, labels, outs = _blocks("dense", n_keys=1)
    model = _models("sage", dropout, dtype=dtype)
    key = trandom.PRNGKey(5, device="cpu")
    for _, out in outs:
        x, ei, mask = _inputs(out, feat)
        got = model(x, ei, mask, dropout_key=key)
        g_got = _grads(model, _seed_loss(got, out, labels))
        want = _whole_block_forward(model, x, ei, mask, key)
        g_want = _grads(model, _seed_loss(want, out, labels))
        assert torch.equal(got, want)
        for k in g_want:
            assert torch.equal(g_got[k], g_want[k]), k


# -- the scanned node step ------------------------------------------------------
class _WholeBlock(nn.Module):
    """A model that runs the whole block whatever the step passes."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x, edge_index, edge_mask, dropout_key=None,
                bounds=None):
        return self.inner(x, edge_index, edge_mask, dropout_key=dropout_key)


@pytest.mark.parametrize("mode", ["dense", "capped", "leaf"])
def test_scanned_step_trimmed_matches_whole_block(mode):
    """Three blocks (a ragged, a duplicate-seed and a padded batch among
    them) through the scanned node step: the losses, accuracies and
    parameters equal those of a model that runs every batch whole;
    ``glt.train.trimmed_steps`` counts the batches of distinct seeds,
    and the share gauges hold the layout."""
    s, feat, labels = _sampler(mode)
    trimmed = _models("sage", 0.5)
    whole = _WholeBlock(copy.deepcopy(trimmed))
    blocks = list(node_seed_blocks(np.arange(72), BS, 2,
                                   np.random.default_rng(2)))
    assert len(blocks) == 3 and (blocks[2] >= 0).sum() == 8
    blocks[1][1, 3] = blocks[1][1, 0]
    runs = []
    obs.metrics.enable()
    try:
        for model in (trimmed, whole):
            obs.metrics.reset()
            step = make_scanned_node_train_step(s, feat, labels, BS,
                                                dropout_seed=3)
            state = create_train_state(model, adam(1e-2))
            got = []
            for i, blk in enumerate(blocks):
                state, ls, accs, _ = step(
                    state, blk, trandom.PRNGKey(20 + i, device="cpu"))
                got.append((ls, accs))
            snap = obs.metrics.snapshot()
            assert snap["glt.train.trimmed_steps"] == 3
            assert state.step == 5
            runs.append(got)
    finally:
        obs.metrics.disable()
        obs.metrics.reset()
    nodes, edges = _bounds(s)
    for k in range(len(edges)):
        assert snap[f"glt.train.trim_rows_share{{hops={k}}}"] == (
            nodes[k] / nodes[-1])
        assert snap[f"glt.train.trim_edges_share{{hops={k}}}"] == (
            edges[k] / edges[-1])
    for (lt, at), (lw, aw) in zip(*runs):
        torch.testing.assert_close(lt, lw, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(at, aw)
    for (k, a), b in zip(trimmed.state_dict().items(),
                         whole.inner.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=k)


def test_scanned_step_runs_a_ragged_batch_whole():
    """A batch with fewer than ``B`` seeds runs the whole block, and its
    loss reads the first ``B`` rows, as ``glt_tpu``'s: the rows after
    its seeds hold nodes of the first hop, whose logits the trimmed
    layers would not compute.  It is not counted as trimmed."""
    s, feat, labels = _sampler("dense")
    model = _models("sage", 0.0)
    blk = np.full((1, BS), -1)
    blk[0, :6] = np.arange(100, 106)
    key = trandom.PRNGKey(4, device="cpu")
    out = s.sample_from_nodes(NodeSamplerInput(blk[0]),
                              key=trandom.split(key, 1)[0])
    assert int(out.num_sampled_nodes[0]) == 6 and bool(out.node_mask[BS - 1])
    x, ei, mask = _inputs(out, feat)
    node = out.node[:BS].long()
    valid = out.node_mask[:BS] & (node >= 0)
    y = torch.from_numpy(labels)[node.clamp(min=0)].long()
    with torch.no_grad():
        ce = F.cross_entropy(model(x, ei, mask)[:BS], y, reduction="none")
    want = ce[valid].mean()
    obs.metrics.enable()
    try:
        obs.metrics.reset()
        step = make_scanned_node_train_step(s, feat, labels, BS)
        _, ls, _, _ = step(create_train_state(model, adam(1e-2)), blk, key)
        assert obs.metrics.snapshot()["glt.train.trimmed_steps"] == 0
    finally:
        obs.metrics.disable()
        obs.metrics.reset()
    torch.testing.assert_close(ls[0], want, rtol=1e-6, atol=1e-6)


def test_scanned_step_refuses_another_batch_size():
    s, feat, labels = _sampler("dense")
    with pytest.raises(ValueError, match="not the sampler's"):
        make_scanned_node_train_step(s, feat, labels, 2 * BS)
