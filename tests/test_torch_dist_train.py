"""glt_tpu_torch's DistDataset and distributed train step against
glt_tpu's, on the CPU.

One partition directory (written by glt_tpu) loads in both packages:
the sharded arrays, the relabel, ``translate`` and ``split_seeds``
(with a Generator advancing across epochs) compare with ``==``.  Three
steps of the distributed train step run from the same parameters
(``params_from_flax``) on both sides, for each branch of the per-shard
feature+label gather: the per-shard batches are equal, so the losses,
accuracies and parameters compare within 1e-5 (the port takes the
backward of the mean of the shard losses, ``glt_tpu`` the mean of the
shard gradients; optax and torch place Adam's bias correction
differently).  A fully padded batch leaves either package's state as it
was; the byte models agree; the example twin trains on the CPU with its
loss falling as ``tests/test_dist_dataset.py`` requires of glt_tpu, at
its default ``--hot-ratio`` 0.25 (the tiered pipeline) and at 1.0.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from glt_tpu.distributed import DistDataset as JaxDataset
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.parallel import shard_feature as jax_shard_feature
from glt_tpu.partition import FrequencyPartitioner, RandomPartitioner
from glt_tpu_torch import random as trandom
from glt_tpu_torch.distributed import DistDataset
from glt_tpu_torch.examples import dist_train_papers100m as twin
from glt_tpu_torch.models import GraphSAGE, adam, params_from_flax
from glt_tpu_torch.parallel import (
    Mesh,
    TieredShardedFeature,
    dist_step_byte_model,
    init_dist_state,
    make_dist_train_step,
    shard_feature,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, CLASSES, HIDDEN, LR = 96, 4, 16, 1e-2
BS, FANOUTS = 4, [3, 3]


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
def parts(tmp_path_factory):
    """Partition directories for 2 and 4 shards (random and frequency)."""
    ei, feat, labels = _clustered_graph()
    out = {}
    for s in (2, 4):
        root = str(tmp_path_factory.mktemp(f"parts{s}"))
        if s == 2:
            RandomPartitioner(root, s, N, ei, node_feat=feat,
                              seed=3).partition()
        else:
            probs = [np.random.default_rng(r).random(N) for r in range(s)]
            FrequencyPartitioner(root, s, N, ei, node_feat=feat,
                                 probs=probs, chunk_size=8).partition()
        out[s] = root
    return out, labels


def _load_both(root, labels, **kw):
    return (JaxDataset.load(root, labels=labels, **kw),
            DistDataset.load(root, labels=labels, device="cpu", **kw))


@pytest.mark.parametrize("s", [2, 4])
def test_load_translate_split_seeds_equal(parts, s):
    roots, labels = parts
    hot = np.random.default_rng(1).random(N) if s == 4 else None
    jd, td = _load_both(roots[s], labels, hotness=hot)
    for f in ("indptr", "indices", "edge_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(jd.graph, f)),
                                      getattr(td.graph, f).numpy())
    assert jd.graph[3:] == td.graph[3:]
    np.testing.assert_array_equal(np.asarray(jd.feature.rows),
                                  td.feature.rows.numpy())
    np.testing.assert_array_equal(np.asarray(jd.labels), td.labels.numpy())
    for a, b in zip(jd.relabel, td.relabel):
        np.testing.assert_array_equal(a, b)
    ids = np.array([0, 5, N - 1, 17])
    np.testing.assert_array_equal(jd.translate(ids), td.translate(ids))
    np.testing.assert_array_equal(jd.split_seeds(np.arange(N), 4),
                                  td.split_seeds(np.arange(N), 4))
    np.testing.assert_array_equal(
        jd.split_seeds(np.arange(N), 5, shuffle=True, seed=7),
        td.split_seeds(np.arange(N), 5, shuffle=True, seed=7))
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    epochs = []
    for _ in range(2):
        a = jd.split_seeds(np.arange(N), 4, shuffle=True, rng=jr)
        b = td.split_seeds(np.arange(N), 4, shuffle=True, rng=tr)
        np.testing.assert_array_equal(a, b)
        epochs.append(b)
    assert not np.array_equal(*epochs)       # the Generator advanced


def test_load_refuses_what_is_not_ported(parts):
    """``mesh=`` still raises naming its queue item; ``hot_ratio`` below
    1 loads the tiered feature with glt_tpu's ``hot_per_shard``."""
    roots, labels = parts
    jd, td = _load_both(roots[2], labels, hot_ratio=0.5)
    assert isinstance(td.feature, TieredShardedFeature)
    assert td.feature.hot_per_shard == jd.feature.hot_per_shard == round(
        0.5 * td.feature.nodes_per_shard)
    np.testing.assert_array_equal(np.asarray(jd.feature.hot),
                                  td.feature.hot.numpy())
    np.testing.assert_array_equal(jd.feature.cold, td.feature.cold)
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        DistDataset.load(roots[2], mesh=Mesh(["cpu"] * 2), device="cpu")


def _jmesh(s):
    return JaxMesh(np.array(jax.devices()[:s]), ("shard",))


def _models(jd):
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=CLASSES,
                 num_layers=len(FANOUTS), dropout_rate=0.0)
    tx = optax.adam(LR)
    jstate = jdt.init_dist_state(jm, tx, jd.graph, jd.feature,
                                 jax.random.PRNGKey(0), FANOUTS, BS)
    tm = GraphSAGE(jd.feature.rows.shape[-1], HIDDEN, CLASSES,
                   num_layers=len(FANOUTS), dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(jstate.params))
    return jm, tx, jstate, tm


def _assert_params(jparams, model, tol=1e-5):
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                   rtol=tol, err_msg=k)


# branch: (shards, sampler knobs).  "xy*" gather features and labels in
# one exchange, the port serving the rows through B3's plain version;
# "split*" build the features over two extra rows, so their shards are
# wider than the graph's and the gather takes a feature and a label
# exchange; "*_dedup" send unique ids.
_BRANCHES = {
    "xy": (4, {}),
    "xy_dedup": (4, {"dedup_gather": True, "last_hop_dedup": False}),
    "split": (2, {}),
    "split_dedup": (4, {"dedup_gather": True}),
}


@pytest.mark.parametrize("branch", sorted(_BRANCHES))
def test_three_steps_match_jax(parts, branch):
    s, kw = _BRANCHES[branch]
    roots, labels = parts
    jd, td = _load_both(roots[s], labels)
    jf, tf = jd.feature, td.feature
    if branch.startswith("split"):
        full = td.feature.rows.reshape(-1, td.feature.rows.shape[-1]).numpy()
        full = np.concatenate([full, np.zeros((2, full.shape[1]),
                                              np.float32)])
        jf, tf = jax_shard_feature(full, s), shard_feature(full, s,
                                                           device="cpu")
        assert tf.nodes_per_shard != td.graph.nodes_per_shard
    jm, tx, jstate, tm = _models(jd)
    jstep = jdt.make_dist_train_step(jm, tx, jd.graph, jf, jd.labels,
                                     _jmesh(s), FANOUTS, BS, **kw)
    tkw = dict(kw, fused_frontier=branch.startswith("xy"))
    tstep = make_dist_train_step(td.graph, tf, td.labels, Mesh(["cpu"] * s),
                                 FANOUTS, BS, **tkw)
    assert tstep.collective_bytes == jstep.collective_bytes
    tstate = init_dist_state(tm, adam(LR), td.graph, tf, FANOUTS, BS)
    batches = td.split_seeds(np.arange(N), BS, shuffle=True, seed=1)
    for b in range(3):
        jstate, jloss, jacc = jstep(jstate, jnp.asarray(batches[b]),
                                    jax.random.PRNGKey(10 + b))
        tstate, tloss, tacc = tstep(tstate, batches[b],
                                    trandom.PRNGKey(10 + b, device="cpu"))
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tacc), float(jacc), atol=1e-6)
    assert tstate.step == int(jstate.step) == 3
    _assert_params(jstate.params, tstate.model)


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()), state.step)


def _same(a, b):
    """Equal states; Adam's state created by the padded step must be the
    fresh state it stands for (zero moments, step 0)."""
    (ma, oa, sa), (mb, ob, sb) = a, b
    assert sa == sb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    assert set(oa["state"]) <= set(ob["state"])
    for i, st in ob["state"].items():
        for k, v in st.items():
            want = oa["state"][i][k] if i in oa["state"] else \
                torch.zeros_like(v)
            assert torch.equal(v, want), (i, k)


def test_padded_batch_leaves_state_unchanged(parts):
    roots, labels = parts
    s = 4
    jd, td = _load_both(roots[s], labels)
    jm, tx, jstate, tm = _models(jd)
    jstep = jdt.make_dist_train_step(jm, tx, jd.graph, jd.feature,
                                     jd.labels, _jmesh(s), FANOUTS, BS)
    tstep = make_dist_train_step(td.graph, td.feature, td.labels,
                                 Mesh(["cpu"] * s), FANOUTS, BS)
    tstate = init_dist_state(tm, adam(LR), td.graph, td.feature, FANOUTS,
                             BS)
    pad = np.full((s, BS), -1, np.int64)
    real = td.split_seeds(np.arange(N), BS)[0]
    key = trandom.PRNGKey(3, device="cpu")
    # On a fresh state (the step creates Adam's state), then after a
    # real step.
    for before_real in (False, True):
        if before_real:
            tstate, _, _ = tstep(tstate, real, key)
            jstate, _, _ = jstep(jstate, jnp.asarray(real),
                                 jax.random.PRNGKey(3))
        snap, jsnap = _snapshot(tstate), jax.device_get(jstate)
        tstate, tloss, tacc = tstep(tstate, pad, key)
        jstate, jloss, jacc = jstep(jstate, jnp.asarray(pad),
                                    jax.random.PRNGKey(3))
        _same(snap, _snapshot(tstate))
        for a, b in zip(jax.tree_util.tree_leaves(jsnap),
                        jax.tree_util.tree_leaves(jstate)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert float(tloss) == float(jloss) == 0.0
        assert float(tacc) == float(jacc) == 0.0
    assert tstate.step == int(jstate.step) == 1
    _assert_params(jstate.params, tstate.model)


@pytest.mark.parametrize("cfg", [
    (100, 4, [12, 10], 128, None, 128),
    (1000, 8, [15, 10, 5], 512, 4096, 100),
    (7, 2, [3], 5, None, 1),
])
def test_dist_step_byte_model_equal(cfg):
    c, s, fanouts, bs, cap, dim = cfg
    assert dist_step_byte_model(c, s, fanouts, bs, cap, dim, "shard",
                                None) == \
        jdt.dist_step_byte_model(c, s, fanouts, bs, cap, dim, "shard", None)


def test_partition_to_mesh_train_loss_drops(parts):
    """The port's run of glt_tpu's test of the same name: partition dir
    -> DistDataset -> distributed steps, the loss falling below 0.6 of
    its first value over 15 epochs."""
    roots, labels = parts
    td = DistDataset.load(roots[4], labels=labels, device="cpu")
    torch.manual_seed(0)
    tm = GraphSAGE(td.feature.rows.shape[-1], HIDDEN, CLASSES,
                   num_layers=2, dropout_rate=0.0)
    state = init_dist_state(tm, adam(LR), td.graph, td.feature, FANOUTS, BS)
    step = make_dist_train_step(td.graph, td.feature, td.labels,
                                Mesh(["cpu"] * 4), FANOUTS, BS)
    batches = td.split_seeds(np.arange(N), BS, shuffle=True, seed=1)
    losses = []
    for epoch in range(15):
        for b in range(batches.shape[0]):
            state, loss, _ = step(state, batches[b], trandom.PRNGKey(
                epoch * 100 + b, device="cpu"))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


@pytest.mark.parametrize("hot_ratio", [None, "1.0"])
def test_example_twin_trains_on_cpu(tmp_path, hot_ratio):
    """The papers100M twin at a tiny scale on the CPU: partition, load,
    three epochs, every loss finite and the last epoch's mean below 0.6
    of the first's; at its default ``--hot-ratio`` (0.25, the JAX
    example's) through the tiered pipeline, at 1.0 through the
    distributed step."""
    argv = ["--device", "cpu", "--devices", "4", "--scale", "2e-5",
            "--epochs", "3", "--part-dir", str(tmp_path / "parts")]
    if hot_ratio is not None:
        argv += ["--hot-ratio", hot_ratio]
    assert twin.parse_args(argv).hot_ratio == (
        0.25 if hot_ratio is None else 1.0)
    state, history = twin.main(argv)
    flat = np.concatenate(history)
    assert np.isfinite(flat).all()
    assert history[-1].mean() < 0.6 * history[0].mean()
    assert state.step == sum(len(h) for h in history)
