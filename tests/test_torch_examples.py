"""The port's twins of ``examples/train_sage_products.py``,
``examples/bipartite_sage_unsup.py`` and ``examples/dist_train_sage.py``
against the JAX examples, on the CPU at a small scale.

Each side builds its example's data from the same numpy recipe and its
model from the same weights (``params_from_flax``); the JAX side runs
the example's own calls (its step function written out where the
example keeps it inside ``main``).  Losses, accuracies and parameters
compare within 1e-5 (f32 math in another order; optax and torch place
Adam's bias correction differently), node capacities with ``==``.  The
bipartite twin's loss must fall over its epochs, as the JAX example's
does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh as JaxMesh

from examples import bipartite_sage_unsup as jax_bip
from examples import datasets as jax_datasets
from glt_tpu.loader.hetero_link_loader import \
    HeteroLinkNeighborLoader as JaxLinkLoader
from glt_tpu.models import GraphSAGE as JaxSAGE
from glt_tpu.models import train as jtrain
from glt_tpu.parallel import dist_train as jdt
from glt_tpu.parallel import shard_feature as jax_shard_feature
from glt_tpu.parallel import shard_graph as jax_shard_graph
from glt_tpu.sampler import NegativeSampling as JaxNeg
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler import calibrate_node_capacity as jax_calibrate
from glt_tpu.typing import reverse_edge_type
from glt_tpu_torch.examples import bipartite_sage_unsup as tbip
from glt_tpu_torch.examples import dist_train_sage as tdist
from glt_tpu_torch.examples import train_sage_products as tprod
from glt_tpu_torch.models import params_from_flax

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _assert_params(state_dict, want):
    assert set(want) <= set(state_dict)
    for k, v in want.items():
        _close(state_dict[k].detach().numpy(), v.numpy(), k)


def _products_args(group):
    return tprod.parse_args([
        "--device", "cpu", "--scale", "0.001", "--epochs", "2",
        "--batch-size", "64", "--fanout", "10", "5", "--hidden", "16",
        "--frontier-cap", "512", "--cap-batches", "4", "--no-bf16",
        "--group", str(group)])


def test_products_twin_scanned_epochs_match_jax():
    """Two scanned epochs (G = 2) of the products twin's ``run`` against
    the JAX example's calls: the calibrated capacity, each epoch's
    losses and the final parameters."""
    args = _products_args(2)
    jds, train_idx = jax_datasets.synthetic_products(scale=args.scale)
    skw = dict(batch_size=args.batch_size, frontier_cap=args.frontier_cap,
               with_edge=False, sample_force="xla")
    probe = JaxSampler(jds.get_graph(), args.fanout, **skw)
    cal = [b for b, _ in zip(tprod.seed_batches(
        train_idx, args.batch_size, np.random.default_rng(42)),
        range(args.cap_batches))]
    node_cap = jax_calibrate(probe, cal)
    assert node_cap < probe.full_node_capacity
    js = JaxSampler(jds.get_graph(), args.fanout, node_capacity=node_cap,
                    **skw)
    jm = JaxSAGE(hidden_features=args.hidden, out_features=tprod.CLASSES,
                 num_layers=len(args.fanout), dropout_rate=0.0)
    feat = jds.get_node_feature()
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((js.node_capacity, feat.shape[1])),
                     jnp.full((2, js.edge_capacity), -1, jnp.int32),
                     jnp.zeros((js.edge_capacity,), bool))
    tx = optax.adam(1e-3)
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    jstep = jtrain.make_scanned_node_train_step(
        jm, tx, js, feat, np.asarray(jds.get_node_label()), args.batch_size)
    rng, jhist = np.random.default_rng(0), []
    for epoch in range(args.epochs):
        jstate, jl, _, _ = jtrain.run_scanned_epoch(
            jstep, jstate, train_idx, args.batch_size, args.group, rng,
            jax.random.PRNGKey(100 + epoch))
        jhist.append(np.asarray(jl))

    tm = tprod.make_model(args, feat.shape[1], dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(params))
    assert tprod.build_sampler(
        args, *tprod.synthetic_products(scale=args.scale, device="cpu")
    ).node_capacity == node_cap
    state, hist = tprod.run(args, model=tm)
    assert len(hist) == len(jhist) == 2
    for e, (t, j) in enumerate(zip(hist, jhist)):
        _close(t, j, f"epoch {e} losses")
    assert state.step == int(jstate.step) == sum(len(h) for h in hist)
    _assert_params(state.model.state_dict(), params_from_flax(jstate.params))


def test_products_twin_loader_loop_trains():
    """``--group 0``: the loader loop, one step a batch, every loss
    finite and the optimizer's step count one a batch."""
    state, hist = tprod.run(_products_args(0))
    assert all(np.isfinite(h).all() for h in hist)
    assert state.step == sum(len(h) for h in hist) > 0


def _jax_bip_step(model, tx):
    """The JAX example's step (``examples/bipartite_sage_unsup.py``,
    inside its ``main``)."""
    @jax.jit
    def step(params, opt_state, batch):
        eli = batch.metadata["edge_label_index"]
        label = batch.metadata["edge_label"]

        def loss_fn(p):
            logits = model.apply(p, batch.x, batch.edge_index,
                                 batch.edge_mask, eli)
            valid = label >= 0
            y = jnp.clip(label, 0, 1).astype(jnp.float32)
            bce = optax.sigmoid_binary_cross_entropy(logits, y)
            loss = jnp.where(valid, bce, 0).sum() / jnp.maximum(
                valid.sum(), 1)
            acc = jnp.where(valid, (logits > 0) == (y > 0.5),
                            False).sum() / jnp.maximum(valid.sum(), 1)
            return loss, acc
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    return step


def _two_tower_from_flax(params):
    """The twin's state dict from the JAX model's tree: ``in_{t}`` and
    ``layer{i}`` through ``params_from_flax``, ``out_{t}`` by hand."""
    tree = dict(params["params"])
    outs = {k: tree.pop(k) for k in list(tree) if k.startswith("out_")}
    state = params_from_flax(tree)
    for k, dense in outs.items():
        state[f"outputs.{k[4:]}.weight"] = torch.from_numpy(
            np.array(dense["kernel"], np.float32).T.copy())
        state[f"outputs.{k[4:]}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32))
    return state


def test_bipartite_twin_steps_match_jax():
    """Four batches of an epoch through both examples' steps, from the
    same weights: loss, link accuracy and the parameters."""
    args = tbip.parse_args(["--device", "cpu"])
    jds, pos = jax_bip.synthetic_user_item()

    def jloader():
        return JaxLinkLoader(jds, args.fanout, (jax_bip.ET_UI, pos),
                             neg_sampling=JaxNeg("binary", 1.0),
                             batch_size=args.batch_size, shuffle=True,
                             seed=0)

    batch_ets = sorted(reverse_edge_type(et) for et in jds.graph)
    jm = jax_bip.TwoTowerSAGE(edge_types=tuple(batch_ets))
    first = next(iter(jloader()))
    params = jm.init(jax.random.PRNGKey(0), first.x, first.edge_index,
                     first.edge_mask, first.metadata["edge_label_index"])
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    jstep = _jax_bip_step(jm, tx)

    loader, state = tbip.build(args)
    missing, unexpected = state.model.load_state_dict(
        _two_tower_from_flax(params), strict=False)
    assert not missing and not unexpected
    step = tbip.make_step()
    for i, (jb, tb) in enumerate(zip(jloader(), loader)):
        if i == 4:
            break
        params, opt_state, jl, ja = jstep(params, opt_state, jb)
        state, tl, ta = step(state, tb)
        _close(float(tl), float(jl), f"batch {i} loss")
        _close(float(ta), float(ja), f"batch {i} acc")
    assert state.step == 4
    _assert_params(state.model.state_dict(), _two_tower_from_flax(params))


def test_bipartite_twin_loss_falls():
    """Three epochs on the CPU: the mean BCE falls epoch over epoch."""
    state, history = tbip.main(["--device", "cpu", "--epochs", "3"])
    assert all(np.isfinite(history))
    assert history[2] < history[1] < history[0], history
    assert state.step > 0


def test_dist_train_sage_twin_steps_match_jax():
    """The twin's sharded data and two distributed steps against the
    JAX example's, over 4 shards, from the same weights: the shards
    equal, the losses and the parameters within 1e-5."""
    args = tdist.parse_args([
        "--device", "cpu", "--devices", "4", "--scale", "0.001",
        "--batch-size", "16", "--fanout", "3", "2", "--frontier-cap",
        "64"])
    S = args.devices
    jds, train_idx = jax_datasets.synthetic_products(scale=args.scale,
                                                     graph_mode="HOST")
    labels = np.asarray(jds.get_node_label())
    g = jax_shard_graph(jds.get_graph().topo, S)
    f = jax_shard_feature(jds.get_node_feature()._host_full, S)
    pad = S * g.nodes_per_shard - labels.shape[0]
    lab = jnp.asarray(np.pad(labels, (0, pad), constant_values=-1)
                      .reshape(S, g.nodes_per_shard))
    jm = JaxSAGE(hidden_features=128, out_features=tdist.CLASSES,
                 num_layers=len(args.fanout), dropout_rate=0.0)
    tx = optax.adam(1e-3)
    jstate = jdt.init_dist_state(jm, tx, g, f, jax.random.PRNGKey(0),
                                 args.fanout, args.batch_size)
    jstep = jdt.make_dist_train_step(
        jm, tx, g, f, lab, JaxMesh(np.array(jax.devices()[:S]), ("shard",)),
        args.fanout, args.batch_size, frontier_cap=args.frontier_cap)

    tm = tdist.GraphSAGE(f.rows.shape[-1], 128, tdist.CLASSES,
                         num_layers=len(args.fanout), dropout_rate=0.0)
    tm.load_state_dict(params_from_flax(jstate.params))
    run = tdist.build(args, model=tm)
    for name in ("indptr", "indices", "edge_ids"):
        np.testing.assert_array_equal(getattr(run.graph, name).numpy(),
                                      np.asarray(getattr(g, name)))
    np.testing.assert_array_equal(run.feature.rows.numpy(),
                                  np.asarray(f.rows))
    np.testing.assert_array_equal(run.labels.numpy(), np.asarray(lab))
    per_shard = [train_idx[train_idx // g.nodes_per_shard == s]
                 for s in range(S)]
    assert all(np.array_equal(a, b) for a, b in zip(per_shard,
                                                   run.per_shard))
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    state = run.state
    for it in range(2):
        jseeds = np.stack([
            jrng.choice(p, args.batch_size,
                        replace=len(p) < args.batch_size)
            for p in per_shard]).astype(np.int32)
        tseeds = tdist.draw_seeds(trng, run.per_shard, args.batch_size)
        np.testing.assert_array_equal(jseeds, tseeds)
        jstate, jl, _ = jstep(jstate, jnp.asarray(jseeds),
                              jax.random.PRNGKey(it))
        state, tl, _ = run.step(state, tseeds,
                                tdist.trandom.PRNGKey(it, device="cpu"))
        _close(float(tl), float(jl), f"step {it} loss")
    assert state.step == int(jstate.step) == 2
    _assert_params(state.model.state_dict(), params_from_flax(jstate.params))


def test_dist_train_sage_twin_main_on_cpu():
    """The twin end to end on 4 CPU shards: finite losses, one step a
    batch of every shard."""
    state, history = tdist.main(["--device", "cpu", "--devices", "4",
                                 "--scale", "0.002", "--epochs", "2",
                                 "--batch-size", "32"])
    assert all(np.isfinite(h).all() for h in history)
    assert state.step == sum(len(h) for h in history) > 2
