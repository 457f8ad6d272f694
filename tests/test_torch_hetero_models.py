"""The port's attention layers, hetero models and scanned hetero step
against glt_tpu's on the CPU.

Parameters are flax's, carried across by ``params_from_flax``; inputs
are the same arrays (the port's hetero loader batches, equal to
glt_tpu's by ``tests/test_torch_hetero.py``).  Within 1e-5 relative:
``segment_softmax`` and ``GATConv`` values and gradients (scores above
88 beside masked lanes included), ``GAT``, ``HeteroConv`` (with its
``_align`` projection), ``RGAT`` and ``HGT`` logits and parameter
gradients, HGT's attention mass, and a G = 3 scanned block of R-GAT and
of HGT (dropout 0, its last batch fully padded) in losses, accuracies
and final parameters: ``index_add_`` and ``segment_sum`` add in
different orders, and optax and torch place Adam's bias correction
differently.  Then the HGT twin's accuracy floor and both twins' loader
route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples import datasets as jax_datasets
from glt_tpu.models import HGT as JaxHGT
from glt_tpu.models import conv as jconv
from glt_tpu.models import gat as jgat
from glt_tpu.models import rgat as jrgat
from glt_tpu.models import train as jtrain
from glt_tpu.sampler import hetero_neighbor_sampler as jhns
from glt_tpu.typing import reverse_edge_type
from glt_tpu_torch import random as trandom
from glt_tpu_torch.examples import datasets as tdatasets
from glt_tpu_torch.examples import rgat_igbh as trgat
from glt_tpu_torch.examples import train_hgt_mag as thgt
from glt_tpu_torch.loader import HeteroNeighborLoader
from glt_tpu_torch.models import (
    GAT,
    HGT,
    RGAT,
    GATConv,
    HeteroConv,
    adam,
    init_hetero_state,
    make_scanned_hetero_train_step,
    node_seed_blocks,
    params_from_flax,
    segment_softmax,
)
from glt_tpu_torch.sampler import HeteroNeighborSampler

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

RTOL = 1e-5
BS = 8
# Adam's eps in the scanned-block comparison.  Adam scales each element's
# step by its own gradient's size, so at optax's 1e-8 an element whose
# gradient is near zero (GAT's att_dst, say, where a destination's
# scores keep one sign and the softmax is shift-invariant) steps by a
# sizable fraction of the learning rate in a direction set by rounding:
# R-GAT's layer-1 att_dst ends 4e-4 apart after 5 steps at 5e-3.  At
# 1e-3 such an element barely moves, and gradients of 1e-3 and up still
# take full steps.
ADAM_EPS = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _xla_sampler():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLT_SAMPLE_FORCE", "xla")
        yield


def _close(got, want, what, tol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _grads_close(model, jgrads, tol=RTOL):
    """Torch grads (None = zero: a parameter off the loss's path) against
    flax's, carried across like parameters."""
    params = dict(model.named_parameters())
    for k, v in params_from_flax(jgrads).items():
        g = params[k].grad
        g = torch.zeros_like(params[k]) if g is None else g
        scale = max(float(v.abs().max()), 1.0)
        _close(g.numpy() / scale, v.numpy() / scale, k, tol)


def _scores(seed, e=40, h=None, big=False):
    rng = np.random.default_rng(seed)
    shape = (e,) if h is None else (e, h)
    s = rng.normal(size=shape).astype(np.float32) * 3
    if big:
        s[::3] += 95.0                      # exp would overflow unclamped
    seg = rng.integers(0, 6, e).astype(np.int32)
    mask = rng.random(e) < 0.7
    seg[~mask & (np.arange(e) % 2 == 0)] = -1
    return s, seg, mask


@pytest.mark.parametrize("heads,big", [(None, False), (3, True)])
def test_segment_softmax_matches_jax(heads, big):
    s, seg, mask = _scores(0, h=heads, big=big)
    w = np.random.default_rng(1).normal(size=s.shape).astype(np.float32)

    def jf(x):
        if heads is None:
            a = jconv.segment_softmax(x, jnp.asarray(seg), 6,
                                      jnp.asarray(mask))
        else:
            a = jax.vmap(lambda c: jconv.segment_softmax(
                c, jnp.asarray(seg), 6, jnp.asarray(mask)), 1, 1)(x)
        return (a * w).sum(), a

    (_, ja), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_()
    a = segment_softmax(x, torch.from_numpy(seg), 6, torch.from_numpy(mask))
    (a * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(x.grad).all()
    _close(a.detach(), ja, "alpha")
    _close(x.grad, jg, "grad")
    assert not a[torch.from_numpy(~mask)].any()


def _homo_batch(seed=2, n=30, e=90, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    mask = rng.random(e) < 0.8
    ei[:, ~mask] = -1
    return x, ei, mask


def _jax_vs_torch(jm, tm, args, jargs_extra=None):
    """Logits and grads of sum(logits * w) through both modules."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, *jargs)
    missing, unexpected = tm.load_state_dict(params_from_flax(params),
                                             strict=False)
    assert not unexpected
    out0 = jax.eval_shape(jm.apply, params, *jargs)
    w = np.random.default_rng(5).normal(size=out0.shape).astype(np.float32)

    def jf(p):
        out = jm.apply(p, *jargs)
        return (out * w).sum(), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    targs = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
             for a in args]
    out = tm(*targs)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), jout, "out")
    _grads_close(tm, jg)
    return params, missing


@pytest.mark.parametrize("concat", [True, False])
def test_gatconv_matches_jax(concat):
    x, ei, mask = _homo_batch()
    jm = jconv.GATConv(5, heads=3, concat=concat)
    tm = GATConv(6, 5, heads=3, concat=concat)
    _, missing = _jax_vs_torch(jm, tm, [x, ei, mask])
    assert not missing


def test_gat_matches_jax():
    x, ei, mask = _homo_batch(seed=4)
    jm = jgat.GAT(hidden_features=4, out_features=3, num_layers=2, heads=2,
                  dropout_rate=0.0)
    tm = GAT(6, 4, 3, num_layers=2, heads=2, dropout_rate=0.0)
    _, missing = _jax_vs_torch(jm, tm, [x, ei, mask])
    assert not missing


@pytest.fixture(scope="module")
def igbh_batch():
    """One batch of the port's hetero loader on the IGBH dataset (3 node
    types, 5 edge types; institutes expand at no hop, so the batch holds
    no edge of the reverse of ``affiliated``)."""
    ds, _, classes = tdatasets.synthetic_igbh(scale=0.01, device="cpu")
    b = next(iter(HeteroNeighborLoader(ds, [3, 2], ("paper", np.arange(30)),
                                       batch_size=BS)))
    ets = sorted(reverse_edge_type(et) for et in ds.graph)
    return b, ets, classes


def _np(d):
    return {k: v.numpy() for k, v in d.items()}


def _hetero_args(b, jax_side):
    args = [b.x, b.edge_index, b.edge_mask]
    if not jax_side:
        return args
    return [{k: jnp.asarray(v) for k, v in _np(d).items()} for d in args]


@pytest.mark.parametrize("arch", ["rgat", "hgt"])
def test_hetero_model_matches_jax(igbh_batch, arch):
    b, ets, classes = igbh_batch
    widths = {t: v.shape[1] for t, v in b.x.items()}
    if arch == "rgat":
        jm = jrgat.RGAT(edge_types=ets, hidden_features=16,
                        out_features=classes, target_type="paper",
                        heads=2, conv="gat", dropout_rate=0.0)
        tm = RGAT(ets, widths, 16, classes, "paper", heads=2, conv="gat",
                  dropout_rate=0.0)
    else:
        jm = JaxHGT(edge_types=ets, hidden_features=16, out_features=classes,
                    target_type="paper", heads=4, dropout_rate=0.0)
        tm = HGT(ets, widths, 16, classes, "paper", heads=4,
                 dropout_rate=0.0)
    jargs = _hetero_args(b, True)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(1)}, *jargs)
    missing, unexpected = tm.load_state_dict(params_from_flax(params),
                                             strict=False)
    assert not unexpected
    # Flax made no parameters for the edge type without batch edges (nor,
    # in HGT, for the type it alone would reach).
    assert missing and all("affiliated" in k or "institute" in k
                           for k in missing), missing
    w = np.random.default_rng(3).normal(size=(BS, classes)).astype(np.float32)

    def jf(p):
        out = jm.apply(p, *jargs)[:BS]
        return (out * w).sum(), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    out = tm(*_hetero_args(b, False))[:BS]
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), jout, "logits")
    _grads_close(tm, jg)


def test_hgt_attention_mass_matches_jax(igbh_batch):
    b, ets, classes = igbh_batch
    widths = {t: v.shape[1] for t, v in b.x.items()}
    jm = JaxHGT(edge_types=ets, hidden_features=16, out_features=classes,
                target_type="paper", heads=2, dropout_rate=0.0)
    tm = HGT(ets, widths, 16, classes, "paper", heads=2, dropout_rate=0.0)
    jargs = _hetero_args(b, True)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(2)}, *jargs)
    tm.load_state_dict(params_from_flax(params), strict=False)
    _, inter = jax.jit(lambda p, *a: jm.apply(p, *a, mutable=[
        "intermediates"]))(params, *jargs)
    tm.record_attention()
    with torch.no_grad():
        tm(*_hetero_args(b, False))
    for i, layer in enumerate(tm.layers):
        want = inter["intermediates"][f"layer{i}"]
        assert sorted(layer.att_weight_sum) == sorted(
            k[len("att_weight_sum_"):] for k in want)
        for t, mass in layer.att_weight_sum.items():
            _close(mass, want[f"att_weight_sum_{t}"][0], f"layer{i} {t}")
            # 1 where a node has an incoming edge of any type, else 0
            has_in = torch.zeros(mass.shape[0], dtype=torch.bool)
            for et, ei in b.edge_index.items():
                if et[2] == t:
                    ok = b.edge_mask[et]
                    has_in[ei[1][ok].long()] = True
            want_mass = has_in.float()[:, None].expand_as(mass)
            _close(mass, want_mass, f"mass {t}")


def test_heteroconv_align_and_sage_match_jax():
    """Feature widths that differ: the ``_align`` projection exists and
    is carried across; SAGE and GAT convs per edge type."""
    rng = np.random.default_rng(7)
    x = {"u": rng.normal(size=(9, 3)).astype(np.float32),
         "i": rng.normal(size=(7, 5)).astype(np.float32)}
    ets = [("u", "buys", "i"), ("i", "rev_buys", "u"), ("i", "sim", "i")]
    ei = {("u", "buys", "i"): np.stack([rng.integers(0, 9, 12),
                                        rng.integers(0, 7, 12)]),
          ("i", "rev_buys", "u"): np.stack([rng.integers(0, 7, 10),
                                            rng.integers(0, 9, 10)]),
          ("i", "sim", "i"): np.zeros((2, 0), np.int64)}
    ei = {k: v.astype(np.int32) for k, v in ei.items()}
    mask = {k: np.arange(v.shape[1]) % 4 != 3 for k, v in ei.items()}
    for conv in ("sage", "gat"):
        jm = jrgat.HeteroConv(edge_types=ets, out_features=4, conv=conv)
        tm = HeteroConv(ets, {"u": 3, "i": 5}, 4, conv=conv)
        jargs = [{k: jnp.asarray(v) for k, v in d.items()}
                 for d in (x, ei, mask)]
        params = jax.jit(jm.init)({"params": jax.random.PRNGKey(3)}, *jargs)
        assert "u__buys__i_align" in params["params"]
        missing, unexpected = tm.load_state_dict(params_from_flax(params),
                                                 strict=False)
        assert not unexpected
        assert all("i__sim__i" in k for k in missing)   # no edges: no conv
        ws = {t: np.random.default_rng(4).normal(size=(v.shape[0], 4))
              .astype(np.float32) for t, v in x.items()}

        def jf(p):
            out = jm.apply(p, *jargs)
            return sum((out[t] * ws[t]).sum() for t in out), out

        (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
        out = tm({k: torch.from_numpy(v) for k, v in x.items()},
                 {k: torch.from_numpy(v) for k, v in ei.items()},
                 {k: torch.from_numpy(v) for k, v in mask.items()})
        assert sorted(out) == sorted(jout)
        sum((out[t] * torch.from_numpy(ws[t])).sum() for t in out).backward()
        for t in out:
            _close(out[t].detach(), jout[t], f"{conv} {t}")
        _grads_close(tm, jg)


@pytest.mark.parametrize("arch", ["rgat", "hgt"])
def test_scanned_hetero_block_matches_jax(arch):
    """One [3, 8] block whose last batch is fully padded, through both
    scanned steps, then a second full block: losses, accuracies, the
    step counter and the final parameters."""
    jds, _, classes = jax_datasets.synthetic_igbh(scale=0.01)
    tds, train_idx, _ = tdatasets.synthetic_igbh(scale=0.01, device="cpu")
    ets = [reverse_edge_type(et) for et in tds.get_edge_types()]
    widths = {t: tds.get_node_feature(t).shape[1]
              for t in tds.get_node_types()}
    fan = [3, 2]
    js = jhns.HeteroNeighborSampler(jds.graph, fan, "paper", batch_size=BS)
    ts = HeteroNeighborSampler(tds.graph, fan, "paper", batch_size=BS)
    if arch == "rgat":
        jm = jrgat.RGAT(edge_types=ets, hidden_features=8,
                        out_features=classes, target_type="paper",
                        conv="gat", dropout_rate=0.0)
        tm = RGAT(ets, widths, 8, classes, "paper", conv="gat",
                  dropout_rate=0.0)
        lr = 5e-3
    else:
        jm = JaxHGT(edge_types=ets, hidden_features=8, out_features=classes,
                    target_type="paper", heads=2, dropout_rate=0.0)
        tm = HGT(ets, widths, 8, classes, "paper", heads=2, dropout_rate=0.0)
        lr = 1e-3
    jfeats = {t: jds.get_node_feature(t) for t in jds.get_node_types()}
    tfeats = {t: tds.get_node_feature(t) for t in tds.get_node_types()}
    labels = {"paper": tds.get_node_label("paper")}
    tx = optax.adam(lr, eps=ADAM_EPS)
    # init_hetero_state's parameters, initialised under jit.
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)},
                              *jtrain.hetero_init_shapes(
                                  js, jfeats, lambda f: f.hot_rows))
    jstate = jtrain.TrainState(params, tx.init(params),
                               jnp.zeros((), jnp.int32))
    tm.load_state_dict(params_from_flax(jstate.params), strict=False)
    state = init_hetero_state(tm, lambda ps: torch.optim.Adam(
        list(ps), lr=lr, eps=ADAM_EPS), ts, tfeats)
    jstep = jtrain.make_scanned_hetero_train_step(jm, tx, js, jfeats,
                                                  labels, BS)
    tstep = make_scanned_hetero_train_step(ts, tfeats, labels, BS)
    blk = np.full((3, BS), -1, np.int64)
    blk.reshape(-1)[:13] = np.random.default_rng(8).permutation(
        train_idx)[:13]
    blocks = [blk, next(node_seed_blocks(train_idx, BS, 3,
                                         np.random.default_rng(9)))]
    for i, b in enumerate(blocks):
        jstate, jl, ja = jstep(jstate, b, jax.random.PRNGKey(20 + i))
        state, tl, ta = tstep(state, b, trandom.PRNGKey(20 + i,
                                                        device="cpu"))
        _close(tl, jl, f"losses {i}")
        _close(ta, ja, f"accs {i}")
    assert float(tl[0]) > 0 and list(blocks[0][2]) == [-1] * BS
    assert state.step == int(jstate.step) == 5
    got = tm.state_dict()
    for k, v in params_from_flax(jstate.params).items():
        _close(got[k], v, k)
    with pytest.raises(TypeError, match="host array"):
        tstep(state, torch.from_numpy(blk), trandom.PRNGKey(0, device="cpu"))
    with pytest.raises(ValueError, match="widths"):
        init_hetero_state(RGAT(ets, {"paper": 3}, 8, classes, "paper"),
                          adam(lr), ts, tfeats)


# glt_tpu's examples/train_hgt_mag.py at --scale 1 --epochs 2 (scanned
# route, CPU): mean training accuracy 0.2702 in epoch 0 and 0.5879 in
# epoch 1.  The twin's weights come from another generator and its
# dropout from other bits; over numpy init seeds 0-2 its epoch-1 mean
# reached 0.40-0.58.  The floor is 0.6 x glt_tpu's epoch 1, 2.8 x chance
# (8 classes).
HGT_EPOCH1_ACC_FLOOR = 0.35


def test_hgt_twin_clears_accuracy_floor():
    _, epochs = thgt.main(["--device", "cpu", "--epochs", "2"])
    losses, accs = epochs[1]
    assert losses.shape == (24,) and np.isfinite(losses).all()
    assert epochs[1][0].mean() < epochs[0][0].mean()
    assert accs.mean() >= HGT_EPOCH1_ACC_FLOOR, accs.mean()


def test_twins_loader_route_and_refusals():
    _, epochs = trgat.main(["--device", "cpu", "--epochs", "1", "--group",
                            "0", "--scale", "0.2"])
    assert np.isfinite(epochs[0][0]).all() and epochs[0][0].shape == (4,)
    _, epochs = thgt.main(["--device", "cpu", "--epochs", "1", "--group",
                           "0", "--scale", "0.2", "--hidden", "16",
                           "--no-last-hop-dedup"])
    assert np.isfinite(epochs[0][0]).all() and epochs[0][0].shape == (5,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trgat.main(["--device", "cpu", "--use-real"])
    _, epochs = trgat.main(["--device", "cpu", "--distributed", "2",
                            "--epochs", "1", "--scale", "0.2"])
    assert np.isfinite(epochs[0][0]).all() and epochs[0][0].shape == (1,)
