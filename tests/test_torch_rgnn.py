"""The published R-GAT (``glt_tpu_torch.models.RGNN``), the hetero
sampler's calibrated widths and the scanned hetero step, held on the
CPU to the benchmark's plain float32 reference (``portbench/reference``:
``rgnn.py``, ``hetero_sampling.py``) on a small IGBH-shaped graph, the
planted faults of ``portbench/faults_hetero.py`` each failing the
comparison."""
import numpy as np
import pytest
import torch

from glt_tpu_torch import obs
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.models import (RGNN, HeteroConv, adam, create_train_state,
                                  make_scanned_hetero_train_step,
                                  run_scanned_epoch, seed_cross_entropy)
from glt_tpu_torch.obs import stages
from glt_tpu_torch.sampler import (HeteroNeighborSampler,
                                   calibrate_frontier_widths)
from glt_tpu_torch.sampler.base import NodeSamplerInput

from portbench import check, faults_hetero, gen_hetero
from portbench.reference import hetero_sampling as ref_sampling
from portbench.reference import rgnn as ref_rgnn
from portbench.reference import threefry

CPU = torch.device("cpu")
LAW = {"kind": "pareto", "alpha": 1.8, "dmax": 200}
#: IGBH's four node types and seven sampled relations, small.
GRAPH = {
    "node_types": {"paper": 400, "author": 420, "institute": 12, "fos": 60},
    "feature_dim": 32, "feature_dtype": "float32", "num_classes": 6,
    "target_type": "paper", "train_share": 0.6,
    "relations": [
        {"edge_type": ["paper", "cites", "paper"], "num_edges": 4000,
         "degree_law": LAW},
        {"edge_type": ["paper", "written_by", "author"], "num_edges": 1100,
         "degree_law": LAW},
        {"edge_type": ["author", "affiliated_to", "institute"],
         "num_edges": 80, "degree_law": LAW},
        {"edge_type": ["paper", "topic", "fos"], "num_edges": 1600,
         "degree_law": LAW}],
    "reverse": ["written_by", "affiliated_to", "topic"]}
MODEL = {"hidden": 16, "heads": 4, "num_layers": 3, "dropout": 0.2,
         "dropout_seed": 3, "lr": 1e-3}
FANOUT = [4, 3, 2]
BS = 16


def igbh_small(seed=1):
    gd = gen_hetero.make_hetero(GRAPH, seed, CPU)
    graphs = {et: Graph(CSRTopo.from_csr_arrays(ip, ix), device=CPU)
              for et, (ip, ix) in gd.csr.items()}
    return gd, graphs


def calibrated(gd, graphs, margin=1.05):
    probe = HeteroNeighborSampler(graphs, FANOUT, "paper", batch_size=BS)
    rng = np.random.default_rng(0)
    cal = [rng.choice(gd.train_idx, BS, replace=False) for _ in range(8)]
    widths = calibrate_frontier_widths(probe, cal, margin=margin, multiple=8)
    return HeteroNeighborSampler(graphs, FANOUT, "paper", batch_size=BS,
                                 frontier_widths=widths)


def relations(gd):
    return [ref_sampling.reverse(et) for et in sorted(gd.csr)]


def model_of(gd, seed=0):
    torch.manual_seed(seed)
    model = RGNN(relations(gd), GRAPH["feature_dim"], MODEL["hidden"],
                 GRAPH["num_classes"], "paper",
                 num_layers=MODEL["num_layers"], heads=MODEL["heads"],
                 dropout_rate=MODEL["dropout"])
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.5, 0.5)
    return model


def csr_tensors(gd):
    return {et: (torch.from_numpy(ip).long(), torch.from_numpy(ix))
            for et, (ip, ix) in gd.csr.items()}


def ref_batch(gd, sampler, seeds, key, step):
    ref = ref_sampling.sample(csr_tensors(gd), torch.from_numpy(seeds),
                              "paper", {et: FANOUT for et in gd.csr},
                              sampler.hop_widths, key)
    return ref, {"nodes": ref_sampling.kept_nodes(ref),
                 "edges": ref_sampling.edges(ref),
                 "y": gd.labels[torch.from_numpy(seeds).long()],
                 "step": step}


def program_inputs(gd, out):
    x = {t: torch.where((node >= 0)[:, None],
                        gd.tables[t][node.clamp(min=0).long()], 0)
         for t, node in out.node.items()}
    ei = {et: torch.stack([out.row[et], out.col[et]]) for et in out.row}
    return x, ei


def one_step(gd, model, out, step):
    """The program's forward, loss, gradients and one Adam step."""
    x, ei = program_inputs(gd, out)
    key = trandom.fold_in(trandom.PRNGKey(MODEL["dropout_seed"],
                                          device="cpu"), step)
    logits = model(x, ei, out.edge_mask, dropout_key=key)
    y = torch.where(out.node["paper"] >= 0,
                    gd.labels[out.node["paper"].clamp(min=0).long()], -1)
    loss, _ = seed_cross_entropy(logits, y, BS, out.node_mask["paper"])
    opt = adam(MODEL["lr"])(model.parameters())
    opt.zero_grad()
    loss.backward()
    # A last-layer relation into a type the head does not read has no
    # gradient, and Adam leaves it.
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    opt.step()
    return logits, loss, grads


def setup_one(fault=None):
    gd, graphs = igbh_small()
    s = calibrated(gd, graphs)
    seeds = gd.train_idx[:BS].copy()
    key = trandom.PRNGKey(11, device="cpu")
    out = s.sample_from_nodes(NodeSamplerInput(seeds), key=key)
    model = model_of(gd)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    if fault is None:
        logits, loss, grads = one_step(gd, model, out, 0)
    else:
        with faults_hetero.planted(fault):
            logits, loss, grads = one_step(gd, model, out, 0)
    prog = {"first_grad": grads,
            "params": {n: p.detach() for n, p in model.named_parameters()}}
    _, batch = ref_batch(gd, s, seeds, key, 0)
    ref = ref_rgnn.train(params0, [batch], gd.tables, relations(gd), MODEL,
                         "paper")
    return gd, batch, logits, loss, prog, ref, params0


def test_rgnn_matches_the_reference_within_f32_round_off():
    gd, batch, logits, loss, prog, ref, params0 = setup_one()
    keys = ref_rgnn.dropout_keys(0, MODEL["dropout_seed"], 3, CPU)
    x = {t: gd.tables[t][ids] for t, ids in batch["nodes"].items()}
    want = ref_rgnn.forward(params0, x, batch["edges"], relations(gd), MODEL,
                            "paper", keys)
    torch.testing.assert_close(logits[: want.shape[0]], want, rtol=1e-4,
                               atol=1e-5)
    assert abs(float(loss.detach()) - ref["losses"][0]) < 1e-5
    nums = check.train_numbers(prog, ref, params0)
    assert nums["grad_gap"] < 1e-5 and nums["grad_diff"] < 1e-5, nums
    assert nums["change_gap"] < 1e-3 and nums["change_diff"] < 5e-3, nums
    # Dropout reaches every hidden layer: without it the logits move.
    other = ref_rgnn.forward(params0, x, batch["edges"], relations(gd),
                             MODEL, "paper", None)
    assert not torch.allclose(other, want, atol=1e-3)


@pytest.mark.parametrize("fault", ["relation_dropped", "source_softmax"])
def test_a_planted_model_fault_fails_the_comparison(fault):
    _, _, _, _, prog, ref, params0 = setup_one(fault)
    nums = check.train_numbers(prog, ref, params0)
    assert nums["grad_diff"] > 0.05, nums


def test_heteroconv_concat_is_pygs_bipartite_gat():
    """``concat=True``: the heads concatenated to ``out_features``, each
    relation on its bipartite pair; the default keeps its joint form."""
    ets = [("a", "r", "b"), ("b", "r2", "b")]
    conv = HeteroConv(ets, {"a": 6, "b": 6}, 8, conv="gat", heads=4,
                      concat=True)
    assert conv.convs["a__r__b"].out_features == 2
    x = {"a": torch.randn(5, 6), "b": torch.randn(7, 6)}
    ei = {ets[0]: torch.tensor([[0, 4, -1], [1, 1, -1]]),
          ets[1]: torch.tensor([[2, 3], [0, 0]])}
    mask = {et: ei[et][0] >= 0 for et in ets}
    out = conv(x, ei, mask)
    assert set(out) == {"b"} and out["b"].shape == (7, 8)
    c = conv.convs["a__r__b"]
    z_a, z_b = c.project(x["a"]), c.project(x["b"])
    want = c.attend(z_a, z_b, ei[ets[0]], mask[ets[0]])
    c2 = conv.convs["b__r2__b"]
    zz = c2.project(x["b"])
    want = want + c2.attend(zz, zz, ei[ets[1]], mask[ets[1]])
    torch.testing.assert_close(out["b"], want)
    with pytest.raises(ValueError, match="widths"):
        HeteroConv(ets, {"a": 4, "b": 6}, 8, conv="gat", heads=4,
                   concat=True)
    assert not HeteroConv(ets, {"a": 6, "b": 6}, 8, conv="gat").concat


@pytest.mark.parametrize("padded", [False, True])
def test_calibrated_sampler_matches_the_reference_exactly(padded):
    gd, graphs = igbh_small()
    s = calibrated(gd, graphs)
    assert s.capped and sum(s.node_capacity.values()) < sum(
        HeteroNeighborSampler(graphs, FANOUT, "paper",
                              batch_size=BS).node_capacity.values())
    for j in range(4):
        seeds = gd.train_idx[BS * j: BS * j + BS].copy()
        if padded:
            seeds[11:] = -1
        key = threefry.fold_in(threefry.prng_key(9), j)
        out = s.sample_from_nodes(NodeSamplerInput(seeds), key=key)
        ref, _ = ref_batch(gd, s, seeds, key, j)
        ovf = bool(out.metadata["overflow"])
        assert ovf == ref.overflow
        assert ref_sampling.compare(ref, out, ovf) == {"bad_nodes": 0,
                                                       "bad_edges": 0}


def test_a_forced_width_cut_flags_overflow_and_counts_it():
    gd, graphs = igbh_small()
    full = calibrated(gd, graphs)
    # Half of every calibrated width: levels overflow, nodes are dropped
    # from the buffers and frontiers cut.
    widths = [{t: w // 2 for t, w in level.items()}
              for level in full.hop_widths[1:]]
    s = HeteroNeighborSampler(graphs, FANOUT, "paper", batch_size=BS,
                              frontier_widths=widths)
    seeds = gd.train_idx[:BS].copy()
    key = threefry.prng_key(21)
    tracer = obs.start_trace()
    try:
        stages.reset()
        out = s.sample_from_nodes(NodeSamplerInput(seeds), key=key)
        counters = stages.counter_values()
    finally:
        obs.install(None)
        del tracer
    ref, _ = ref_batch(gd, s, seeds, key, 0)
    assert ref.overflow and bool(out.metadata["overflow"])
    assert any(ref.nodes[t].shape[0] > ref.cap[t] for t in ref.nodes)
    assert ref_sampling.compare(ref, out, True) == {"bad_nodes": 0,
                                                    "bad_edges": 0}
    over = {k: v for k, v in counters.items()
            if k.startswith("glt.sample.overflow{")}
    assert sum(over.values()) >= 1 and set(over) == {
        f"glt.sample.overflow{{node_type={t}}}" for t in s.node_types}
    assert counters["glt.sample.batches"] == 1.0
    assert counters["glt.sample.edges"] == float(
        sum(int(m.sum()) for m in out.edge_mask.values()))
    # The default (no widths) still samples the fanouts' worst case.
    assert not HeteroNeighborSampler(graphs, FANOUT, "paper",
                                     batch_size=BS).capped


def scanned(fault=None, blocks=2, group=2):
    """The scanned hetero step over the calibrated sampler, its first
    block one batch (the first gradient from Adam's moment), against
    the reference's steps on its own samples."""
    gd, graphs = igbh_small()
    s = calibrated(gd, graphs)
    model = model_of(gd)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, adam(MODEL["lr"]))
    step = make_scanned_hetero_train_step(
        s, gd.tables, {"paper": gd.labels}, BS,
        dropout_seed=MODEL["dropout_seed"])
    ids = gd.train_idx[: BS * (1 + group * (blocks - 1))].reshape(-1, BS)
    blks = [np.full((group, BS), -1, np.int64) for _ in range(blocks)]
    blks[0][0] = ids[0]
    for b in range(1, blocks):
        blks[b][:] = ids[1 + group * (b - 1): 1 + group * b]
    keys, first_grad, ovfs = [], None, []
    for b, blk in enumerate(blks):
        key = trandom.PRNGKey(40 + b, device="cpu")
        if fault is None:
            state, _, _, ovf = step(state, blk, key)
        else:
            with faults_hetero.planted(fault):
                state, _, _, ovf = step(state, blk, key)
        ovfs.append(ovf)
        real = int((blk >= 0).any(axis=1).sum())
        keys += list(trandom.split(key, group)[:real])
        if b == 0:
            st = state.optimizer.state
            first_grad = {n: st[p]["exp_avg"].clone() / 0.1
                          if "exp_avg" in st.get(p, {})
                          else torch.zeros_like(p)
                          for n, p in model.named_parameters()}
    prog = {"first_grad": first_grad,
            "params": {n: p.detach() for n, p in model.named_parameters()}}
    batches = [ref_batch(gd, s, ids[j], keys[j], j)[1]
               for j in range(ids.shape[0])]
    ref = ref_rgnn.train(params0, batches, gd.tables, relations(gd), MODEL,
                         "paper")
    return check.train_numbers(prog, ref, params0), torch.cat(ovfs), state


def test_scanned_hetero_step_matches_the_reference_steps():
    nums, ovfs, state = scanned()
    assert state.step == 3 and ovfs.dtype == torch.int32
    assert nums["grad_gap"] < 1e-5 and nums["grad_diff"] < 1e-5, nums
    assert nums["change_gap"] < 1e-3 and nums["change_diff"] < 5e-3, nums


@pytest.mark.parametrize("fault", ["frozen_dropout", "block_key"])
def test_a_planted_step_fault_fails_the_comparison(fault):
    nums, _, _ = scanned(fault)
    assert nums["change_diff"] > 0.05, nums


def test_run_scanned_epoch_counts_the_hetero_flags():
    gd, graphs = igbh_small()
    full = calibrated(gd, graphs)
    s = HeteroNeighborSampler(
        graphs, FANOUT, "paper", batch_size=BS,
        frontier_widths=[{t: w // 2 for t, w in level.items()}
                         for level in full.hop_widths[1:]])
    model = model_of(gd)
    state = create_train_state(model, adam(MODEL["lr"]))
    step = make_scanned_hetero_train_step(s, gd.tables, {"paper": gd.labels},
                                          BS)
    train = gd.train_idx[: BS * 3 + 5]
    state, losses, _, ovf = run_scanned_epoch(
        step, state, train, BS, 2, np.random.default_rng(0),
        trandom.PRNGKey(1, device="cpu"))
    assert losses.shape == (4,) and 1 <= ovf <= 4 and state.step == 4


def test_lean_attention_over_16_bit_rows_keeps_the_values():
    """A 16-bit ``GATConv`` keeps its projected rows in bf16 for the
    backward: the forward is the float32 expressions' over those rows
    bit for bit, the gradients theirs within bf16 rounding."""
    from glt_tpu_torch.models import GATConv
    from glt_tpu_torch.models.conv import scatter_sum, segment_softmax

    torch.manual_seed(0)
    conv = GATConv(12, 4, heads=2, concat=True, dtype=torch.bfloat16)
    x = torch.randn(9, 12)
    ei = torch.tensor([[0, 3, 3, 8, 5, -1], [1, 1, 2, 2, 0, -1]])
    mask = ei[0] >= 0
    w = torch.randn(9, 8)
    src, dst = ei[0].clamp(0, 8), ei[1].clamp(0, 8)

    def f32_copy():
        z = torch.nn.functional.linear(
            x.bfloat16(), conv.lin.weight.bfloat16()).float().reshape(9, 2, 4)
        e = torch.nn.functional.leaky_relu(
            (z * conv.att_src).sum(-1)[src] + (z * conv.att_dst).sum(-1)[dst],
            0.2)
        alpha = segment_softmax(e, ei[1], 9, mask)
        msgs = (z[src] * alpha[:, :, None]).reshape(-1, 8)
        return scatter_sum(msgs, ei[1], 9, mask) + conv.bias

    def run(fn):
        conv.zero_grad()
        out = fn()
        (out * w).sum().backward()
        return out, {n: p.grad.clone() for n, p in conv.named_parameters()}

    z = conv.project(x)
    assert z.dtype == torch.bfloat16
    out16, g16 = run(lambda: conv(x, ei, mask))
    out32, g32 = run(f32_copy)
    assert torch.equal(out16, out32)
    for n in g32:
        torch.testing.assert_close(g16[n], g32[n], rtol=2e-2, atol=2e-2)