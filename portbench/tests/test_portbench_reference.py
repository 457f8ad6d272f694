"""The reference agrees with the program's plain CPU path at a tiny size,
and the sampling check passes the program's batches and fails altered
ones, a draw that ignores the key among them."""
import pytest
import torch

from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.sampler.base import NodeSamplerInput

from portbench import faults, gen
from portbench.reference import sage, sampling, threefry
from portbench.reference.sampling import check_gather

CPU = torch.device("cpu")
CFG = {"num_nodes": 400, "num_edges": 4000, "feature_dim": 6,
       "num_classes": 4, "train_nodes": 64,
       "degree_law": {"kind": "pareto", "alpha": 1.8, "dmax": 100}}
FANOUTS = [4, 3]


def graph_and_sample(seed=3):
    gd = gen.make_graph(CFG, seed, CPU)
    topo = CSRTopo.from_csr_arrays(gd.indptr, gd.indices)
    s = NeighborSampler(Graph(topo, device=CPU), FANOUTS, batch_size=16,
                        with_edge=False)
    seeds = gd.train_idx[:16]
    out = s.sample_from_nodes(NodeSamplerInput(seeds),
                              key=threefry.prng_key(5))
    return gd, seeds, out


def judge(gd, seeds, out, key=None, fanouts=FANOUTS, batch=16):
    key = threefry.prng_key(5) if key is None else key
    ref = sampling.sample(torch.from_numpy(gd.indptr).long(),
                          torch.from_numpy(gd.indices),
                          torch.from_numpy(seeds), fanouts, key)
    ovf = bool(out.metadata["overflow"]) if out.metadata else None
    return sampling.compare_sample(ref, batch, fanouts, out.node, out.row,
                                   out.col, out.edge_mask, out.node_mask,
                                   out.num_sampled_nodes, ovf)


def test_threefry_matches_the_program():
    key = threefry.fold_in(threefry.prng_key(0), 7)
    assert torch.equal(key, trandom.fold_in(trandom.PRNGKey(0, device=CPU), 7))
    assert torch.equal(threefry.split(key, 3), trandom.split(key, 3))
    mask = threefry.bernoulli_rows(key, 0.5, 5, 16, chunk=32)
    assert torch.equal(mask, trandom.bernoulli(key, 0.5, (9, 16))[:5])
    span = torch.tensor([1, 2, 3, 7, 50, 1000, 65535, 65536, 70001, 2 ** 30])
    want = trandom.randint(key, (span.shape[0],), 0, span, plain=True)
    assert torch.equal(threefry.randint(key, span), want.long())


WIDE = {"num_nodes": 5000, "num_edges": 100000, "feature_dim": 6,
        "num_classes": 4, "train_nodes": 64,
        "degree_law": {"kind": "pareto", "alpha": 1.8, "dmax": 100}}


@pytest.mark.parametrize("fanouts,cap,padded", [
    ([4, 3], None, False), ([15, 10, 5], None, True),
    ([5, 4, 3], 500, False), ([5, 4, 3], 900, True)])
def test_reference_sample_is_the_programs(fanouts, cap, padded):
    gd = gen.make_graph(WIDE, 3, CPU)
    topo = CSRTopo.from_csr_arrays(gd.indptr, gd.indices)
    s = NeighborSampler(Graph(topo, device=CPU), fanouts, batch_size=16,
                        with_edge=False, node_capacity=cap)
    flags = []
    for j in range(3):
        seeds = gd.train_idx[16 * j: 16 * j + 16].copy()
        if padded:
            seeds[12:] = -1
        key = threefry.fold_in(threefry.prng_key(9), j)
        out = s.sample_from_nodes(NodeSamplerInput(seeds), key=key)
        flags.append(bool(out.metadata["overflow"]) if out.metadata
                      else False)
        assert judge(gd, seeds, out, key, fanouts) == {"bad_nodes": 0,
                                                       "bad_edges": 0}
    if cap == 500:
        assert all(flags)


def test_sage_matches_the_program_in_f32():
    gd, seeds, out = graph_and_sample()
    torch.manual_seed(0)
    model = GraphSAGE(6, 8, 4, num_layers=2, dropout_rate=0.5)
    params = dict(model.named_parameters())
    count = int(out.node_mask.sum())
    node = out.node[:count].long()
    valid = out.edge_mask.bool()
    x = gd.table[node]
    src, dst = out.row[valid].long(), out.col[valid].long()
    step_key = trandom.fold_in(trandom.PRNGKey(0, device=CPU), 2)
    want = model(x, torch.stack([src, dst]), torch.ones_like(src, dtype=torch.bool),
                 dropout_key=step_key)
    masks = sage.dropout_masks(2, 0, count, 8, 2, 0.5, CPU)
    got = sage.forward(params, x, src, dst, 2, masks, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sampling_check_fails_altered_batches():
    gd, seeds, out = graph_and_sample()
    assert judge(gd, seeds, out) == {"bad_nodes": 0, "bad_edges": 0}
    e = int(torch.nonzero(out.edge_mask)[-1])
    for name in ("row", "col", "edge_mask"):
        keep = getattr(out, name)
        bad = keep.clone()
        bad[e] = (~bad[e]) if name == "edge_mask" else (bad[e] + 1)
        setattr(out, name, bad)
        assert judge(gd, seeds, out)["bad_edges"] > 0, name
        setattr(out, name, keep)
    node = out.node.clone()
    node[3] = node[4]
    out.node = node
    assert judge(gd, seeds, out)["bad_nodes"] > 0
    with faults.planted("first_f"):
        gd, seeds, out = graph_and_sample()
    bad = judge(gd, seeds, out)
    assert bad["bad_edges"] > 0 and bad["bad_nodes"] > 0


def test_gather_check():
    gd, seeds, out = graph_and_sample()
    count = int(out.node_mask.sum())
    x = torch.zeros((out.node.shape[0], 6))
    x[:count] = gd.table[out.node[:count].long()]
    y = torch.full((out.node.shape[0],), -1, dtype=torch.int32)
    y[:count] = gd.labels[out.node[:count].long()]
    assert check_gather(gd.table, gd.labels, out.node, out.node_mask, x, y) \
        == {"x_max_diff": 0.0, "bad_labels": 0}
    x[1, 2] += 1e-6
    assert check_gather(gd.table, gd.labels, out.node, out.node_mask, x,
                        y)["x_max_diff"] > 0
