"""The generator: the same seed gives the same arrays, at exactly the N
and E asked for, and the roofline counts agree with hand counts."""
import numpy as np
import torch

from portbench import gen, roofline, traffic

CFG = {"num_nodes": 500, "num_edges": 7000, "feature_dim": 4,
       "num_classes": 3, "train_nodes": 100,
       "degree_law": {"kind": "pareto", "alpha": 1.8, "dmax": 200}}


def test_same_seed_same_arrays_exact_sizes():
    cpu = torch.device("cpu")
    a = gen.make_graph(CFG, 2 ** 33 + 7, cpu)
    b = gen.make_graph(CFG, 2 ** 33 + 7, cpu)
    c = gen.make_graph(CFG, 11, cpu)
    assert a.indptr[-1] == 7000 and a.indptr.shape == (501,)
    assert a.indices.shape == (7000,) and a.table.shape == (500, 4)
    deg = np.diff(a.indptr)
    assert deg.min() >= 1 and deg.max() <= 200
    assert 0 <= a.indices.min() and a.indices.max() < 500
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert torch.equal(a.table, b.table) and torch.equal(a.labels, b.labels)
    assert np.array_equal(a.train_idx, b.train_idx)
    assert len(set(a.train_idx.tolist())) == 100
    assert not np.array_equal(a.indices, c.indices)


def test_degree_law_mean_is_exact():
    g = gen.generator(5, torch.device("cpu"))
    deg = gen.powerlaw_degrees(1000, 50_520, CFG["degree_law"], g,
                               torch.device("cpu"))
    assert int(deg.sum()) == 50_520 and int(deg.min()) >= 1


def test_seed_streams_and_blocks():
    s = traffic.sub_seeds(2 ** 40)
    assert len(set(s.values())) == len(s)
    ids = np.arange(20)
    mix = {"batch_size": 4, "group": 2}
    blocks = [b for _, (_, b) in zip(range(3), traffic.blocks(ids, mix, 9))]
    seen = np.concatenate([b.ravel() for b in blocks])
    assert sorted(seen[seen >= 0].tolist()) == list(range(20))
    assert (blocks[2] == -1).sum() == 4      # 20 seeds in blocks of 8


def test_roofline_hand_counts():
    # Two frontier rows, 7 neighbours read, one row drawing fanout 5.
    w = roofline.hop_work(2, 7, 1, 5)
    assert w["bytes"] == 2 * 12 + 7 * 4 + 2 * 5 * 5
    assert w["ops"] == 5 * 2 * 75
    f = roofline.frontier_work(10, 6, 4)
    assert f["bytes"] == 10 * 4 + 6 * 16 + 10 * 16
    # 2 layers, dims 3 -> 4 -> 2; levels (1, 2, 5); edges (2, 6).
    # Layer 1 serves levels 0-1 (3 nodes) over hops 0-1 (8 edges);
    # layer 2 the seed (1 node) over hop 0 (2 edges).
    l1 = 4 * 3 * 3 * 4
    l2 = 4 * 1 * 4 * 2
    want = (l1 + 8 * 3) + l1 + (l2 + 2 * 4) + l2 + (l2 + 2 * 4)
    assert roofline.sage_flops([1, 2, 5], [2, 6], [3, 4, 2]) == want
    assert roofline.bound_s({"bytes": 3.35e12, "ops": 0.0}) == 1.0
