"""The port's CUDA kernels against their plain PyTorch versions.

The ``cuda`` cases need the card (a CUDA kernel has no CPU mode) and
skip without one; on the card run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest configures jax, which the card's
machine need not have; this file imports torch and the port only).  The
CPU cases check the seam: CPU tensors take the plain versions and never
reach a kernel wrapper, which refuses them.
"""
import numpy as np
import pytest
import torch

from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Dataset, Graph
from glt_tpu_torch.data.topology import csr_to_coo
from glt_tpu_torch.models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_scanned_node_train_step,
    node_seed_blocks,
)
from glt_tpu_torch.data import Feature
from glt_tpu_torch.ops import (
    dedup_gather_rows,
    edge_in_csr,
    edge_in_csr_plain,
    frontier_plan,
    fused_frontier,
    fused_frontier_cuda,
    fused_frontier_dequant_cuda,
    fused_frontier_dequant_plain,
    fused_frontier_plain,
    gather_cuda,
    gather_rows_dequant_cuda,
    gather_rows_dequant_plain,
    sample_cuda,
    threefry_cuda,
)
from glt_tpu_torch.sampler import (
    EdgeSamplerInput,
    NegativeSampling,
    NeighborSampler,
    NodeSamplerInput,
)
from glt_tpu_torch.serving import ServingOptions, SubgraphEngine
from glt_tpu_torch.store import DiskFeatureStore, quant, write_feature_store
from glt_tpu_torch.utils.device import resolve_device
from glt_tpu_torch.utils.graphs import CapturedProgram, GraphCaptureError

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _graph(seed=1, n=512):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 30, n)
    deg[:4] = [0, 3, 900, 1]
    deg[-1] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1])) + 7
    seeds = np.concatenate([[0, 1, 2, 3, n - 1, -1, 2, 2],
                            rng.integers(0, n, 100), np.full(5, -1)])
    return indptr, indices, edge_ids, seeds.astype(np.int32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


def _degree_edge_graph(fanout, seed=1, n=512):
    """``_graph`` with rows of degree F - 1, F and F + 1 (Floyd's branch
    edges) and seeds past the last row."""
    rng = np.random.default_rng(seed + fanout)
    deg = rng.integers(0, 30, n)
    special = [0, 3, 900, 1, max(fanout - 1, 0), fanout, fanout + 1]
    deg[:len(special)] = special
    deg[-1] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1])) + 7
    seeds = np.concatenate([np.arange(len(special)), [n - 1, -1, 2, 2, n,
                                                      n + 9],
                            rng.integers(-1, n, 100)])
    return indptr, indices, edge_ids, seeds.astype(np.int32)


# -- on the card -------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [1, 5, 15, 32, 33, 40])
@pytest.mark.parametrize("eid_mode", ["none", "positional", "explicit"])
@pytest.mark.parametrize("key_by", ["slot", "id"])
@pytest.mark.parametrize("with_replacement", [False, True])
def test_sample_kernel_matches_plain(cuda_device, fanout, eid_mode, key_by,
                                     with_replacement):
    """B1 (draw and read in one launch) is ``torch.equal`` to its plain
    version: deg 0, deg < F, deg == F, F + 1, a hub, padding, seeds past
    the last row, an all-padding and an empty batch."""
    indptr, indices, edge_ids, seeds = _degree_edge_graph(fanout)
    ip, ix = _t(indptr, cuda_device), _t(indices, cuda_device)
    eid = _t(edge_ids, cuda_device) if eid_mode == "explicit" else None
    with_edge = eid_mode != "none"
    key = trandom.PRNGKey(fanout, device=cuda_device)
    for sd in (seeds, np.full(33, -1), seeds[:0]):
        sd = _t(sd, cuda_device)
        kw = dict(edge_ids=eid, with_replacement=with_replacement,
                  with_edge=with_edge, key_by=key_by)
        before = sample_cuda.sample_neighbors_cuda.launches
        got = sample_cuda.sample_neighbors_cuda(ip, ix, sd, fanout, key, **kw)
        want = sample_cuda.sample_neighbors_plain(ip, ix, sd, fanout, key,
                                                  **kw)
        torch.cuda.synchronize()
        assert sample_cuda.sample_neighbors_cuda.launches == before + 1
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)
        assert (got.eids is None) == (not with_edge)


@pytest.mark.cuda
def test_sample_kernel_all_padding(cuda_device):
    indptr, indices, _, _ = _graph()
    ip, ix = _t(indptr, cuda_device), _t(indices, cuda_device)
    sd = _t(np.full(33, -1), cuda_device)
    out = sample_cuda.sample_neighbors_cuda(
        ip, ix, sd, 7, trandom.PRNGKey(0, device=cuda_device))
    torch.cuda.synchronize()
    assert (out.nbrs == -1).all() and (out.eids == -1).all()
    assert not out.mask.any()


@pytest.mark.cuda
@pytest.mark.parametrize("keys", [1, 3, 300])
def test_threefry_hash_kernel_matches_plain(cuda_device, keys):
    """The hash kernel equals its plain version for split (the iota),
    fold_in (a tensor, int32 and int64, and a Python int by value) and,
    through them, randint; ``random.split``/``fold_in`` on a CUDA key
    launch it once."""
    rng = np.random.default_rng(keys)
    words = rng.integers(0, 2**32, (keys, 2))
    kc = torch.from_numpy(words).to(cuda_device)
    kp = torch.from_numpy(words)
    for kw in (dict(n=1), dict(n=7), dict(n=1000), dict(data=0),
               dict(data=2**31 + 5), dict(data=-1)):
        got = threefry_cuda.threefry_hash_cuda(kc, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), threefry_cuda.threefry_hash_plain(
            kp, **kw))
    for dt in (torch.int32, torch.int64):
        data = torch.from_numpy(rng.integers(-2**31, 2**31, 77)).to(dt)
        got = threefry_cuda.threefry_hash_cuda(kc, data=data.to(cuda_device))
        assert torch.equal(got.cpu(),
                           threefry_cuda.threefry_hash_plain(kp, data=data))
    before = threefry_cuda.threefry_hash_cuda.launches
    assert torch.equal(trandom.split(kc, (2, 3)).cpu(),
                       trandom.split(kp, (2, 3)))
    assert torch.equal(trandom.fold_in(kc, 12).cpu(),
                       trandom.fold_in(kp, 12))
    assert threefry_cuda.threefry_hash_cuda.launches == before + 2
    bound = torch.from_numpy(rng.integers(1, 2**31 - 1, (keys, 5)))
    assert torch.equal(
        trandom.randint(kc, (5,), 0, bound.to(cuda_device)).cpu(),
        trandom.randint(kp, (5,), 0, bound))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("d", [1, 3, 64, 100, 128, 256])
@pytest.mark.parametrize("b", [1, 57, 1000])
def test_gather_kernel_matches_plain(cuda_device, d, dtype, b):
    rng = np.random.default_rng(d + b)
    table = torch.from_numpy(rng.standard_normal((300, d)).astype(
        np.float32)).to(cuda_device).to(dtype)
    idx = _t(rng.integers(-2, 310, b), cuda_device)
    for tab in (table, table[1:]):     # the view's base is not 16B-aligned
        got = gather_cuda.gather_rows_cuda(tab, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_cuda.gather_rows_plain(tab, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", ["dense", "sort"])
@pytest.mark.parametrize("last_hop_dedup", [True, False])
def test_sampler_on_card_equals_cpu(cuda_device, dedup, last_hop_dedup):
    """Every SamplerOutput field of the card run equals the CPU run: the
    scatters keep the dump-slot discipline, so CUDA adds no
    nondeterminism."""
    indptr, indices, edge_ids, seeds = _graph(3, 4000)
    outs = []
    for dev in (cuda_device, "cpu"):
        g = Graph(CSRTopo.from_csr_arrays(indptr, indices, edge_ids),
                  device=dev)
        s = NeighborSampler(g, [15, 10, 5], batch_size=128, seed=5,
                            dedup=dedup, last_hop_dedup=last_hop_dedup)
        outs.append([s.sample_from_nodes(NodeSamplerInput(seeds[i:i + 100]))
                     for i in (0, 7)])
    for a, b in zip(*outs):
        for f in ("node", "row", "col", "edge", "batch", "node_mask",
                  "edge_mask", "num_sampled_nodes", "num_sampled_edges"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


def _serving_dataset(dev, n=3000):
    indptr, indices, _, _ = _graph(2, n)
    feat = np.random.default_rng(0).standard_normal((n, 100)).astype(
        np.float32)
    ds = Dataset(graph=Graph(CSRTopo.from_csr_arrays(indptr, indices),
                             device=dev), device=dev)
    ds.init_node_features(feat)
    ds.init_node_labels(np.arange(n) % 47)
    return ds


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(cuda_device):
    """The slice on a small graph: card and CPU engines give equal
    messages.  The card's first micro-batch of a bucket runs the device
    stage once eagerly (the warm-up) and once into its CUDA graph: B1
    twice per hop, B2 twice, the hash kernel for the call's fold_in and
    twice for the hop split; the second micro-batch replays the graph
    and launches only the fold_in."""
    msgs = []
    for dev in (cuda_device, "cpu"):
        eng = SubgraphEngine(_serving_dataset(dev),
                             ServingOptions(num_neighbors=(15, 10, 5)))
        for i, first in enumerate((5, 45)):
            b1 = sample_cuda.sample_neighbors_cuda.launches
            b2 = gather_cuda.gather_rows_cuda.launches
            h = threefry_cuda.threefry_hash_cuda.launches
            reqs = [eng.validate_seeds(np.arange(j, j + 20))
                    for j in (first, first + 10)]
            if dev == "cpu":
                msgs[i].append(eng.scatter(eng.sample(reqs)))
                continue
            msgs.append([eng.scatter(eng.sample(reqs))])
            captured = i == 0
            assert sample_cuda.sample_neighbors_cuda.launches == \
                b1 + 6 * captured
            assert gather_cuda.gather_rows_cuda.launches == \
                b2 + 2 * captured
            assert threefry_cuda.threefry_hash_cuda.launches == \
                h + 1 + 2 * captured
        if dev != "cpu":
            assert eng.compiled_buckets() == [128]
    for card, cpu in msgs:
        for a, b in zip(card, cpu):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_replayed_micro_batch_equals_eager(cuda_device):
    """After ``warmup()`` every bucket is a captured graph; a replayed
    micro-batch is ``torch.equal`` to the eager route (the sampler and
    the gather called directly) at the same key."""
    ds = _serving_dataset(cuda_device)
    eng = SubgraphEngine(ds, ServingOptions(num_neighbors=(15, 10, 5)))
    eng.warmup()
    assert eng.compiled_buckets() == [8, 32, 128]
    for n_seeds, bucket in ((3, 8), (30, 32), (90, 128)):
        seeds = eng.validate_seeds(np.arange(7, 7 + n_seeds) * 11 % 3000)
        s = eng._sampler(bucket)
        key = trandom.fold_in(s._base_key, s._call_count)
        coal = eng.sample([seeds])
        assert coal.bucket == bucket
        padded = np.full(bucket, -1, np.int32)
        padded[:n_seeds] = seeds
        out = s.sample_from_nodes(NodeSamplerInput(padded), key=key)
        want = (out.node, out.row, out.col, out.edge, out.edge_mask,
                ds.get_node_feature().gather(out.node))
        got = (coal.node, coal.row, coal.col, coal.edge, coal.edge_mask,
               coal.x)
        for w, g in zip(want, got):
            assert torch.equal(w.cpu(), torch.from_numpy(g))


def _frontier_ids(case, n, b, rng):
    if case == "ragged":
        ids = rng.integers(-1, n, b)
    elif case == "all_padding":
        ids = np.full(b, -1)
    elif case == "all_duplicates":
        ids = np.full(b, min(7, n - 1))
    elif case == "single_unique":
        ids = np.where(rng.random(b) < 0.3, -1, min(3, n - 1))
    else:                                   # past the table: rows clamp
        ids = rng.integers(0, n + 50, b)
    return ids.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "all_padding", "all_duplicates",
                                  "single_unique", "clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("d", [1, 3, 63, 64, 100, 128])
@pytest.mark.parametrize("n", [1, 300])
def test_fused_frontier_kernel_matches_plain(cuda_device, case, dtype, d, n):
    rng = np.random.default_rng(d + n)
    table = torch.from_numpy(rng.standard_normal((n + 1, d)).astype(
        np.float32)).to(cuda_device).to(dtype)
    for b in (1, 61, 1000):
        ids = _t(_frontier_ids(case, n, b, rng), cuda_device)
        _, inv, uidx = frontier_plan(ids)
        # table[1:] has n rows and a base that is not 16-byte aligned
        # for odd widths.
        for tab in (table[:n], table[1:]):
            before = fused_frontier_cuda.launches
            got = fused_frontier_cuda(tab, uidx, inv)
            torch.cuda.synchronize()
            assert fused_frontier_cuda.launches == before + 1
            want = fused_frontier_plain(tab, uidx, inv)
            assert torch.equal(got, want), (case, b)


@pytest.mark.cuda
def test_fused_frontier_on_card_equals_cpu(cuda_device):
    """The entry point on the card launches B3 once and equals the CPU
    route and the dedup gather, with an id2index indirection."""
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((500, 100)).astype(np.float32)
    ids = rng.integers(-1, 500, 4000).astype(np.int32)
    perm = rng.permutation(500).astype(np.int32)
    outs = []
    for dev in (cuda_device, "cpu"):
        before = fused_frontier_cuda.launches
        out = fused_frontier(torch.from_numpy(feat).to(dev), _t(ids, dev),
                             id2index=_t(perm, dev))
        assert fused_frontier_cuda.launches == before + (dev != "cpu")
        assert torch.equal(out.features, dedup_gather_rows(
            torch.from_numpy(feat).to(dev), _t(ids, dev),
            id2index=_t(perm, dev)))
        outs.append(out)
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_scanned_step_on_card_matches_cpu(cuda_device):
    """One scanned block through B1 and B3 on the card against the same
    block on the CPU: sampling and gathers agree exactly, so the losses
    differ only by float summation order (``index_add_`` on the card is
    nondeterministic): rtol 1e-4."""
    indptr, indices, _, _ = _graph(5, 2000)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2000, 100)).astype(np.float32)
    labels = rng.integers(0, 47, 2000)
    blk = next(node_seed_blocks(np.arange(2000), 64, 3,
                                np.random.default_rng(1)))
    blk[2, 10:] = -1                        # a ragged batch
    weights = {k: torch.from_numpy(
        (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32))
        for k, v in GraphSAGE(100, 32, 47, num_layers=2).state_dict().items()}
    losses = []
    for dev in (cuda_device, "cpu"):
        g = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=dev)
        s = NeighborSampler(g, [10, 5], batch_size=64, with_edge=False)
        model = GraphSAGE(100, 32, 47, num_layers=2, dropout_rate=0.0)
        model.load_state_dict(weights)
        step = make_scanned_node_train_step(s, feat, labels, 64,
                                            fused_frontier=True)
        b1 = sample_cuda.sample_neighbors_cuda.launches
        b3 = fused_frontier_cuda.launches
        _, ls, _, _ = step(create_train_state(model.to(dev), adam(1e-3)),
                           blk, trandom.PRNGKey(3, device=dev))
        if dev != "cpu":
            assert sample_cuda.sample_neighbors_cuda.launches == b1 + 6
            assert fused_frontier_cuda.launches == b3 + 3
        losses.append(ls.cpu())
    torch.testing.assert_close(losses[0], losses[1], rtol=1e-4, atol=1e-5)


def compressed_table(codec, n, d, rng):
    """``(codes [n, d], sz [8, d])`` covering the decode's edge cases:
    an encoded matrix with a constant column (scale 0), signed zeros and
    a subnormal column; for int8 also raw codes over the full range
    -128..127 with a subnormal and a negative scale in ``sz``; for bf16
    also random finite bit patterns (subnormals included)."""
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    x[:, 0] = 1.25
    x[::5, d // 2] = -0.0
    x[:, d - 1] = rng.standard_normal(n).astype(np.float32) * 1e-39
    enc, spec = quant.encode(x, codec)
    sz = quant.scale_zero_rows(spec, d)
    if codec == "int8":
        half = n // 2
        enc[half:] = rng.integers(-128, 128, (n - half, d))
        if d > 2:
            sz[0, 1] = 1e-41                # a subnormal scale
            sz[0, 2] = -0.5                 # a negative scale: zero
        return torch.from_numpy(enc), torch.from_numpy(sz)
    bits = rng.integers(0, 2**16, (n - n // 2, d)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF   # no inf or NaN
    enc[n // 2:] = bits
    return quant.host_to_torch(enc), torch.from_numpy(sz)


DEQUANT_IDS = ("ragged", "all_padding", "all_duplicates", "clamped",
               "empty")


def _dequant_ids(case, n, b, rng):
    if case == "empty":
        return np.zeros(0, np.int32)
    return _frontier_ids(case, n, b, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEQUANT_IDS)
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("d", [1, 3, 64, 100, 128, 256])
def test_gather_dequant_kernel_matches_plain(cuda_device, case, codec, d):
    rng = np.random.default_rng(d)
    table, sz = compressed_table(codec, 301, d, rng)
    table, sz = table.to(cuda_device), sz.to(cuda_device)
    for b in (1, 61, 1000):
        idx = _t(_dequant_ids(case, 300, b, rng), cuda_device)
        # table[1:] has a base that is not aligned for the 4-code loads.
        for tab in (table[:300], table[1:]):
            before = gather_rows_dequant_cuda.launches
            got = gather_rows_dequant_cuda(tab, idx, sz)
            torch.cuda.synchronize()
            assert gather_rows_dequant_cuda.launches == before + 1
            assert got.dtype == torch.float32
            want = gather_rows_dequant_plain(tab, idx, sz)
            assert torch.equal(got, want), (case, b)
            # -0.0 and subnormals: equal bits, not just equal values
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEQUANT_IDS)
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("d", [1, 3, 64, 100, 128, 256])
def test_fused_frontier_dequant_kernel_matches_plain(cuda_device, case,
                                                     codec, d):
    rng = np.random.default_rng(d + 1)
    table, sz = compressed_table(codec, 301, d, rng)
    table, sz = table.to(cuda_device), sz.to(cuda_device)
    for b in (1, 61, 1000):
        ids = _t(_dequant_ids(case, 300, b, rng), cuda_device)
        _, inv, uidx = frontier_plan(ids)
        for tab in (table[:300], table[1:]):
            before = fused_frontier_dequant_cuda.launches
            got = fused_frontier_dequant_cuda(tab, uidx, inv, sz)
            torch.cuda.synchronize()
            assert fused_frontier_dequant_cuda.launches == before + 1
            want = fused_frontier_dequant_plain(tab, uidx, inv, sz)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (case, b)
            if case == "all_padding":
                assert (got.view(torch.int32) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_compressed_entry_points_on_card_equal_cpu(cuda_device, codec):
    """``gather_rows(dequant=)`` and ``fused_frontier(dequant=)`` launch
    B4 and B5 once on the card and equal the CPU routes."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((500, 100)).astype(np.float32)
    enc, spec = quant.encode(x, codec)
    ids = rng.integers(-1, 520, 3000).astype(np.int32)
    outs = []
    for dev in (cuda_device, "cpu"):
        table = quant.host_to_torch(enc).to(dev)
        b4 = gather_rows_dequant_cuda.launches
        b5 = fused_frontier_dequant_cuda.launches
        g = gather_cuda.gather_rows(table, _t(np.maximum(ids, 0), dev),
                                    dequant=spec)
        f = fused_frontier(table, _t(ids, dev), dequant=spec).features
        on_card = dev != "cpu"
        assert gather_rows_dequant_cuda.launches == b4 + on_card
        assert fused_frontier_dequant_cuda.launches == b5 + on_card
        outs.append((g.cpu(), f.cpu()))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("split", [1.0, 0.5])
def test_serving_from_compressed_store_on_card_equals_cpu(
        cuda_device, tmp_path, codec, split):
    """Serving from a compressed store: the card's messages equal the
    CPU's and the host decode (``cpu_get``); the card launched B4 (in
    the bucket's graph at split 1.0, after it at split 0.5)."""
    indptr, indices, _, _ = _graph(2, 3000)
    feat = np.random.default_rng(0).standard_normal((3000, 100)).astype(
        np.float32)
    root = write_feature_store(str(tmp_path / codec), feat, codec=codec)
    msgs = []
    for dev in (cuda_device, "cpu"):
        ds = Dataset(graph=Graph(CSRTopo.from_csr_arrays(indptr, indices),
                                 device=dev), device=dev)
        ds.node_features = Feature.from_store(
            DiskFeatureStore(root), 1 << 20, split_ratio=split, device=dev)
        eng = SubgraphEngine(ds, ServingOptions(num_neighbors=(15, 10, 5)))
        b4 = gather_rows_dequant_cuda.launches
        reqs = [eng.validate_seeds(np.arange(i, i + 20)) for i in (5, 15)]
        msgs.append(eng.scatter(eng.sample(reqs)))
        if dev is cuda_device:
            # split 1.0: B4 in the warm-up and the captured graph; split
            # 0.5: once, eagerly after the replayed sample
            assert gather_rows_dequant_cuda.launches == \
                b4 + (2 if split == 1.0 else 1)
        for m in msgs[-1]:
            np.testing.assert_array_equal(
                m["x"], ds.node_features.cpu_get(m["node"]))
        ds.node_features.close()
    for a, b in zip(*msgs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- on the CPU: the seam ----------------------------------------------------
@pytest.mark.cuda
def test_edge_in_csr_on_card_matches_plain(cuda_device):
    """The card's sorted view equals the CPU's, and its searchsorted
    membership test equals the 32-step search on the card and the CPU:
    real edges, random pairs, padding, ids 0 and N - 1, rows of degree
    0, ids past the last row."""
    indptr, indices, _, _ = _graph()
    n = indptr.shape[0] - 1
    topo = CSRTopo.from_csr_arrays(indptr, indices)
    gc, gh = Graph(topo, device=cuda_device), Graph(topo, device="cpu")
    assert torch.equal(gc.sorted_indices.cpu(), gh.sorted_indices)
    assert torch.equal(gc.edge_keys.cpu(), gh.edge_keys)
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    pick = rng.integers(0, indices.shape[0], 4000)
    # rows 0 and n - 1 have degree 0
    qs = np.concatenate([rows[pick], rng.integers(0, n, 4000),
                         [-1, 0, n - 1, 0, n - 1, 2, n, n + 3, -1]])
    qd = np.concatenate([indices[pick], rng.integers(0, n, 4000),
                         [3, 0, n - 1, n - 1, 0, -1, 1, 0, -1]])
    got = edge_in_csr(gc.indptr, gc.sorted_indices, _t(qs, cuda_device),
                      _t(qd, cuda_device), gc.edge_keys)
    plain = edge_in_csr_plain(gc.indptr, gc.sorted_indices,
                              _t(qs, cuda_device), _t(qd, cuda_device))
    host = edge_in_csr_plain(gh.indptr, gh.sorted_indices, _t(qs, "cpu"),
                             _t(qd, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(got.cpu(), host)
    assert bool(got[:4000].all()) and not bool(got[-9:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,weighted", [("binary", False),
                                           ("binary", True),
                                           ("triplet", False),
                                           ("triplet", True), (None, False)])
def test_sample_from_edges_on_card_equals_cpu(cuda_device, mode, weighted):
    """The link path on the card (B1 a hop, the hash kernel for the
    keys and draws) equals the CPU run field by field, metadata
    included, over a full and a partial batch."""
    indptr, indices, edge_ids, _ = _graph()
    n = indptr.shape[0] - 1
    topo = CSRTopo.from_csr_arrays(indptr, indices, edge_ids)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    w = np.random.default_rng(2).random(n).astype(np.float32)
    neg = None if mode is None else NegativeSampling(
        mode, 2, weight=w if weighted else None)
    outs = []
    for dev in (cuda_device, "cpu"):
        s = NeighborSampler(Graph(topo, device=dev), [5, 3], batch_size=16,
                            seed=3)
        rng = np.random.default_rng(1)
        res = []
        for num in (16, 9):
            pick = rng.integers(0, indices.shape[0], num)
            lab = rng.integers(0, 2, num).astype(np.int32)
            out = s.sample_from_edges(EdgeSamplerInput(
                rows[pick], indices[pick], lab, neg_sampling=neg))
            res.append(out)
        outs.append(res)
    for card, cpu in zip(*outs):
        for f in ("node", "row", "col", "edge", "batch", "node_mask",
                  "edge_mask", "num_sampled_nodes", "num_sampled_edges"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
        assert sorted(card.metadata) == sorted(cpu.metadata)
        for k, v in cpu.metadata.items():
            assert torch.equal(card.metadata[k].cpu(), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("positional_ids", [False, True])
def test_subgraph_on_card_equals_cpu(cuda_device, positional_ids):
    """The induced-subgraph path on the card (B1 a hop, the hash kernel
    for the keys, the induced extract) equals the CPU run field by
    field, metadata included, over a full batch with a repeated seed and
    a hub, and a partial batch, at a degree cap below and above the
    graph's degrees."""
    indptr, indices, edge_ids, _ = _graph()
    n = indptr.shape[0] - 1
    topo = CSRTopo.from_csr_arrays(indptr, indices,
                                   None if positional_ids else edge_ids)
    outs = []
    for dev in (cuda_device, "cpu"):
        s = NeighborSampler(Graph(topo, device=dev), [5, 3], batch_size=16,
                            with_edge=True, seed=3)
        rng = np.random.default_rng(1)
        res = []
        for num, max_degree in ((16, 4), (9, 64)):
            seeds = rng.integers(0, n, num)
            seeds[:2] = [2, 2]
            res.append(s.subgraph(NodeSamplerInput(seeds),
                                  max_degree=max_degree))
        outs.append(res)
    for card, cpu in zip(*outs):
        assert bool(cpu.edge_mask.any())
        for f in ("node", "row", "col", "edge", "batch", "node_mask",
                  "edge_mask", "num_sampled_nodes"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
        assert sorted(card.metadata) == sorted(cpu.metadata)
        for k, v in cpu.metadata.items():
            assert torch.equal(card.metadata[k].cpu(), v), k


def test_cpu_tensors_take_the_plain_versions():
    from glt_tpu_torch.ops import sample_neighbors

    indptr, indices, edge_ids, seeds = _graph()
    ip, ix, ei, sd = (_t(a, "cpu") for a in (indptr, indices, edge_ids,
                                               seeds))
    key = trandom.PRNGKey(3, device="cpu")
    b1 = sample_cuda.sample_neighbors_cuda.launches
    h = threefry_cuda.threefry_hash_cuda.launches
    out = sample_neighbors(ip, ix, sd, 9, key, edge_ids=ei)
    trandom.fold_in(trandom.split(key, 3)[1], 5)
    assert sample_cuda.sample_neighbors_cuda.launches == b1
    assert threefry_cuda.threefry_hash_cuda.launches == h
    want = sample_cuda.sample_neighbors_plain(ip, ix, sd, 9, key, ei)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    # the plain read, by hand, from the plain draw
    from glt_tpu_torch.ops.neighbor_sample import (
        _row_offsets_and_degrees,
        draw_positions,
    )
    _, deg = _row_offsets_and_degrees(ip, sd)
    pos, mask = draw_positions(deg, 9, key, False, sd)
    assert torch.equal(mask, out.mask)
    start = indptr[np.maximum(seeds, 0)]
    m = mask.numpy()
    ref = np.where(m, indices[np.where(m, start[:, None] + pos.numpy(), 0)],
                   -1)
    np.testing.assert_array_equal(out.nbrs.numpy(), ref)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    b2 = gather_cuda.gather_rows_cuda.launches
    out = gather_cuda.gather_rows(table, _t([3, -1, 9, 0], "cpu"))
    assert gather_cuda.gather_rows_cuda.launches == b2
    assert out.tolist() == table[[3, 0, 3, 0]].tolist()


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "fused",
                                 "dequant", "fused_dequant", "hash"])
def test_kernel_wrappers_refuse_bad_input(bad):
    t32 = torch.zeros(4, dtype=torch.int32)
    key = trandom.PRNGKey(0, device="cpu")
    with pytest.raises((ValueError, TypeError)):
        if bad == "device":
            gather_cuda.gather_rows_cuda(torch.zeros(4, 2), t32)
        elif bad == "fused":
            fused_frontier_cuda(torch.zeros(4, 2), t32, t32)
        elif bad == "dequant":
            gather_rows_dequant_cuda(torch.zeros(4, 2, dtype=torch.int8),
                                     t32, torch.zeros(8, 2))
        elif bad == "fused_dequant":
            fused_frontier_dequant_cuda(
                torch.zeros(4, 2, dtype=torch.int8), t32, t32,
                torch.zeros(8, 2))
        elif bad == "dtype":
            sample_cuda.sample_neighbors_cuda(t32, t32, t32.long(), 3, key)
        elif bad == "hash":
            threefry_cuda.threefry_hash_cuda(key[None], n=4)
        else:
            sample_cuda.sample_neighbors_cuda(t32, t32, t32[:, None], 3, key)


def test_captured_program_refuses_cpu_buffers():
    """A CUDA graph is built for CUDA buffers only: on the CPU the
    callers run eagerly and never construct one."""
    with pytest.raises(ValueError, match="CUDA"):
        CapturedProgram(lambda x: x + 1, [torch.zeros(3)])
    with pytest.raises(ValueError, match="CUDA"):
        CapturedProgram(lambda: None, [])


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA an entry point raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        Dataset()
    with pytest.raises(RuntimeError):
        trandom.PRNGKey(0)
    with pytest.raises(RuntimeError):
        Feature(np.zeros((4, 2), np.float32), split_ratio=0.5)
    assert resolve_device("cpu").type == "cpu"
    assert trandom.PRNGKey(0, device="cpu").device.type == "cpu"


def test_link_entry_points_default_to_cuda(monkeypatch):
    """The link and subgraph entry points default to the card too."""
    from glt_tpu_torch.examples import (
        datasets,
        graph_sage_unsup_ppi,
        seal_link_pred,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        datasets.synthetic_ppi(scale=0.0)
    with pytest.raises(RuntimeError):
        graph_sage_unsup_ppi.main(["--epochs", "1"])
    with pytest.raises(RuntimeError):
        seal_link_pred.main(["--epochs", "1"])
    topo = CSRTopo(np.array([[0, 1], [1, 2]]))
    with pytest.raises(RuntimeError):
        Graph(topo, with_sorted_columns=True)
    with pytest.raises(RuntimeError):
        NegativeSampling("binary", 1, weight=[1.0, 2.0]).cdf()
    g = Graph(topo, device="cpu", with_sorted_columns=True)
    assert g.sorted_indices.tolist() == [1, 2]


# -- CUDA graphs ----------------------------------------------------------------
@pytest.mark.cuda
def test_replayed_batched_sample_equals_loop(cuda_device):
    """``sample_from_nodes_batched`` replayed (its second call) is
    ``torch.equal`` to G eager ``sample_from_nodes`` calls under
    ``split(key, G)``; its outputs are copies, not the graph's
    buffers."""
    indptr, indices, edge_ids, _ = _graph(3, 4000)
    g = Graph(CSRTopo.from_csr_arrays(indptr, indices, edge_ids=edge_ids),
              device=cuda_device)
    s = NeighborSampler(g, [15, 10, 5], batch_size=64, frontier_cap=512)
    rng = np.random.default_rng(4)
    first = s.sample_from_nodes_batched(rng.integers(-1, 4000, (8, 64)))
    seeds = rng.integers(-1, 4000, (8, 64))
    key = trandom.PRNGKey(21, device=cuda_device)
    b1 = sample_cuda.sample_neighbors_cuda.launches
    out = s.sample_from_nodes_batched(seeds, key=key)
    assert sample_cuda.sample_neighbors_cuda.launches == b1   # a replay
    for i, k in enumerate(trandom.split(key, 8)):
        one = s.sample_from_nodes(NodeSamplerInput(seeds[i]), key=k)
        for f in ("node", "row", "col", "edge", "node_mask", "edge_mask",
                  "num_sampled_nodes", "num_sampled_edges"):
            assert torch.equal(getattr(out, f)[i], getattr(one, f)), f
    assert out.node.data_ptr() != first.node.data_ptr()


@pytest.mark.cuda
def test_replayed_block_matches_eager(cuda_device):
    """A small f32 GraphSAGE (dropout 0.5) through the scanned node
    step: calls 2 and 3 replay the captured block, and each matches an
    eager block from the same state (a fresh step, whose first call is
    eager) within 1e-5: the same keys and dropout masks, the losses
    apart only by the order of ``index_add_``'s atomics."""
    indptr, indices, _, _ = _graph(5, 2000)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2000, 32)).astype(np.float32)
    labels = rng.integers(0, 7, 2000)
    g = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=cuda_device)
    s = NeighborSampler(g, [10, 5], batch_size=64, with_edge=False)

    def state():
        torch.manual_seed(0)
        return create_train_state(
            GraphSAGE(32, 16, 7, num_layers=2, dropout_rate=0.5).to(
                cuda_device), adam(1e-2))

    def step():
        return make_scanned_node_train_step(s, feat, labels, 64)

    blocks = list(node_seed_blocks(np.arange(2000), 64, 4,
                                   np.random.default_rng(1)))[:3]
    graph_step, a, b = step(), state(), state()
    b1 = sample_cuda.sample_neighbors_cuda.launches
    for i, blk in enumerate(blocks):
        key = trandom.PRNGKey(i, device=cuda_device)
        a, la, _, _ = graph_step(a, blk, key)
        b, lb, _, _ = step()(b, blk, key)
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
        assert a.step == b.step == 4 * (i + 1)
    # eager blocks 1-3 of b, eager block 1 and the capture of a
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 2 * 4 * 5
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


def _small_node_step(dev):
    """A small f32 GraphSAGE step (dropout 0.5) on a 2,000-node graph."""
    indptr, indices, _, _ = _graph(5, 2000)
    rng = np.random.default_rng(0)
    feat = rng.standard_normal((2000, 32)).astype(np.float32)
    labels = rng.integers(0, 7, 2000)
    g = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=dev)
    s = NeighborSampler(g, [10, 5], batch_size=64, with_edge=False)

    def state():
        torch.manual_seed(0)
        return create_train_state(
            GraphSAGE(32, 16, 7, num_layers=2, dropout_rate=0.5).to(dev),
            adam(1e-2))

    return (lambda: make_scanned_node_train_step(s, feat, labels, 64),
            state, list(node_seed_blocks(np.arange(2000), 64, 4,
                                         np.random.default_rng(1)))[:4])


@pytest.mark.cuda
def test_replayed_block_after_restore_matches_unkilled(cuda_device,
                                                       tmp_path):
    """Blocks 0-1 run, the state is checkpointed and restored into a
    fresh model and optimizer; the next blocks (one eager, one capture,
    one replay, counted under ``scanned_node_step``) match the run that
    was never stopped within the node step's tolerance, and Adam's step
    stays a device tensor."""
    from glt_tpu_torch.ckpt import (Checkpointer, capture_train_state,
                                    restore_train_state)
    from glt_tpu_torch.obs import compilewatch

    make, state, blocks = _small_node_step(cuda_device)
    keys = [trandom.PRNGKey(i, device=cuda_device) for i in range(4)]
    ref_step, ref = make(), state()
    ref_losses = []
    for blk, key in zip(blocks, keys):
        ref, ls, _, _ = ref_step(ref, blk, key)
        ref_losses.append(ls)
    step, a = make(), state()
    for blk, key in zip(blocks[:2], keys[:2]):
        a, _, _, _ = step(a, blk, key)
    ck = Checkpointer(str(tmp_path), every_n_steps=1)
    ck.save(2, {"ts": capture_train_state(a)})
    b = restore_train_state(ck.resume().components["ts"], like=state())
    assert all(st["step"].is_cuda for st in b.optimizer.state.values())
    compilewatch.reset_for_tests()
    for i in (2, 3):          # eager, then captured and replayed
        b, lb, _, _ = step(b, blocks[i], keys[i])
        torch.testing.assert_close(lb, ref_losses[i], rtol=1e-5, atol=1e-6)
    assert b.step == ref.step == 16
    assert compilewatch.counts("scanned_node_step") == 1
    for pa, pb in zip(ref.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_capture_under_tracer_emits_no_span(cuda_device, tmp_path):
    """With a Tracer installed and metrics on, the scanned block still
    captures (no fence or sync inside it), and the step's calls (eager,
    capture, replay) emit no span; the epoch driver's host spans wrap
    the replays and validate."""
    from glt_tpu_torch import obs
    from glt_tpu_torch.models import run_scanned_epoch

    make, state, blocks = _small_node_step(cuda_device)
    step, a = make(), state()
    obs.metrics.enable()
    tracer = obs.start_trace()
    try:
        for i, blk in enumerate(blocks[:3]):
            a, _, _, _ = step(a, blk, trandom.PRNGKey(i, device=cuda_device))
        assert len(step._programs) == 1           # captured
        assert tracer.events == []
        run_scanned_epoch(step, a, np.arange(4 * 64 * 2), 64, 4,
                          np.random.default_rng(2),
                          trandom.PRNGKey(9, device=cuda_device),
                          on_block=lambda st, i: None)
        names = [e["name"] for e in tracer.events]
        assert names.count("train.scanned_block_dispatch") == 2
        assert set(names) == {"train.scanned_epoch",
                              "train.scanned_block_dispatch"}
    finally:
        obs.stop_trace(str(tmp_path / "t.json"))
        obs.metrics.disable()
    assert obs.validate_chrome_trace(
        obs.summarize.load_trace(str(tmp_path / "t.json"))) == []


@pytest.mark.cuda
def test_failed_capture_raises(cuda_device, monkeypatch):
    """A host sync inside a capture raises GraphCaptureError, and the
    engine never serves the micro-batch eagerly in its place."""
    buf = torch.zeros(4, device=cuda_device)
    with pytest.raises(GraphCaptureError):
        CapturedProgram(lambda x: torch.tensor(float(x.sum()),
                                               device=x.device), [buf],
                        warmup=0)
    eng = SubgraphEngine(_serving_dataset(cuda_device),
                         ServingOptions(num_neighbors=(15, 10, 5)))
    stage = eng._device_stage

    def syncing(sampler, seeds, key):
        out = stage(sampler, seeds, key)
        int(out[0].max())                   # a host sync
        return out

    monkeypatch.setattr(eng, "_device_stage", syncing)
    for _ in range(2):
        with pytest.raises(GraphCaptureError):
            eng.sample([eng.validate_seeds([1, 2, 3])])
    assert eng.compiled_buckets() == []
    # the device still works after the failed captures
    assert float(buf.add(1).sum()) == 4.0


def _igbh_pair(dev):
    from glt_tpu_torch.examples.datasets import synthetic_igbh

    return (synthetic_igbh(scale=0.05, device=dev)[0],
            synthetic_igbh(scale=0.05, device="cpu")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [True, False])
def test_hetero_sample_on_card_equals_cpu(cuda_device, dedup):
    """The hetero sampler on the card (B1 once per (hop, edge type) with
    a nonzero width) gives the CPU's sample bit for bit, node and link
    paths."""
    from glt_tpu_torch.sampler import HeteroNeighborSampler

    gds, cds = _igbh_pair(cuda_device)
    kw = dict(batch_size=16, seed=3, last_hop_dedup=dedup)
    gs = HeteroNeighborSampler(gds.graph, [4, 3], "paper", **kw)
    cs = HeteroNeighborSampler(cds.graph, [4, 3], "paper", **kw)
    seeds = np.array([3, 3, 9, 0, 49, -1, 20])
    b1 = sample_cuda.sample_neighbors_cuda.launches
    got = gs.sample_from_nodes(NodeSamplerInput(seeds))
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 2 + 4
    want = cs.sample_from_nodes(NodeSamplerInput(seeds))
    et = ("author", "writes", "paper")
    topo = cds.get_graph(et).topo
    e = np.stack(csr_to_coo(topo.indptr, topo.indices))[:, :16]
    inp = EdgeSamplerInput(e[0], e[1], input_type=et,
                           neg_sampling=NegativeSampling("binary", 1))
    pairs = [(got, want), (gs.sample_from_edges(inp),
                           cs.sample_from_edges(inp))]
    for g, w in pairs:
        for f in ("node", "row", "col", "edge", "node_mask", "edge_mask",
                  "num_sampled_nodes"):
            for k, v in getattr(w, f).items():
                assert torch.equal(getattr(g, f)[k].cpu(), v), (f, k)
        for k, v in (w.metadata or {}).items():
            assert torch.equal(g.metadata[k].cpu(), v), k


@pytest.mark.cuda
def test_replayed_hetero_block_matches_eager(cuda_device):
    """A small HGT (dropout 0.3) through the scanned hetero step: call 2
    captures the block and call 3 replays it; each call matches an eager
    block from the same state (a fresh step) within 1e-5: the same keys
    and dropout masks, the losses apart only by the order of
    ``index_add_``'s atomics."""
    from glt_tpu_torch.examples.hetero import init_hetero_params
    from glt_tpu_torch.models import HGT, make_scanned_hetero_train_step
    from glt_tpu_torch.sampler import HeteroNeighborSampler
    from glt_tpu_torch.typing import reverse_edge_type

    gds, cds = _igbh_pair(cuda_device)
    ets = sorted(reverse_edge_type(et) for et in gds.graph)
    widths = {t: gds.get_node_feature(t).shape[1]
              for t in gds.get_node_types()}
    s = HeteroNeighborSampler(gds.graph, [4, 3], "paper", batch_size=32)
    feats = {t: gds.get_node_feature(t) for t in gds.get_node_types()}
    labels = {"paper": gds.get_node_label("paper")}

    def state():
        model = init_hetero_params(HGT(ets, widths, 16, 8, "paper",
                                       heads=2, dropout_rate=0.3))
        return create_train_state(model.to(cuda_device), adam(1e-3))

    def step():
        return make_scanned_hetero_train_step(s, feats, labels, 32)

    rng = np.random.default_rng(1)
    blocks = [rng.integers(0, 200, (4, 32)) for _ in range(4)]
    blocks[3][3] = -1                       # a fully padded batch
    graph_step, a, b = step(), state(), state()
    b1 = sample_cuda.sample_neighbors_cuda.launches
    for i, blk in enumerate(blocks):
        key = trandom.PRNGKey(i, device=cuda_device)
        a, la, aa = graph_step(a, blk, key)
        b, lb, ab = step()(b, blk, key)
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aa, ab, rtol=1e-5, atol=1e-6)
    assert a.step == b.step == 15 and float(la[3]) == 0.0
    # 6 B1 launches a sample: b's 15 eager samples; a's eager block 1,
    # the capture of block 2, no launch in the replay of block 3, and
    # the eager block 4 (a new real-batch pattern).
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 6 * (15 + 11)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


def _dist_pair(dev, shards=4):
    """A small partition directory loaded on ``dev`` and on the CPU."""
    import tempfile

    from glt_tpu_torch.distributed import DistDataset
    from glt_tpu_torch.partition import RandomPartitioner

    rng = np.random.default_rng(5)
    n = 600
    indptr, indices, _, _ = _graph(seed=4, n=n)
    src, dst = csr_to_coo(indptr, indices)
    feat = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    with tempfile.TemporaryDirectory() as root:
        RandomPartitioner(root, shards, n, np.stack([src, dst]),
                          node_feat=feat, seed=1).partition()
        return (DistDataset.load(root, labels=labels, device=dev),
                DistDataset.load(root, labels=labels, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [False, True])
def test_dist_sample_on_card_equals_cpu(cuda_device, capped):
    """A 4-shard DistNeighborSampler batch on cuda:0 shards (B1 once per
    hop a shard, twice capped) equals the CPU's bit for bit."""
    from glt_tpu_torch.parallel import DistNeighborSampler, Mesh

    gds, cds = _dist_pair(cuda_device)
    kw = dict(num_neighbors=[5, 4], batch_size=16, seed=3,
              exchange_load_factor=2.0 if capped else None)
    gs = DistNeighborSampler(gds.graph, Mesh([cuda_device] * 4), **kw)
    cs = DistNeighborSampler(cds.graph, Mesh(["cpu"] * 4), **kw)
    seeds = cds.split_seeds(np.arange(600), 16, shuffle=True, seed=2)[0]
    b1 = sample_cuda.sample_neighbors_cuda.launches
    got = gs.sample_from_nodes(seeds)
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 4 * 2 * (
        2 if capped else 1)
    want = cs.sample_from_nodes(seeds)
    for f in ("node", "row", "col", "edge", "batch", "node_mask",
              "edge_mask", "num_sampled_nodes", "num_sampled_edges"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


def _tiered_pair(dev, ratio=0.25):
    """``_dist_pair``'s partition loaded tiered on ``dev`` and the CPU."""
    import tempfile

    from glt_tpu_torch.distributed import DistDataset
    from glt_tpu_torch.partition import RandomPartitioner

    rng = np.random.default_rng(5)
    n = 600
    indptr, indices, _, _ = _graph(seed=4, n=n)
    src, dst = csr_to_coo(indptr, indices)
    feat = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    with tempfile.TemporaryDirectory() as root:
        RandomPartitioner(root, 4, n, np.stack([src, dst]),
                          node_feat=feat, seed=1).partition()
        return (DistDataset.load(root, hot_ratio=ratio, labels=labels,
                                 device=dev),
                DistDataset.load(root, hot_ratio=ratio, labels=labels,
                                 device="cpu"))


@pytest.mark.cuda
def test_tiered_pipeline_on_card_equals_cpu(cuda_device):
    """TieredTrainPipeline on cuda:0 shards (stage and train each one
    CUDA graph from the second batch on, B3 serving the hot rows, the
    cold rows staged through pinned memory and a copy stream) trains 5
    batches to the CPU's losses within 1e-5 from the same weights, with
    the same drops at a small cold_cap; B1 8 and B3 4 times in the eager
    batch and in each capture, none in a replay."""
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import (DistNeighborSampler, Mesh,
                                        TieredTrainPipeline,
                                        init_dist_state,
                                        make_tiered_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    gds, cds = _tiered_pair(cuda_device)
    batches = list(cds.split_seeds(np.arange(600), 16, shuffle=True,
                                   seed=2)[:5])
    torch.manual_seed(0)
    model = GraphSAGE(12, 32, 5, num_layers=2, dropout_rate=0.0)
    res = {}
    for ds, dev in ((gds, cuda_device), (cds, torch.device("cpu"))):
        m = GraphSAGE(12, 32, 5, num_layers=2, dropout_rate=0.0).to(dev)
        m.load_state_dict(model.state_dict())
        state = init_dist_state(m, adam(1e-3), ds.graph, ds.feature, [5, 4],
                                16)
        mesh = Mesh([dev] * 4)
        sampler = DistNeighborSampler(ds.graph, mesh, num_neighbors=[5, 4],
                                      batch_size=16)
        train = make_tiered_train_step(ds.graph, ds.feature, ds.labels, mesh,
                                       16, fused_frontier=dev.type == "cuda")
        for cap in (None, 7):
            pipe = TieredTrainPipeline(sampler, train, ds.feature, mesh,
                                       cold_cap=cap, stage_threads=2)
            b1 = sample_cuda.sample_neighbors_cuda.launches
            b3 = fused_frontier_cuda.launches
            caps = (compilewatch.counts("tiered_stage"),
                    compilewatch.counts("tiered_train_step"))
            state, losses, _ = pipe.run_epoch(
                state, batches, trandom.PRNGKey(3, device=dev))
            res[dev.type, cap] = (torch.stack(losses).cpu(),
                                  pipe.flush_dropped())
            if dev.type == "cuda":
                assert sample_cuda.sample_neighbors_cuda.launches == \
                    b1 + 2 * 4 * 2
                assert fused_frontier_cuda.launches == b3 + 2 * 4
                assert (compilewatch.counts("tiered_stage"),
                        compilewatch.counts("tiered_train_step")) == (
                            caps[0] + 1, caps[1] + 1)
            pipe.close()
    for cap in (None, 7):
        torch.testing.assert_close(res["cuda", cap][0], res["cpu", cap][0],
                                   rtol=1e-5, atol=1e-6)
        assert res["cuda", cap][1] == res["cpu", cap][1]
    assert res["cpu", None][1] == 0 and res["cpu", 7][1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
def test_dist_edges_and_subgraph_on_card_equal_cpu(cuda_device, strict):
    """DistNeighborSampler.sample_from_edges (binary x1) and subgraph on
    cuda:0 shards equal the CPU's bit for bit."""
    from glt_tpu_torch.parallel import DistNeighborSampler, Mesh

    gds, cds = _dist_pair(cuda_device)
    kw = dict(num_neighbors=[5, 4], batch_size=16, seed=3)
    gs = DistNeighborSampler(gds.graph, Mesh([cuda_device] * 4), **kw)
    cs = DistNeighborSampler(cds.graph, Mesh(["cpu"] * 4), **kw)
    rng = np.random.default_rng(4)
    src = rng.integers(0, 600, (4, 16)).astype(np.int32)
    dst = rng.integers(0, 600, (4, 16)).astype(np.int32)
    src[:, -2:] = -1
    neg = NegativeSampling("binary", 1)
    outs = [s.sample_from_edges(src, dst, neg, strict=strict,
                                key=trandom.PRNGKey(5, device=d))
            for s, d in ((gs, cuda_device), (cs, "cpu"))]
    outs += [s.subgraph(src, max_degree=32, key=trandom.PRNGKey(6, device=d))
             for s, d in ((gs, cuda_device), (cs, "cpu"))]
    for got, want in (outs[:2], outs[2:]):
        for f in ("node", "row", "col", "edge", "batch", "node_mask",
                  "edge_mask", "num_sampled_nodes"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        for k, v in want.metadata.items():
            assert torch.equal(got.metadata[k].cpu(), v), k


@pytest.mark.cuda
def test_dist_step_loss_on_card_equals_cpu(cuda_device):
    """One make_dist_train_step step (B3 serving the feature requests) on
    cuda:0 shards gives the CPU's loss within 1e-5 from the same
    weights."""
    from glt_tpu_torch.parallel import (Mesh, init_dist_state,
                                        make_dist_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    gds, cds = _dist_pair(cuda_device)
    seeds = cds.split_seeds(np.arange(600), 16, shuffle=True, seed=2)[0]
    torch.manual_seed(0)
    model = GraphSAGE(12, 32, 5, num_layers=2, dropout_rate=0.0)
    losses = []
    for ds, dev in ((gds, cuda_device), (cds, torch.device("cpu"))):
        m = GraphSAGE(12, 32, 5, num_layers=2, dropout_rate=0.0).to(dev)
        m.load_state_dict(model.state_dict())
        state = init_dist_state(m, adam(1e-3), ds.graph, ds.feature, [5, 4],
                                16)
        step = make_dist_train_step(ds.graph, ds.feature, ds.labels,
                                    Mesh([dev] * 4), [5, 4], 16,
                                    fused_frontier=dev.type == "cuda")
        b3 = fused_frontier_cuda.launches
        state, loss, _ = step(state, seeds, trandom.PRNGKey(7, device=dev))
        if dev.type == "cuda":
            assert fused_frontier_cuda.launches == b3 + 4
        losses.append(float(loss))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)


@pytest.mark.cuda
def test_request_rows_b3_equals_take(cuda_device):
    """The feature exchange's serve through B3 equals its plain masked
    take bit for bit, padding and repeated hub rows included."""
    from glt_tpu_torch.parallel.dist_feature import _request_rows

    rng = np.random.default_rng(8)
    rows = torch.from_numpy(rng.standard_normal((500, 128)).astype(
        np.float32)).to(cuda_device)
    req = np.concatenate([rng.integers(0, 500, 3000), np.full(64, 7),
                          rng.integers(-600, 1100, 1000)]).astype(np.int32)
    local = torch.from_numpy(req).to(cuda_device)
    ok = (local >= 0) & (local < 500)
    b3 = fused_frontier_cuda.launches
    got = _request_rows(rows, local, ok, True)
    assert fused_frontier_cuda.launches == b3 + 1
    assert torch.equal(got, _request_rows(rows, local, ok, False))


def _replayed_vs_eager(make_step, make_state, blocks, keys, program):
    """Drive ``blocks`` through one step (eager, captured, replayed) and
    each through a fresh step (eager) from a state of the same start;
    returns the two loss lists and the two final states.  The graph step
    captures once (under the compilewatch label ``program``), and its
    last call is a replay: it moves no B1 counter."""
    from glt_tpu_torch.obs import compilewatch

    graph_step, a, b = make_step(), make_state(), make_state()
    captures = compilewatch.counts(program)
    got, want = [], []
    for i, (blk, key) in enumerate(zip(blocks, keys)):
        b1 = sample_cuda.sample_neighbors_cuda.launches
        a, *la = graph_step(a, *blk, key)
        if i == 2:
            assert sample_cuda.sample_neighbors_cuda.launches == b1
        b, *lb = make_step()(b, *blk, key)
        got.append(la[0])
        want.append(lb[0])
    assert compilewatch.counts(program) == captures + 1
    return got, want, a, b


def _triplet_loss(z, meta):
    """A margin loss over each positive and its negatives."""
    last = z.shape[0] - 1
    s = z[meta["src_index"].clamp(0, last).long()]
    p = z[meta["dst_pos_index"].clamp(0, last).long()]
    n = z[meta["dst_neg_index"].clamp(0, last).long()]
    gap = (s[:, None] * n).sum(-1) - (s * p).sum(-1)[:, None]
    return torch.relu(gap + 1.0).mean()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["binary", "triplet"])
def test_replayed_link_block_matches_eager(cuda_device, mode):
    """The scanned link step, binary and triplet: calls 2 and 3 replay
    the block captured at its shape, and each matches an eager block
    from the same state within 1e-5 (the losses apart only by the order
    of ``index_add_``'s atomics); so do the final parameters."""
    from glt_tpu_torch.examples.graph_sage_unsup_ppi import unsup_dot_loss
    from glt_tpu_torch.models import (link_seed_blocks,
                                      make_scanned_link_train_step)

    indptr, indices, _, _ = _graph(5, 2000)
    feat = np.random.default_rng(0).standard_normal((2000, 32)).astype(
        np.float32)
    g = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=cuda_device)
    s = NeighborSampler(g, [5, 3], batch_size=32, frontier_cap=256,
                        with_edge=False)
    neg = NegativeSampling(mode, 1 if mode == "binary" else 2)
    loss = unsup_dot_loss if mode == "binary" else _triplet_loss

    def state():
        torch.manual_seed(0)
        return create_train_state(
            GraphSAGE(32, 16, 16, num_layers=2, dropout_rate=0.0).to(
                cuda_device), adam(1e-2))

    ei = np.stack(csr_to_coo(indptr, indices))
    blocks = [(sb, db) for sb, db, _ in link_seed_blocks(
        ei, 32, 4, np.random.default_rng(1))][:3]
    keys = [trandom.PRNGKey(i, device=cuda_device) for i in range(3)]
    got, want, a, b = _replayed_vs_eager(
        lambda: make_scanned_link_train_step(s, feat, loss, neg), state,
        blocks, keys, "scanned_link_step")
    for la, lb in zip(got, want):
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
    assert a.step == b.step == 12
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_replayed_subgraph_block_matches_eager(cuda_device):
    """The scanned subgraph step: the replayed blocks match eager blocks
    from the same state within 1e-5, their last batch fully padded."""
    from glt_tpu_torch.examples.seal_link_pred import pair_loss
    from glt_tpu_torch.models import make_scanned_subgraph_train_step

    indptr, indices, _, _ = _graph(5, 2000)
    feat = np.random.default_rng(0).standard_normal((2000, 32)).astype(
        np.float32)
    g = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=cuda_device)
    s = NeighborSampler(g, [4, 3], batch_size=16, with_edge=True)

    def state():
        torch.manual_seed(0)
        return create_train_state(
            GraphSAGE(32, 16, 16, num_layers=2, dropout_rate=0.0).to(
                cuda_device), adam(1e-2))

    rng = np.random.default_rng(2)
    blocks = []
    for _ in range(3):
        sb = rng.integers(0, 2000, (4, 16))
        yb = rng.integers(0, 2, (4, 8))
        sb[-1], yb[-1] = -1, -1
        blocks.append((sb, yb))
    keys = [trandom.PRNGKey(10 + i, device=cuda_device) for i in range(3)]
    got, want, a, b = _replayed_vs_eager(
        lambda: make_scanned_subgraph_train_step(s, feat, pair_loss, 8),
        state, blocks, keys, "scanned_subgraph_step")
    for la, lb in zip(got, want):
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
    assert a.step == b.step == 12
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_replayed_dist_block_matches_eager(cuda_device):
    """The scanned distributed step over 4 shards on cuda:0 (B3 serving,
    dropout 0.5): each replayed [G, S, B] block matches an eager block
    from the same state within 1e-5; B1 runs 2 and B3 1 a shard a slot
    in the eager block, none in a replay."""
    from glt_tpu_torch.parallel import (Mesh, dist_seed_blocks,
                                        init_dist_state,
                                        make_scanned_dist_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    gds, _ = _dist_pair(cuda_device)
    blocks = [(blk,) for blk in dist_seed_blocks(
        np.arange(600), 4, 16, 3, np.random.default_rng(3))][:3]
    assert all((blk >= 0).all() for blk, in blocks)

    def state():
        torch.manual_seed(0)
        m = GraphSAGE(12, 32, 5, num_layers=2, dropout_rate=0.5).to(
            cuda_device)
        return init_dist_state(m, adam(1e-3), gds.graph, gds.feature,
                               [5, 4], 16)

    def make():
        return make_scanned_dist_train_step(
            gds.graph, gds.feature, gds.labels, Mesh([cuda_device] * 4),
            [5, 4], 16, fused_frontier=True)

    b1, b3 = (sample_cuda.sample_neighbors_cuda.launches,
              fused_frontier_cuda.launches)
    make()(state(), *blocks[0], trandom.PRNGKey(0, device=cuda_device))
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 3 * 4 * 2
    assert fused_frontier_cuda.launches == b3 + 3 * 4
    keys = [trandom.PRNGKey(20 + i, device=cuda_device) for i in range(3)]
    got, want, a, b = _replayed_vs_eager(make, state, blocks, keys,
                                         "scanned_dist_step")
    for la, lb in zip(got, want):
        torch.testing.assert_close(la, lb, rtol=1e-5, atol=1e-6)
    assert a.step == b.step == 9
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)


def _hetero_dist_pair(dev, shards=4, mesh_rows=1):
    """Synthetic IGBH at scale 0.5 sharded on ``dev`` and on the CPU,
    with a mesh of ``mesh_rows`` hosts on each."""
    from glt_tpu_torch.examples.datasets import synthetic_igbh
    from glt_tpu_torch.parallel import global_mesh_2d, shard_hetero_graph

    ds, train_idx, classes = synthetic_igbh(scale=0.5, device="cpu")
    topos = {et: g.topo for et, g in ds.graph.items()}
    out = []
    for d in (dev, "cpu"):
        out.append((shard_hetero_graph(topos, shards, device=d),
                    global_mesh_2d([d] * shards, num_hosts=mesh_rows)))
    return ds, train_idx, out


@pytest.mark.cuda
@pytest.mark.parametrize("route,alpha", [("auto", None), ("hier", None),
                                         ("flat", 2.0)])
def test_hetero_dist_sample_on_card_equals_cpu(cuda_device, route, alpha):
    """A 4-shard DistHeteroNeighborSampler batch on cuda:0 (a 1 x 4 or,
    for the hier and flat routes, a 2 x 2 mesh; B1 once per (hop, edge
    type) a shard, twice capped) equals the CPU's bit for bit."""
    from glt_tpu_torch.parallel import DistHeteroNeighborSampler

    ds, train_idx, pairs = _hetero_dist_pair(
        cuda_device, mesh_rows=1 if route == "auto" else 2)
    kw = dict(batch_size=16, frontier_cap=64, seed=3, route=route,
              exchange_load_factor=alpha)
    (gsh, gmesh), (csh, cmesh) = pairs
    gs = DistHeteroNeighborSampler(gsh, gmesh, [4, 4], "paper", **kw)
    cs = DistHeteroNeighborSampler(csh, cmesh, [4, 4], "paper", **kw)
    per = csh[("paper", "cites", "paper")].nodes_per_shard
    seeds = np.stack([np.arange(s * per, s * per + 16) for s in range(4)])
    b1 = sample_cuda.sample_neighbors_cuda.launches
    got = gs.sample_from_nodes(seeds)
    assert sample_cuda.sample_neighbors_cuda.launches == b1 + 4 * 6 * (
        2 if alpha else 1)
    want = cs.sample_from_nodes(seeds)
    for f in ("node", "row", "col", "edge", "node_mask", "edge_mask",
              "num_sampled_nodes"):
        for k, v in getattr(want, f).items():
            assert torch.equal(getattr(got, f)[k].cpu(), v), (f, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"route": "hier"}, {"route": "flat"},
                                {"collective": "ring"},
                                {"route": "hier", "hier_load_factor": 0.5}])
def test_2d_mesh_sample_on_card_equals_cpu(cuda_device, kw):
    """DistNeighborSampler on a 2 x 2 mesh of cuda:0 shards (the
    hierarchical route, the flat one, the ring, a bounded cross-host leg)
    equals the CPU's bit for bit."""
    from glt_tpu_torch.parallel import DistNeighborSampler, global_mesh_2d

    gds, cds = _dist_pair(cuda_device)
    args = dict(num_neighbors=[5, 4], batch_size=16, seed=3, **kw)
    gs = DistNeighborSampler(gds.graph, global_mesh_2d([cuda_device] * 4,
                                                       num_hosts=2), **args)
    cs = DistNeighborSampler(cds.graph, global_mesh_2d(["cpu"] * 4,
                                                       num_hosts=2), **args)
    seeds = cds.split_seeds(np.arange(600), 16, shuffle=True, seed=2)[0]
    got, want = gs.sample_from_nodes(seeds), cs.sample_from_nodes(seeds)
    for f in ("node", "row", "col", "edge", "node_mask", "edge_mask",
              "num_sampled_nodes", "num_sampled_edges"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    if want.metadata is not None:
        assert torch.equal(got.metadata["exchange_dropped"].cpu(),
                           want.metadata["exchange_dropped"])


@pytest.mark.cuda
def test_hetero_dist_step_replays_and_matches_cpu(cuda_device):
    """The hetero distributed step on 4 cuda:0 shards: eager, captured,
    replayed (B1 24 a step eager and in the capture, none in a replay);
    its losses within 1e-5 of the CPU's from the same weights."""
    from glt_tpu_torch.models import RGAT, adam
    from glt_tpu_torch.parallel import (DistHeteroNeighborSampler,
                                        init_hetero_dist_state,
                                        make_hetero_dist_train_step,
                                        shard_feature)
    from glt_tpu_torch.typing import reverse_edge_type

    ds, train_idx, pairs = _hetero_dist_pair(cuda_device)
    per = pairs[1][0][("paper", "cites", "paper")].nodes_per_shard
    labels = np.asarray(ds.get_node_label("paper"))
    lab = np.pad(labels, (0, 4 * per - labels.size),
                 constant_values=-1).reshape(4, per)
    widths = {t: ds.get_node_feature(t).shape[1]
              for t in ds.get_node_types()}
    torch.manual_seed(0)
    base = RGAT([reverse_edge_type(et) for et in ds.get_edge_types()],
                widths, 16, 8, "paper", num_layers=2, conv="gat",
                dropout_rate=0.0)
    losses = {}
    for dev, (sh, mesh) in zip((cuda_device, "cpu"), pairs):
        feats = {t: shard_feature(ds.get_node_feature(t).hot_rows.numpy(),
                                  4, device=dev)
                 for t in ds.get_node_types()}
        samp = DistHeteroNeighborSampler(sh, mesh, [4, 4], "paper",
                                         batch_size=16, frontier_cap=64)
        model = RGAT([reverse_edge_type(et) for et in ds.get_edge_types()],
                     widths, 16, 8, "paper", num_layers=2, conv="gat",
                     dropout_rate=0.0)
        model.load_state_dict(base.state_dict())
        st = init_hetero_dist_state(model.to(dev), adam(1e-3), samp, feats)
        step = make_hetero_dist_train_step(
            samp, feats, torch.from_numpy(lab).to(dev), mesh, 16)
        out = []
        for it in range(4):
            seeds = np.stack([np.arange(s * per + 16 * it,
                                        s * per + 16 * it + 16)
                              for s in range(4)])
            b1 = sample_cuda.sample_neighbors_cuda.launches
            st, loss, _ = step(st, seeds, trandom.PRNGKey(it, device=dev))
            if dev != "cpu":
                assert sample_cuda.sample_neighbors_cuda.launches - b1 == (
                    24 if it < 2 else 0), it
            out.append(float(loss))
        losses[str(dev)] = out
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
