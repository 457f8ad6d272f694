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
from glt_tpu_torch.models import (
    GraphSAGE,
    adam,
    create_train_state,
    make_scanned_node_train_step,
    node_seed_blocks,
)
from glt_tpu_torch.ops import (
    dedup_gather_rows,
    frontier_plan,
    fused_frontier,
    fused_frontier_cuda,
    fused_frontier_plain,
    gather_cuda,
    sample_cuda,
)
from glt_tpu_torch.ops.neighbor_sample import (
    _row_offsets_and_degrees,
    draw_positions,
)
from glt_tpu_torch.sampler import NeighborSampler, NodeSamplerInput
from glt_tpu_torch.serving import ServingOptions, SubgraphEngine
from glt_tpu_torch.utils.device import resolve_device

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


# -- on the card -------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [5, 10, 15, 40])
@pytest.mark.parametrize("eid_mode", ["none", "positional", "explicit"])
@pytest.mark.parametrize("with_replacement", [False, True])
def test_sample_kernel_matches_plain(cuda_device, fanout, eid_mode,
                                     with_replacement):
    indptr, indices, edge_ids, seeds = _graph()
    ip, ix, sd = (_t(a, cuda_device) for a in (indptr, indices, seeds))
    eid = _t(edge_ids, cuda_device) if eid_mode == "explicit" else None
    with_edge = eid_mode != "none"
    _, deg = _row_offsets_and_degrees(ip, sd)
    pos, mask = draw_positions(deg, fanout,
                               trandom.PRNGKey(fanout, device=cuda_device),
                               with_replacement, sd)
    before = sample_cuda.sample_neighbors_cuda.launches
    got = sample_cuda.sample_neighbors_cuda(ip, sd, pos, mask, ix, eid,
                                            with_edge)
    want = sample_cuda.sample_neighbors_plain(ip, sd, pos, mask, ix, eid,
                                              with_edge)
    torch.cuda.synchronize()
    assert sample_cuda.sample_neighbors_cuda.launches == before + 1
    assert torch.equal(got[0], want[0])
    if with_edge:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.cuda
def test_sample_kernel_all_padding(cuda_device):
    indptr, indices, _, _ = _graph()
    ip, ix = _t(indptr, cuda_device), _t(indices, cuda_device)
    sd = _t(np.full(33, -1), cuda_device)
    _, deg = _row_offsets_and_degrees(ip, sd)
    pos, mask = draw_positions(deg, 7, trandom.PRNGKey(0, device=cuda_device),
                               False, sd)
    nbrs, eids = sample_cuda.sample_neighbors_cuda(ip, sd, pos, mask, ix)
    torch.cuda.synchronize()
    assert (nbrs == -1).all() and (eids == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.cuda
def test_serving_on_card_equals_cpu(cuda_device):
    """The slice on a small graph: card and CPU engines give equal
    messages, and the card run launched both kernels."""
    indptr, indices, _, _ = _graph(2, 3000)
    feat = np.random.default_rng(0).standard_normal((3000, 100)).astype(
        np.float32)
    labels = np.arange(3000) % 47
    msgs = []
    for dev in (cuda_device, "cpu"):
        ds = Dataset(graph=Graph(CSRTopo.from_csr_arrays(indptr, indices),
                                 device=dev), device=dev)
        ds.init_node_features(feat)
        ds.init_node_labels(labels)
        eng = SubgraphEngine(ds, ServingOptions(num_neighbors=(15, 10, 5)))
        b1 = sample_cuda.sample_neighbors_cuda.launches
        b2 = gather_cuda.gather_rows_cuda.launches
        reqs = [eng.validate_seeds(np.arange(i, i + 20)) for i in (5, 15)]
        msgs.append(eng.scatter(eng.sample(reqs)))
        if dev is cuda_device:
            assert sample_cuda.sample_neighbors_cuda.launches == b1 + 3
            assert gather_cuda.gather_rows_cuda.launches == b2 + 1
    for a, b in zip(*msgs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


# -- on the CPU: the seam ----------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    indptr, indices, edge_ids, seeds = _graph()
    ip, ix, ei, sd = (_t(a, "cpu") for a in (indptr, indices, edge_ids,
                                               seeds))
    _, deg = _row_offsets_and_degrees(ip, sd)
    pos, mask = draw_positions(deg, 9, trandom.PRNGKey(3, device="cpu"),
                               False, sd)
    b1 = sample_cuda.sample_neighbors_cuda.launches
    nbrs, eids = sample_cuda.read_neighbors(ip, sd, pos, mask, ix, ei)
    assert sample_cuda.sample_neighbors_cuda.launches == b1
    want = sample_cuda.sample_neighbors_plain(ip, sd, pos, mask, ix, ei)
    assert torch.equal(nbrs, want[0]) and torch.equal(eids, want[1])
    # the plain read, by hand
    start = indptr[np.maximum(seeds, 0)]
    m = mask.numpy()
    ref = np.where(m, indices[np.where(m, start[:, None] + pos.numpy(), 0)],
                   -1)
    np.testing.assert_array_equal(nbrs.numpy(), ref)
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    b2 = gather_cuda.gather_rows_cuda.launches
    out = gather_cuda.gather_rows(table, _t([3, -1, 9, 0], "cpu"))
    assert gather_cuda.gather_rows_cuda.launches == b2
    assert out.tolist() == table[[3, 0, 3, 0]].tolist()


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "fused"])
def test_kernel_wrappers_refuse_bad_input(bad):
    t32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        if bad == "device":
            gather_cuda.gather_rows_cuda(torch.zeros(4, 2), t32)
        elif bad == "fused":
            fused_frontier_cuda(torch.zeros(4, 2), t32, t32)
        elif bad == "dtype":
            sample_cuda.sample_neighbors_cuda(
                t32, t32.long(), t32[:, None], t32[:, None] > 0, t32)
        else:
            sample_cuda.sample_neighbors_cuda(t32, t32, t32, t32 > 0, t32)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without CUDA an entry point raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        Dataset()
    with pytest.raises(RuntimeError):
        trandom.PRNGKey(0)
    assert resolve_device("cpu").type == "cpu"
    assert trandom.PRNGKey(0, device="cpu").device.type == "cpu"
