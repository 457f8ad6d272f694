"""glt_tpu_torch NeighborLoader against glt_tpu's, batch by batch.

Same dataset, seeds, shuffle seed and sampler key counter; every field
of every batch compares with ==, through the padded trailing batch,
``drop_last`` and the overflow re-fetch of an occupancy-capped sampler.
"""
import numpy as np
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import NeighborLoader as JaxLoader
from glt_tpu.loader.transform import as_pyg_v1_adjs as jax_pyg_v1
from glt_tpu_torch.ckpt import CheckpointError, capture_rng, restore_rng
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import NeighborLoader, as_pyg_v1_adjs

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N = 80
FIELDS = ("x", "y", "edge_index", "node", "node_mask", "edge_mask", "batch")


def _datasets():
    rng = np.random.default_rng(0)
    src = np.repeat(np.arange(N), rng.integers(0, 7, N))
    dst = rng.integers(0, N, src.size)
    ei = np.stack([src, dst])
    feat = rng.standard_normal((N, 5)).astype(np.float32)
    labels = rng.integers(0, 4, N)
    jds = (JaxDataset().init_graph(ei, graph_mode="HOST", num_nodes=N)
           .init_node_features(feat).init_node_labels(labels))
    tds = (Dataset(device="cpu").init_graph(ei, num_nodes=N)
           .init_node_features(feat).init_node_labels(labels))
    return jds, tds


def _assert_batches(jl, tl):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl) == len(jl)
    for a, b in zip(jb, tb):
        assert a.batch_size == b.batch_size
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    return tb


@pytest.mark.parametrize("prefetch", [1, 2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_neighbor_loader_matches_jax(shuffle, drop_last, prefetch):
    jds, tds = _datasets()
    seeds = np.arange(3, 3 + 37)           # 37 = 2 full batches + 5
    kw = dict(batch_size=16, shuffle=shuffle, drop_last=drop_last, seed=2,
              with_edge=True, prefetch=prefetch)
    jl = JaxLoader(jds, [3, 2], seeds, sample_force="xla", **kw)
    tl = NeighborLoader(tds, [3, 2], seeds, **kw)
    for _ in range(2):                      # a second epoch reshuffles
        tb = _assert_batches(jl, tl)
    assert [b.batch_size for b in tb] == ([16, 16] if drop_last
                                          else [16, 16, 5])
    assert tl.overflow_batches == 0


@pytest.mark.parametrize("prefetch", [1, 4])
@pytest.mark.parametrize("fallback", [True, False])
def test_overflow_refetch_matches_jax(fallback, prefetch):
    """frontier_cap 8 at batch 16 over fanout [4, 4]: capacity 32 of 112
    overflows; the flagged batches are re-sampled by the full-capacity
    twin on both sides (or kept, flagged, without the fallback)."""
    jds, tds = _datasets()
    seeds = np.arange(N)
    kw = dict(batch_size=16, frontier_cap=8, node_capacity=32, seed=1,
              with_edge=False, overflow_fallback=fallback,
              prefetch=prefetch)
    jl = JaxLoader(jds, [4, 4], seeds, sample_force="xla", **kw)
    tl = NeighborLoader(tds, [4, 4], seeds, **kw)
    assert tl.sampler.capped and tl.sampler.node_capacity == 32
    tb = _assert_batches(jl, tl)
    assert tl.overflow_batches == jl.overflow_batches
    if fallback:
        assert tl.overflow_batches > 0
        # Re-fetched batches come at the full capacity.
        assert sum(b.node.shape[0] == 112 for b in tb) == \
            tl.overflow_batches
    else:
        assert tl.overflow_batches == 0
        assert any(bool(b.metadata["overflow"]) for b in tb)


def test_loader_state_dict_matches_jax():
    """After one epoch the cursor dict == ``glt_tpu``'s; loaded into a
    fresh loader it replays the next epoch's order batch for batch (cf.
    ``tests/test_checkpoint.py``'s round trip)."""
    jds, tds = _datasets()
    kw = dict(batch_size=16, shuffle=True, seed=11)
    seeds = np.arange(48)
    jl = JaxLoader(jds, [4, 4], seeds, sample_force="xla", **kw)
    a, b = (NeighborLoader(tds, [4, 4], seeds, **kw) for _ in range(2))
    _assert_batches(jl, a)                  # epoch 1 on both packages
    sd = a.state_dict()
    assert sd == jl.state_dict()
    b.load_state_dict(sd)
    assert b._epoch == a._epoch == 1
    order = [x.batch.tolist() for x in a]
    assert [x.batch.tolist() for x in b] == order
    assert a.state_dict() == b.state_dict() and a._epoch == 2
    rng = restore_rng(capture_rng(np.random.default_rng(5)))
    np.testing.assert_array_equal(rng.permutation(9),
                                  np.random.default_rng(5).permutation(9))
    with pytest.raises(CheckpointError):
        b.load_state_dict({"epoch": 0, "rng": {"kind": "other"}})


@pytest.mark.parametrize("frontier_cap", [None, 20])
def test_as_pyg_v1_adjs_matches_jax(frontier_cap):
    """The layered PyG v1 triples == ``glt_tpu``'s, through the loader's
    ``as_pyg_v1`` switch and the function itself."""
    jds, tds = _datasets()
    kw = dict(batch_size=16, seed=3, frontier_cap=frontier_cap,
              as_pyg_v1=True)
    seeds = np.arange(5, 5 + 21)
    jl = JaxLoader(jds, [4, 3, 2], seeds, sample_force="xla", **kw)
    tl = NeighborLoader(tds, [4, 3, 2], seeds, **kw)
    got = list(tl)
    assert len(got) == 2
    for (jbs, jn, jadjs), (tbs, tn, tadjs) in zip(jl, got):
        assert jbs == tbs == 16
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        assert len(jadjs) == len(tadjs) == 3
        for (je, jid, jsz), (te, tid, tsz) in zip(jadjs, tadjs):
            np.testing.assert_array_equal(np.asarray(je), te.numpy())
            np.testing.assert_array_equal(np.asarray(jid), tid.numpy())
            assert tuple(jsz) == tuple(tsz)
    plain = NeighborLoader(tds, [4, 3, 2], seeds[:16], batch_size=16,
                           seed=3)
    batch = next(iter(plain))
    bs, n_id, adjs = as_pyg_v1_adjs(batch, 16, [4, 3, 2])
    jbs, jn, jadjs = jax_pyg_v1(batch, 16, [4, 3, 2])
    assert bs == jbs and n_id is batch.node
    for (te, tid, _), (je, jid, _) in zip(adjs, jadjs):
        assert torch.equal(te, je) and torch.equal(tid, jid)
