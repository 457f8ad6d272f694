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
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import NeighborLoader

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


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_neighbor_loader_matches_jax(shuffle, drop_last):
    jds, tds = _datasets()
    seeds = np.arange(3, 3 + 37)           # 37 = 2 full batches + 5
    kw = dict(batch_size=16, shuffle=shuffle, drop_last=drop_last, seed=2,
              with_edge=True)
    jl = JaxLoader(jds, [3, 2], seeds, sample_force="xla", **kw)
    tl = NeighborLoader(tds, [3, 2], seeds, **kw)
    for _ in range(2):                      # a second epoch reshuffles
        tb = _assert_batches(jl, tl)
    assert [b.batch_size for b in tb] == ([16, 16] if drop_last
                                          else [16, 16, 5])
    assert tl.overflow_batches == 0


@pytest.mark.parametrize("fallback", [True, False])
def test_overflow_refetch_matches_jax(fallback):
    """frontier_cap 8 at batch 16 over fanout [4, 4]: capacity 32 of 112
    overflows; the flagged batches are re-sampled by the full-capacity
    twin on both sides (or kept, flagged, without the fallback)."""
    jds, tds = _datasets()
    seeds = np.arange(N)
    kw = dict(batch_size=16, frontier_cap=8, node_capacity=32, seed=1,
              with_edge=False, overflow_fallback=fallback)
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
