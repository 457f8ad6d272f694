"""glt_tpu_torch NeighborSampler against glt_tpu's, field by field.

Same graph, seed and call count; dedup in {dense, sort} x
last_hop_dedup in {True, False}, uncapped and under occupancy caps that
do and do not overflow; every SamplerOutput field, the overflow flag
included, compares with ==.
"""
import jax
import numpy as np
import pytest
import torch

from glt_tpu.data import CSRTopo as JaxTopo
from glt_tpu.data import Graph as JaxGraph
from glt_tpu.sampler import NeighborSampler as JaxSampler
from glt_tpu.sampler import NodeSamplerInput as JaxInput
from glt_tpu.sampler import calibrate_node_capacity as jax_calibrate
from glt_tpu.sampler.neighbor_sampler import measure_occupancy as jax_occ
from glt_tpu.sampler.neighbor_sampler import hop_widths as jax_widths
from glt_tpu.sampler.neighbor_sampler import max_sampled_nodes as jax_cap
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.sampler import (
    NeighborSampler,
    NodeSamplerInput,
    calibrate_node_capacity,
    hop_widths,
    max_sampled_nodes,
    measure_occupancy,
)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

FIELDS = ("node", "row", "col", "edge", "batch", "node_mask", "edge_mask",
          "num_sampled_nodes", "num_sampled_edges")


def _coo(n=120, seed=0):
    """Power-law-ish COO in shuffled order (non-positional edge ids
    after the CSR sort) with a hub and isolated nodes."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, n), 60)
    deg[:3] = [0, 90, 1]
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    perm = rng.permutation(src.size)
    return np.stack([src[perm], dst[perm]]), n


def _graphs(edges):
    ei, n = _coo()
    if edges == "positional":
        order = np.argsort(ei[0], kind="stable")
        ei = ei[:, order]
    jt, tt = JaxTopo(ei, num_nodes=n), CSRTopo(ei, num_nodes=n)
    return JaxGraph(jt), Graph(tt, device="cpu"), n


def _compare(jout, tout):
    for f in FIELDS:
        a, b = getattr(jout, f), getattr(tout, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert tuple(b.shape) == tuple(np.shape(a)), f
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
    if jout.metadata is None:
        assert tout.metadata is None
        return
    assert sorted(tout.metadata) == sorted(jout.metadata)
    for k, a in jout.metadata.items():
        np.testing.assert_array_equal(np.asarray(a),
                                      tout.metadata[k].numpy(), err_msg=k)


@pytest.mark.parametrize("dedup", ["dense", "sort"])
@pytest.mark.parametrize("last_hop_dedup", [True, False])
@pytest.mark.parametrize("edges", ["positional", "explicit", "none"])
def test_sample_from_nodes_matches_jax(dedup, last_hop_dedup, edges):
    jg, tg, n = _graphs(edges)
    assert (tg.gather_edge_ids is None) == (edges == "positional" or
                                             jg.gather_edge_ids is None)
    kw = dict(batch_size=16, seed=3, dedup=dedup,
              last_hop_dedup=last_hop_dedup, with_edge=edges != "none")
    js = JaxSampler(jg, [5, 3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tg, [5, 3, 2], **kw)
    rng = np.random.default_rng(1)
    batches = [np.array([1, 0, 1, 7, 9, 1, 33], np.int64),
               rng.integers(0, n, 16), np.array([2], np.int64)]
    for seeds in batches:           # the call counter advances the key
        _compare(js.sample_from_nodes(JaxInput(seeds)),
                 ts.sample_from_nodes(NodeSamplerInput(seeds)))
    assert ts.node_capacity == js.node_capacity
    assert ts.edge_capacity == js.edge_capacity


@pytest.mark.parametrize("frontier_cap", [None, 20])
def test_frontier_cap_and_capacity(frontier_cap):
    for fan in ([15, 10, 5], [4]):
        assert hop_widths(8, fan, frontier_cap) == jax_widths(
            8, fan, frontier_cap)
        assert max_sampled_nodes(8, fan, frontier_cap) == jax_cap(
            8, fan, frontier_cap)
    jg, tg, _ = _graphs("positional")
    js = JaxSampler(jg, [4, 3], batch_size=8, frontier_cap=frontier_cap,
                    sample_force="xla")
    ts = NeighborSampler(tg, [4, 3], batch_size=8, frontier_cap=frontier_cap)
    seeds = np.arange(1, 9)
    _compare(js.sample_from_nodes(JaxInput(seeds)),
             ts.sample_from_nodes(NodeSamplerInput(seeds)))


def test_tensor_seeds_and_validation():
    _, tg, _ = _graphs("positional")
    ts = NeighborSampler(tg, [3], batch_size=4)
    out = ts.sample_from_nodes(NodeSamplerInput(
        torch.tensor([1, 2, -1, -1], dtype=torch.int32)))
    assert out.node[:2].tolist() == [1, 2]
    with pytest.raises(ValueError):
        ts.sample_from_nodes(NodeSamplerInput(np.arange(5)))
    with pytest.raises(ValueError):
        NeighborSampler(tg, [3], dedup="hash")


# Frontier cap 20 on fanouts [5, 3, 2] at batch 16: hop widths
# [16, 20, 20], full capacity 196, frontier floor 56 (96 with the
# 40-slot leaf block); these batches hold 59-81 uniques.  Per
# last_hop_dedup: (cap that overflows, cap that does not).
_CAPS = {True: (64, 128), False: (96, 160)}


def _capped_pair(tg, jg, dedup, last_hop_dedup, cap, seed=4):
    kw = dict(batch_size=16, frontier_cap=20, seed=seed, dedup=dedup,
              last_hop_dedup=last_hop_dedup, with_edge=True)
    return (JaxSampler(jg, [5, 3, 2], sample_force="xla",
                       node_capacity=cap, **kw),
            NeighborSampler(tg, [5, 3, 2], node_capacity=cap, **kw))


@pytest.mark.parametrize("dedup", ["dense", "sort"])
@pytest.mark.parametrize("last_hop_dedup", [True, False])
@pytest.mark.parametrize("overflows", [True, False])
def test_capped_sampler_matches_jax(dedup, last_hop_dedup, overflows):
    jg, tg, n = _graphs("explicit")
    cap = _CAPS[last_hop_dedup][0 if overflows else 1]
    js, ts = _capped_pair(tg, jg, dedup, last_hop_dedup, cap)
    assert ts.capped and js.capped
    assert ts.node_capacity == js.node_capacity == cap
    rng = np.random.default_rng(7)
    flags = []
    for _ in range(4):
        seeds = rng.integers(0, n, 16)
        jout = js.sample_from_nodes(JaxInput(seeds))
        tout = ts.sample_from_nodes(NodeSamplerInput(seeds))
        _compare(jout, tout)
        flags.append(bool(tout.metadata["overflow"]))
    assert any(flags) == overflows, flags


@pytest.mark.parametrize("last_hop_dedup", [True, False])
def test_calibrate_and_sibling_match_jax(last_hop_dedup):
    jg, tg, n = _graphs("positional")
    kw = dict(batch_size=16, frontier_cap=20, with_edge=False,
              last_hop_dedup=last_hop_dedup)
    jp = JaxSampler(jg, [5, 3, 2], sample_force="xla", **kw)
    tp = NeighborSampler(tg, [5, 3, 2], **kw)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, n, 16) for _ in range(5)]
    jc = jax_occ(jp, batches)
    tc = measure_occupancy(tp, batches)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    for pct, margin, mult in ((99.0, 1.05, 256), (50.0, 1.0, 8)):
        assert calibrate_node_capacity(
            tp, counts=tc, pct=pct, margin=margin, multiple=mult
        ) == jax_calibrate(jp, counts=jc, pct=pct, margin=margin,
                           multiple=mult)
    # The full-capacity sibling: an uncapped twin, built once.
    cap = _CAPS[last_hop_dedup][0]
    js, ts = _capped_pair(tg, jg, "dense", last_hop_dedup, cap)
    sib = ts.full_capacity_sibling()
    assert sib is ts.full_capacity_sibling() and not sib.capped
    assert sib.node_capacity == js.full_capacity_sibling().node_capacity
    assert tp.full_capacity_sibling() is tp
    with pytest.raises(ValueError, match="frontier floor"):
        NeighborSampler(tg, [5, 3, 2], node_capacity=10, **kw)


@pytest.mark.parametrize("cap", [None, 64])
def test_sample_from_nodes_batched_matches_jax(cap):
    """G = 3 batches in one call == ``glt_tpu``'s stacked output, under
    an explicit key and under the call counter (which advances once a
    call, as one ``sample_from_nodes`` does); batch g == the single
    sample under ``split(key, G)[g]``."""
    jg, tg, n = _graphs("explicit")
    kw = dict(batch_size=16, frontier_cap=20, seed=6, node_capacity=cap)
    js = JaxSampler(jg, [5, 3, 2], sample_force="xla", **kw)
    ts = NeighborSampler(tg, [5, 3, 2], **kw)
    seeds = np.random.default_rng(3).integers(-1, n, (3, 16))
    seeds[2] = -1                           # a fully padded batch
    _compare(js.sample_from_nodes_batched(seeds, key=jax.random.PRNGKey(9)),
             ts.sample_from_nodes_batched(
                 seeds, key=trandom.PRNGKey(9, device="cpu")))
    for _ in range(2):
        _compare(js.sample_from_nodes_batched(seeds),
                 ts.sample_from_nodes_batched(torch.from_numpy(seeds)))
    _compare(js.sample_from_nodes(JaxInput(seeds[0])),
             ts.sample_from_nodes(NodeSamplerInput(seeds[0])))
    key = trandom.PRNGKey(4, device="cpu")
    out = ts.sample_from_nodes_batched(seeds, key=key)
    for g, k in enumerate(trandom.split(key, 3)):
        one = ts.sample_from_nodes(NodeSamplerInput(seeds[g]), key=k)
        for f in FIELDS:
            assert torch.equal(getattr(out, f)[g], getattr(one, f)), f
    with pytest.raises(ValueError, match="expected"):
        ts.sample_from_nodes_batched(seeds[:, :8])
