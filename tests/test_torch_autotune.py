"""The port's exact-shape autotune seam against glt_tpu's, on the CPU.

``glt_tpu`` memoizes a kernel point per exact (row width, batch, dtype)
and (batch, fanout, dtype), and a route per (B, S, cap) and (H, C).  The
same shapes through both packages fill the same keys: ``glt_tpu`` pins
"xla" off the TPU, the port pins "plain" off the card, neither with a
timing.  The launch grids hold their default point and prune by dtype
as ``glt_tpu``'s do; the resolvers the kernel wrappers call return the
memoized point for its exact key only.  Both packages' ``NodeLoader``s
leave the same keys, and ``route='auto'`` fills the routing tables as
``glt_tpu``'s samplers do on 1 x 4, 2 x 2 and 4 x 1 meshes.  The card's
half (every point ``torch.equal`` to the plain version, the sweep under a
capture, a point outside the build) is in ``tests/test_torch_kernels.py``.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data.topology import CSRTopo as JaxTopo
from glt_tpu.loader import NeighborLoader as JaxLoader
from glt_tpu.ops import gather_pallas as jgather
from glt_tpu.ops import sample_pallas as jsample
from glt_tpu.parallel import dist_hetero_sampler as jhet
from glt_tpu.parallel import dist_sampler as jdist
from glt_tpu.parallel import sharding as jshard
from glt_tpu_torch import ops
from glt_tpu_torch.data import CSRTopo, Dataset
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.obs import metrics
from glt_tpu_torch.ops import cuda_limits, gather_cuda, sample_cuda
from glt_tpu_torch.parallel import (
    DistHeteroNeighborSampler,
    DistNeighborSampler,
    Mesh,
    autotune_routing,
    global_mesh_2d,
    shard_graph,
    shard_hetero_graph,
)
from glt_tpu_torch.parallel import dist_sampler as tdist
from glt_tpu_torch.store import quant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _fresh_tables():
    """Every test starts and ends with both packages' tables empty."""
    def clear():
        for mod in (jgather, jsample, gather_cuda, sample_cuda):
            mod.reset_autotune()
        for mod in (jdist, tdist):
            mod._ROUTE_AUTO.clear()
            mod._TOPO_AUTO.clear()
        tdist._ROUTE_TIMES.clear()
        tdist._TOPO_TIMES.clear()

    clear()
    yield
    clear()


def _table(n, d, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, d)) * 20
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(x, jnp.float32).astype(jdt),
            torch.from_numpy(x.astype(np.float32)).to(tdt))


# -- the tables' keys ---------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [64, 100, 128])
def test_gather_table_keys_match_jax(dtype, d):
    """A full batch and a capped one: the same keys, "xla" against
    "plain", no timing on either side."""
    jt, tt = _table(300, d, dtype)
    for b in (256, 96):                        # full cap, capped
        idx = np.random.default_rng(b).integers(-1, 300, b).astype(np.int32)
        assert jgather.autotune_gather_rows(jt, jnp.asarray(idx)) == "xla"
        assert ops.autotune_gather_rows(tt, torch.from_numpy(idx)) \
            == "plain"
    jt_, tt_ = jgather.autotune_table(), ops.autotune_table()
    assert sorted(tt_) == sorted(jt_) == sorted(
        f"d{d}_b{b}_{dtype}" for b in (256, 96))
    for k in jt_:
        assert jt_[k] == {"winner": "xla", "ms": {}}
        assert tt_[k] == {"winner": "plain", "ms": {}}


def test_gather_table_key_of_a_compressed_store_matches_jax():
    """The dequantizing arm shares the raw table's key space: an int8
    store's key names its storage dtype."""
    x = np.random.default_rng(1).standard_normal((200, 16)).astype(
        np.float32)
    enc, spec = quant.encode(x, "int8")
    idx = np.arange(64, dtype=np.int32)
    jgather.autotune_gather_rows(jnp.asarray(enc), jnp.asarray(idx))
    assert ops.autotune_gather_rows(torch.from_numpy(enc),
                                    torch.from_numpy(idx),
                                    dequant=spec) == "plain"
    assert list(ops.autotune_table()) == list(jgather.autotune_table()) \
        == ["d16_b64_int8"]


def test_sample_table_keys_match_jax():
    rng = np.random.default_rng(0)
    indptr = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 50))])
    indices = rng.integers(0, 50, indptr[-1])
    for b in (32, 48):
        seeds = rng.integers(-1, 50, b).astype(np.int32)
        assert jsample.autotune_sample(
            jnp.asarray(indptr, jnp.int32), jnp.asarray(indices, jnp.int32),
            jnp.asarray(seeds), 5) == "xla"
        assert ops.autotune_sample(
            torch.from_numpy(indptr.astype(np.int32)),
            torch.from_numpy(indices.astype(np.int32)),
            torch.from_numpy(seeds), 5) == "plain"
    jt, tt = jsample.sample_autotune_table(), ops.sample_autotune_table()
    assert sorted(tt) == sorted(jt) == ["b32_f5_int32", "b48_f5_int32"]
    for k in jt:
        assert jt[k] == {"winner": "xla", "ms": {}}
        assert tt[k] == {"winner": "plain", "ms": {}}


def test_sweeps_publish_their_metrics():
    metrics.enable()
    try:
        runs = metrics.counter("glt.gather.autotune_runs", "")
        before = runs.value
        _, tt = _table(10, 8, "float32")
        ops.autotune_gather_rows(tt, torch.arange(4, dtype=torch.int32))
        ops.autotune_gather_rows(tt, torch.arange(4, dtype=torch.int32))
        assert runs.value == before + 1               # memoized: one run
        snap = metrics.snapshot()
        assert any(k.startswith("glt.gather.cuda_selected") for k in snap)
        srun = metrics.counter("glt.sample.autotune_runs", "")
        s0 = srun.value
        ip = torch.tensor([0, 2, 3], dtype=torch.int32)
        ops.autotune_sample(ip, torch.tensor([1, 0, 1], dtype=torch.int32),
                            torch.tensor([0, 1], dtype=torch.int32), 2)
        assert srun.value == s0 + 1
    finally:
        metrics.disable()


# -- the grids ------------------------------------------------------------------
def test_default_points_are_todays_launches():
    assert gather_cuda.default_gather_params() == (256, 16, 16)
    assert sample_cuda.default_sample_params() == (256, "fit")
    # The fit rule: min(32, next_pow2(F)) lanes, as csrc/sample.cu had it.
    for f, g in ((1, 1), (2, 2), (3, 4), (5, 8), (15, 16), (16, 16),
                 (17, 32), (40, 32), (2048, 32)):
        assert sample_cuda.lanes_per_row(f) == g
        assert sample_cuda.launch_params(f) == (256, g)
        assert sample_cuda.lanes_per_row(f, "warp") == 32


@pytest.mark.parametrize("d", [1, 3, 64, 100, 128, 256])
@pytest.mark.parametrize("dequant", [False, True])
def test_default_point_leads_every_gather_grid(d, dequant):
    for _, tdt in DTYPES.values():
        if dequant and tdt == torch.float32:
            continue
        grid = gather_cuda.candidate_gather_params(d, tdt, dequant=dequant)
        assert grid[0] == gather_cuda.default_gather_params()
        assert len(set(grid)) == len(grid) <= 18
        for t, c, v in grid:
            assert t in gather_cuda.CANDIDATE_THREADS
            assert c in gather_cuda.CANDIDATE_BLOCKS_PER_SM
            assert v in gather_cuda.CANDIDATE_VEC_BYTES


def test_gather_grids_prune_by_dtype_as_jax():
    """Narrower elements leave fewer points in both packages (glt_tpu at
    its lane width: sublane floors; the port at the products width:
    vector widths the row pitch cannot take), and the default point
    always stays."""
    jn = [len(jgather.candidate_gather_params(128, jdt))
          for jdt, _ in DTYPES.values()]
    tn = [len(gather_cuda.candidate_gather_params(100, tdt))
          for _, tdt in DTYPES.values()]
    assert jn[0] > jn[1] > jn[2]
    assert tn[0] > tn[1] > tn[2]
    assert tn == [18, 13, 7]
    # A 100-byte int8 row takes 4-byte units only: the 6 (threads, cap)
    # points at v4, and the default.
    grid = gather_cuda.candidate_gather_params(100, torch.int8)
    assert sorted({v for _, _, v in grid}) == [4, 16]
    assert sum(v == 16 for _, _, v in grid) == 1
    # B4's unit is its f32 output: 16 bytes when d % 4 == 0, else 4.
    assert {v for _, _, v in gather_cuda.candidate_gather_params(
        100, torch.int8, dequant=True)} == {4, 16}
    assert len(gather_cuda.candidate_gather_params(
        3, torch.int8, dequant=True)) == 7


def test_sample_grid():
    grid = sample_cuda.candidate_sample_params()
    assert grid[0] == sample_cuda.default_sample_params()
    assert len(grid) == len(set(grid)) == 6
    assert len(jsample.candidate_sample_params()) == 8
    # At F >= 17 the two lane rules launch alike: 3 distinct points.
    for f, n in ((5, 6), (16, 6), (17, 3), (40, 3)):
        assert len({sample_cuda.launch_params(f, p) for p in grid}) == n


def test_thread_counts_are_the_built_ones():
    """The kernels are built for exactly the swept thread counts."""
    src = open(os.path.join(REPO, "glt_tpu_torch", "csrc",
                            "launch.cuh")).read()
    built = tuple(int(x) for x in re.findall(r"case (\d+):", src))
    assert built == gather_cuda.CANDIDATE_THREADS == \
        sample_cuda.CANDIDATE_THREADS
    assert all(t % cuda_limits.WARP == 0
               and t <= cuda_limits.MAX_THREADS_PER_BLOCK for t in built)
    assert max(sample_cuda.dynamic_smem_bytes(
        sample_cuda.MAX_FANOUT, r, i) for r in (False, True)
        for i in (False, True)) <= cuda_limits.MAX_DYNAMIC_SMEM_BYTES


# -- the resolvers the wrappers call --------------------------------------------
def test_gather_resolver_reads_the_exact_key():
    point = (512, 8, 4)
    gather_cuda._AUTO[(100, 1024, "float32")] = point
    assert gather_cuda.resolve_gather_params(100, 1024,
                                             torch.float32) == point
    default = gather_cuda.default_gather_params()
    for d, b, dt in ((100, 1023, torch.float32), (100, 1024, torch.int8),
                     (64, 1024, torch.float32)):
        assert gather_cuda.resolve_gather_params(d, b, dt) == default
    # A key pinned to the plain version (a CPU table) launches the default.
    gather_cuda._AUTO[(100, 7, "float32")] = None
    assert gather_cuda.resolve_gather_params(100, 7, torch.float32) \
        == default


def test_sample_resolver_reads_the_exact_key():
    sample_cuda._AUTO[(19200, 5, "int32")] = (128, 32)
    assert sample_cuda.auto_params(19200, 5, torch.int32) == (128, 32)
    assert sample_cuda.auto_params(19201, 5, torch.int32) is None
    assert sample_cuda.auto_params(19200, 10, torch.int32) is None


def test_cpu_seams_ignore_the_tables():
    """A CPU tensor takes the plain version whatever the tables hold, and
    launches no kernel wrapper."""
    rng = np.random.default_rng(3)
    tab = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-1, 60, 33).astype(np.int32))
    gather_cuda._AUTO[(8, 33, "float32")] = (128, 8, 4)
    b2 = gather_cuda.gather_rows_cuda.launches
    assert torch.equal(ops.gather_rows(tab, idx),
                       ops.gather_rows_plain(tab, idx))
    assert gather_cuda.gather_rows_cuda.launches == b2


# -- NodeLoader --------------------------------------------------------------------
def _datasets(n=80, d=5):
    rng = np.random.default_rng(0)
    src = np.repeat(np.arange(n), rng.integers(0, 7, n))
    ei = np.stack([src, rng.integers(0, n, src.size)])
    feat = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    jds = (JaxDataset().init_graph(ei, graph_mode="HOST", num_nodes=n)
           .init_node_features(feat).init_node_labels(labels))
    tds = (Dataset(device="cpu").init_graph(ei, num_nodes=n)
           .init_node_features(feat).init_node_labels(labels))
    return jds, tds


@pytest.mark.parametrize("capped", [False, True])
def test_node_loaders_leave_the_same_keys(capped):
    jds, tds = _datasets()
    kw = dict(batch_size=16, seed=1, with_edge=False)
    if capped:
        kw.update(frontier_cap=8, node_capacity=32)
    jl = JaxLoader(jds, [4, 4], np.arange(40), sample_force="xla", **kw)
    tl = NeighborLoader(tds, [4, 4], np.arange(40), **kw)
    assert tl.sampler.node_capacity == jl.sampler.node_capacity
    want = {f"d5_b{tl.sampler.node_capacity}_float32":
            {"winner": "plain", "ms": {}}}
    assert ops.autotune_table() == want
    assert list(jgather.autotune_table()) == list(want)
    # glt_tpu sweeps the sampler on the TPU only, the port on the card.
    assert ops.sample_autotune_table() == jsample.sample_autotune_table() \
        == {}
    assert len(list(tl)) == 3


# -- routing ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_autotune_routing_fills_the_tables_as_jax(shape):
    for b, cap in ((24, None), (96, 40)):
        want = jdist.autotune_routing(b, 4, cap=cap, mesh_shape=shape)
        got = autotune_routing(b, 4, cap=cap, mesh_shape=shape,
                               device="cpu")
        assert got == want
    assert autotune_routing(64, 32, device="cpu") == \
        jdist.autotune_routing(64, 32) == "sort"
    assert tdist._ROUTE_AUTO == jdist._ROUTE_AUTO
    assert tdist._TOPO_AUTO == jdist._TOPO_AUTO == {
        shape: "hier" if shape == (2, 2) else "flat"}
    assert all(t == {} for t in tdist._ROUTE_TIMES.values())


def test_route_choice_reads_the_table():
    assert tdist._route_choice(24, 4, 24, "auto") == "onepass"
    tdist._ROUTE_AUTO[(24, 4, 24)] = "sort"
    assert tdist._route_choice(24, 4, 24, "auto") == "sort"
    assert tdist._route_choice(24, 4, 24, "onepass") == "onepass"
    assert tdist._route_choice(25, 4, 25, "auto") == "onepass"
    axes = ("host", "chip")
    assert tdist._topology_choice("auto", axes, (2, 2)) == "hier"
    tdist._TOPO_AUTO[(2, 2)] = "flat"
    assert tdist._topology_choice("auto", axes, (2, 2)) == "flat"
    assert tdist._topology_choice("hier", axes, (2, 2)) == "hier"
    assert tdist._topology_choice("auto", "shard", (2, 2)) == "flat"
    with pytest.raises(ValueError):
        tdist._route_choice(4, 4, 4, "fast")


def test_one_process_agrees_with_itself():
    """Across processes rank 0's route is broadcast; in one process, or
    on a mesh that does not span processes, a choice stands as made."""
    from glt_tpu_torch.parallel import multihost

    assert multihost.agree_first("hier") == "hier"
    assert tdist._agree(Mesh(["cpu"] * 4), "sort") == "sort"
    assert tdist._agree(None, "onepass") == "onepass"


def _graph_pair(s=4):
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, 64, 300), rng.integers(0, 64, 300)])
    return (jshard.shard_graph(JaxTopo(ei, num_nodes=64), s),
            shard_graph(CSRTopo(ei, num_nodes=64), s, device="cpu"))


@pytest.mark.parametrize("shape", [None, (1, 4), (2, 2), (4, 1)])
def test_auto_route_samplers_fill_the_tables_as_jax(shape):
    jg, tg = _graph_pair()
    devs = np.array(jax.devices()[:4])
    if shape is None:
        jm, tm = JaxMesh(devs, ("shard",)), Mesh(["cpu"] * 4)
    else:
        jm = JaxMesh(devs.reshape(shape), ("host", "chip"))
        tm = global_mesh_2d(["cpu"] * 4, num_hosts=shape[0])
    kw = dict(num_neighbors=[3, 2], batch_size=4, frontier_cap=10)
    js = jdist.DistNeighborSampler(jg, jm, route="auto", **kw)
    ts = DistNeighborSampler(tg, tm, route="auto", **kw)
    assert ts.route == js.route == "onepass"
    assert tdist._ROUTE_AUTO == jdist._ROUTE_AUTO == {(10, 4, 10):
                                                      "onepass"}
    assert tdist._TOPO_AUTO == jdist._TOPO_AUTO
    # An explicit route fills nothing.
    tdist._ROUTE_AUTO.clear()
    assert DistNeighborSampler(tg, tm, route="sort", **kw).route == "sort"
    assert tdist._ROUTE_AUTO == {}


def test_auto_route_hetero_sampler_fills_the_table_as_jax():
    rng = np.random.default_rng(0)
    ui = np.stack([rng.integers(0, 40, 120), rng.integers(0, 24, 120)])
    eis = {("user", "to", "item"): (ui, 40),
           ("item", "rev", "user"): (ui[::-1].copy(), 24)}
    jsh = jhet.shard_hetero_graph(
        {et: JaxTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, 4)
    tsh = shard_hetero_graph(
        {et: CSRTopo(e, num_nodes=n) for et, (e, n) in eis.items()}, 4,
        device="cpu")
    jm = JaxMesh(np.array(jax.devices()[:4]), ("shard",))
    js = jhet.DistHeteroNeighborSampler(jsh, jm, [3, 2], "user",
                                        batch_size=4, route="auto")
    ts = DistHeteroNeighborSampler(tsh, Mesh(["cpu"] * 4), [3, 2], "user",
                                   batch_size=4, route="auto")
    assert ts.route == js.route
    assert tdist._ROUTE_AUTO == jdist._ROUTE_AUTO != {}
