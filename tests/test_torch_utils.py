"""The port's ``utils`` and four public names against ``glt_tpu``'s on the
CPU.

Seeded numpy inputs go through both packages and compare with ``==``:
the size units, the exit flag, the topology conversions (values and
dtypes, stable-sort ties), the array helpers, the hetero merge and
format helpers over outputs that both packages' ``HeteroNeighborSampler``
draw from one seed, and ``ThroughputMeter`` under one patched clock.
``trace(device="cpu")`` writes a Chrome trace that names the annotated
region, and ``trace()`` raises without CUDA.  ``ops.dedup_counts``,
``sampler.SamplingConfig``, ``sampler.BaseSampler`` and
``typing.SamplingType`` equal ``glt_tpu``'s.  The JAX sampler runs its
XLA arm (``GLT_SAMPLE_FORCE=xla``), as ``glt_tpu``'s own tests run it on
the CPU.
"""
import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glt_tpu.utils as jutils
from examples import datasets as jax_datasets
from glt_tpu import typing as jtyping
from glt_tpu.ops.dedup_gather import dedup_counts as jax_dedup_counts
from glt_tpu.sampler import NodeSamplerInput as JaxNodeInput
from glt_tpu.sampler import base as jbase
from glt_tpu.sampler import hetero_neighbor_sampler as jhns
from glt_tpu.utils import common as jcommon
from glt_tpu.utils import exit_status as jexit
from glt_tpu.utils import profile as jprofile
from glt_tpu.utils import tensor as jtensor
from glt_tpu.utils import topo as jtopo
from glt_tpu.utils import units as junits
from glt_tpu_torch import ops
from glt_tpu_torch import typing as ttyping
from glt_tpu_torch import utils as tutils
from glt_tpu_torch.data import topology as ttopology
from glt_tpu_torch.examples import datasets as tdatasets
from glt_tpu_torch.sampler import (
    BaseSampler,
    HeteroNeighborSampler,
    NeighborSampler,
    NodeSamplerInput,
    SamplingConfig,
)
from glt_tpu_torch.utils import common as tcommon
from glt_tpu_torch.utils import exit_status as texit
from glt_tpu_torch.utils import profile as tprofile
from glt_tpu_torch.utils import tensor as ttensor
from glt_tpu_torch.utils import topo as ttopo
from glt_tpu_torch.utils import units as tunits

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _same(a, b, what=""):
    """Equal values, shapes and dtypes (numpy on both sides)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_utils_exports_jax_names_and_resolve_device():
    assert tutils.__all__ == list(jutils.__all__) + ["resolve_device"]
    for name in tutils.__all__:
        assert callable(getattr(tutils, name)), name


@pytest.mark.parametrize("size", [
    0, 17, 4096, 2.5, "1KB", "1.5GB", " 256mb ", "3 T", "7B", "12", ".5K",
    "1PB", "abc", "1.2.3MB", "-1MB",
])
def test_parse_size_matches_jax(size):
    try:
        want = junits.parse_size(size)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tunits.parse_size(size)
        assert str(got.value) == str(exc)
        return
    assert tunits.parse_size(size) == want


def test_format_size_matches_jax():
    rng = np.random.default_rng(0)
    sizes = [0, 1, 1023, 1024, 1536, 2**20, 2**30 + 5, 2**40 * 3, -2048]
    sizes += [int(v) for v in rng.integers(0, 2**45, 64)]
    for n in sizes:
        assert tunits.format_size(n) == junits.format_size(n), n


def test_exit_flag_matches_jax(monkeypatch):
    assert texit.is_exiting() is jexit.is_exiting() is False
    monkeypatch.setattr(texit, "_EXITING", False)
    texit._mark_exit()
    assert texit.is_exiting() is True


@pytest.mark.parametrize("seed,n,e,with_ids,num_nodes", [
    (0, 10, 40, False, None),
    (1, 7, 100, True, None),      # heavy row ties: the stable sort
    (2, 50, 30, False, 64),       # isolated tail nodes
    (3, 5, 0, False, None),       # no edges
    (4, 5, 0, True, 9),
])
def test_topology_conversions_match_jax(seed, n, e, with_ids, num_nodes):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e).astype(np.int32)
    col = rng.integers(0, n, e)
    eids = rng.permutation(e) + 100 if with_ids else None
    for perm in (False, True):
        got = ttopo.coo_to_csr(row, col, eids, num_nodes, return_perm=perm)
        want = jtopo.coo_to_csr(row, col, eids, num_nodes, return_perm=perm)
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"coo_to_csr[{i}]")
    for g, w in zip(ttopo.coo_to_csc(row, col, eids, num_nodes),
                    jtopo.coo_to_csc(row, col, eids, num_nodes)):
        _same(g, w, "coo_to_csc")
    indptr, indices, _ = jtopo.coo_to_csr(row, col, eids, num_nodes)
    for g, w in zip(ttopo.csr_to_coo(indptr, indices),
                    jtopo.csr_to_coo(indptr, indices)):
        _same(g, w, "csr_to_coo")
    _same(ttopo.ptr2ind(indptr), jtopo.ptr2ind(indptr), "ptr2ind")
    _same(ttopo.degrees_from_ptr(indptr), jtopo.degrees_from_ptr(indptr),
          "degrees_from_ptr")


def test_topology_module_reuses_utils_topo():
    """``data.topology`` keeps no copy of its own: its names are
    ``utils.topo``'s, as ``glt_tpu/data/topology.py`` imports them."""
    assert ttopology.coo_to_csr is ttopo.coo_to_csr
    assert ttopology.csr_to_coo is ttopo.csr_to_coo
    with pytest.raises(ValueError):
        ttopo.coo_to_csr(np.zeros(3), np.zeros(2))


@pytest.mark.parametrize("seed,size", [(0, None), (1, 40), (2, None)])
def test_id2idx_and_array_helpers_match_jax(seed, size):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(30)[: rng.integers(1, 30)]
    _same(ttensor.id2idx(ids, size), jtensor.id2idx(ids, size), "id2idx")
    _same(ttensor.id2idx(torch.from_numpy(ids), size),
          jtensor.id2idx(ids, size), "id2idx of a tensor")
    _same(ttensor.id2idx(np.array([], np.int64)),
          jtensor.id2idx(np.array([], np.int64)), "empty id2idx")
    x = rng.standard_normal((7, 3)).astype(np.float32)
    for n in (0, 4, 7, 12):
        _same(ttensor.pad_to(x, n, -1.0), jtensor.pad_to(x, n, -1.0),
              f"pad_to {n}")
    for v in [x, [1, 2, 3], (4.5,)]:
        _same(ttensor.ensure_numpy(v), jtensor.ensure_numpy(v), "ensure_numpy")
    _same(ttensor.ensure_numpy(torch.from_numpy(x)), x, "tensor to numpy")
    for n in list(range(-2, 70)) + [2**20 - 1, 2**20, 2**20 + 1]:
        assert ttensor.next_power_of_two(n) == jtensor.next_power_of_two(n)


def test_ensure_device_names_its_device():
    x = np.arange(6, dtype=np.int64).reshape(2, 3)
    t = ttensor.ensure_device(x, device="cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), x)
    for dt in (np.int32, torch.int32, "int32"):
        got = ttensor.ensure_device(x, dtype=dt, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jtensor.ensure_device(x, dtype=jnp.int32)))
    f = ttensor.ensure_device(torch.ones(3), dtype=torch.bfloat16,
                              device="cpu")
    assert f.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttensor.ensure_device(x)


@pytest.fixture(scope="module")
def igbh_outputs():
    """Two hetero outputs of each package, drawn from one seed, with
    zero-width edge types (fanout 0 at the second hop of one type)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GLT_SAMPLE_FORCE", "xla")
        jds, _, _ = jax_datasets.synthetic_igbh(scale=0.01)
        tds, _, _ = tdatasets.synthetic_igbh(scale=0.01, device="cpu")
        ets = tds.get_edge_types()
        nn = {et: ([2, 0] if i == 0 else [2, 1]) for i, et in enumerate(ets)}
        js = jhns.HeteroNeighborSampler(jds.graph, nn, "paper",
                                        batch_size=4, seed=5)
        ts = HeteroNeighborSampler(tds.graph, nn, "paper", batch_size=4,
                                   seed=5)
        seeds = (np.arange(4), np.array([7, 7, 0, -1]))
        jouts = [js.sample_from_nodes(JaxNodeInput(s)) for s in seeds]
        touts = [ts.sample_from_nodes(NodeSamplerInput(s)) for s in seeds]
    return jouts, touts


def _same_dict(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    assert sorted(a) == sorted(b), what
    for k in a:
        _same(np.asarray(a[k]), b[k].numpy(), f"{what}[{k}]")


_HETERO_FIELDS = ("node", "row", "col", "edge", "batch", "node_mask",
                  "edge_mask", "num_sampled_nodes", "num_sampled_edges")


def _same_hetero(jout, tout):
    for f in _HETERO_FIELDS:
        _same_dict(getattr(jout, f), getattr(tout, f), f)
    assert tout.input_type == jout.input_type
    assert tout.metadata == jout.metadata


def test_hetero_merge_and_format_match_jax(igbh_outputs):
    (ja, jb), (ta, tb) = igbh_outputs
    _same_hetero(ja, ta)                          # the inputs agree
    _same_hetero(jcommon.merge_hetero_sampler_output(ja, jb),
                 tcommon.merge_hetero_sampler_output(ta, tb))
    for jo, to in ((ja, ta), (jcommon.merge_hetero_sampler_output(ja, jb),
                              tcommon.merge_hetero_sampler_output(ta, tb))):
        jf = jcommon.format_hetero_sampler_output(jo)
        tf = tcommon.format_hetero_sampler_output(to)
        _same_hetero(jf, tf)
        assert all(r.shape[0] > 0 for r in tf.row.values())
        assert len(tf.row) < len(to.row)          # empty types dropped


def test_hetero_merge_with_missing_fields_matches_jax(igbh_outputs):
    (ja, _), (ta, _) = igbh_outputs
    jn = dataclasses.replace(ja, edge_mask=None, batch=None)
    tn = dataclasses.replace(ta, edge_mask=None, batch=None)
    _same_hetero(jcommon.merge_hetero_sampler_output(jn, ja),
                 tcommon.merge_hetero_sampler_output(tn, ta))
    _same_hetero(jcommon.merge_hetero_sampler_output(ja, jn),
                 tcommon.merge_hetero_sampler_output(ta, tn))


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` steps through ticks."""

    def __init__(self, ticks):
        self._ticks = iter(ticks)

    def perf_counter(self):
        return next(self._ticks)


def test_throughput_meter_matches_jax(monkeypatch):
    ticks = [10.0, 10.25, 11.0, 13.5]
    meters = []
    for mod in (jprofile, tprofile):
        monkeypatch.setattr(mod, "time", _Clock(ticks))
        m = mod.ThroughputMeter()
        assert m.rate("edges") == 0.0 and m.summary() == {}
        with m.measure():
            m.add(edges=1000, batches=2)
        m.add(edges=24)
        with m.measure():
            m.add(batches=1.5)
        meters.append(m)
    jm, tm = meters
    assert tm.elapsed == jm.elapsed == 2.75
    for k in ("edges", "batches", "absent"):
        assert tm.rate(k) == jm.rate(k)
    assert tm.summary() == jm.summary()


def test_trace_on_the_cpu_names_the_annotated_region(tmp_path):
    with tprofile.trace(str(tmp_path), device="cpu") as prof:
        with tprofile.annotate("glt_region"):
            torch.ones(64).cumsum(0)
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    assert prof.trace_file == path
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    (region,) = [e for e in events if e.get("name") == "glt_region"]
    assert region["cat"] == "user_annotation"
    ops_inside = [e["name"] for e in events if e.get("cat") == "cpu_op"
                  and region["ts"] <= e["ts"] <= region["ts"] + region["dur"]]
    assert any("cumsum" in n for n in ops_inside), ops_inside
    assert tprofile.trace_kernels(path) == {}          # no device here


def test_trace_kernels_counts_launches_inside_a_region(tmp_path):
    """Kernels count under the region whose range holds the host call
    that launched them (a kernel launch or a graph replay, matched by
    correlation id), whenever they ran on the device."""
    def ev(cat, name, ts, dur=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "step", 100, 50),
        ev("user_annotation", "other", 200, 50),
        ev("cuda_runtime", "cudaGraphLaunch", 110, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 210, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 300, corr=3),
        ev("kernel", "void sample_kernel(Args)", 400, corr=1),
        ev("kernel", "void sample_kernel(Args)", 410, corr=1),
        ev("kernel", "fused_frontier_kernel", 420, corr=1),
        ev("kernel", "void sample_kernel(Args)", 430, corr=2),
        ev("kernel", "threefry_hash_kernel", 440, corr=3),
        ev("kernel", "orphan", 450, corr=9),
        ev("gpu_memcpy", "Memcpy HtoD", 460, corr=1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tprofile.trace_kernels(str(path), "step") == {
        "void sample_kernel(Args)": 2, "fused_frontier_kernel": 1}
    assert tprofile.trace_kernels(str(path), "other") == {
        "void sample_kernel(Args)": 1}
    assert tprofile.trace_kernels(str(path), "absent") == {}
    assert tprofile.trace_kernels(str(path)) == {
        "void sample_kernel(Args)": 3, "fused_frontier_kernel": 1,
        "threefry_hash_kernel": 1, "orphan": 1}


def test_trace_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: trace() would record it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with tprofile.trace("unused"):
            pass


@pytest.mark.parametrize("case", ["all_padding", "all_unique",
                                  "heavy_duplicates", "mixed", "empty"])
def test_dedup_counts_matches_jax(case):
    rng = np.random.default_rng(3)
    ids = {
        "all_padding": np.full(64, -1),
        "all_unique": rng.permutation(1000)[:64],
        "heavy_duplicates": rng.integers(0, 5, 256),
        "mixed": np.where(rng.random(300) < 0.3, -1,
                          rng.integers(0, 40, 300)),
        "empty": np.zeros(0, np.int64),
    }[case].astype(np.int32)
    jv, ju = jax_dedup_counts(jnp.asarray(ids))
    tv, tu = ops.dedup_counts(torch.from_numpy(ids))
    for t in (tv, tu):
        assert t.dtype == torch.int32 and t.dim() == 0
    assert (int(tv), int(tu)) == (int(jv), int(ju))
    assert "dedup_counts" in ops.__all__


def test_sampling_config_matches_jax():
    tf = [(f.name, f.default) for f in dataclasses.fields(SamplingConfig)]
    jf = [(f.name, f.default)
          for f in dataclasses.fields(jbase.SamplingConfig)]
    assert tf == jf
    cfg = SamplingConfig(num_neighbors=[15, 10], batch_size=64)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.batch_size = 8
    assert dataclasses.astuple(cfg) == dataclasses.astuple(
        jbase.SamplingConfig(num_neighbors=[15, 10], batch_size=64))


def test_base_sampler_matches_jax():
    assert BaseSampler.__abstractmethods__ == \
        jbase.BaseSampler.__abstractmethods__
    with pytest.raises(TypeError):
        BaseSampler()
    assert issubclass(NeighborSampler, BaseSampler)
    assert issubclass(HeteroNeighborSampler, BaseSampler)


def test_sampling_type_matches_jax():
    assert [(m.name, m.value) for m in ttyping.SamplingType] == \
        [(m.name, m.value) for m in jtyping.SamplingType]
