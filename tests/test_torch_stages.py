"""glt_tpu_torch.obs's graph-safe stages, device counters and profiler
ranges.

On the CPU a stage's device half stamps the host clock into a ring of
the card's layout, so the whole bookkeeping runs here: spans open
``torch.profiler`` ranges only while a tracer is installed, stages nest
and share boundaries, marks pair per lane, a wrapped ring counts what it
lost, counters sum, the export's device track validates, and the
sampler, the gather and the node train block emit their stages and
counters.  The ``cuda`` tests hold the card's half: a graph captured
under a tracer stamps at every replay, one captured without launches
exactly the kernels of the code without stages.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from glt_tpu_torch import obs
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.models import (GraphSAGE, adam, create_train_state,
                                  make_gather_xy,
                                  make_scanned_hetero_train_step,
                                  make_scanned_node_train_step)
from glt_tpu_torch.obs import metrics, stages
from glt_tpu_torch.sampler import NeighborSampler

torch.set_num_threads(1)

SAMPLER_STAGES = ("sampler.init", "sampler.draw", "sampler.induce",
                  "sampler.finish")


@pytest.fixture(autouse=True)
def _clean():
    """Tracing off and no ring, counter or mark before and after."""
    obs.install(None)
    stages.reset_for_tests()
    yield
    obs.install(None)
    stages.reset_for_tests()


def _profiled_ranges(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


# -- host spans on the profiler's clock --------------------------------------
@pytest.mark.parametrize("tracing", [True, False])
def test_span_opens_a_profiler_range_only_while_tracing(tracing):
    if tracing:
        obs.start_trace()

    def run():
        with obs.span("glt.test.outer"):
            with obs.span("glt.test.inner"):
                torch.ones(4).sum()

    names = _profiled_ranges(run)
    assert ({"glt.test.outer", "glt.test.inner"} <= names) == tracing
    if not tracing:
        assert not names & {"glt.test.outer", "glt.test.inner"}


def test_span_without_the_profiler_opens_no_range():
    tracer = obs.start_trace()
    with obs.span("glt.test.quiet") as sp:
        assert sp._range is None
    assert [e["name"] for e in tracer.events] == ["glt.test.quiet"]


# -- stages ------------------------------------------------------------------
def test_off_is_the_shared_noop_and_allocates_nothing():
    assert obs.stage("x.a") is stages.NULL_STAGE
    with obs.stage("x.a", device="cpu") as st:
        st.next("x.b")
    obs.device_counter("glt.x", "cpu").add_(torch.tensor(3))
    assert not obs.tracing()
    assert stages._rings == {} and stages._counters == {}
    assert stages.read().spans == []
    assert "glt.x" not in metrics.snapshot()


def test_nesting_next_and_eager_host_halves():
    tracer = obs.start_trace()
    with obs.stage("x.outer", device="cpu", part=1) as outer:
        with obs.stage("x.a", device="cpu") as st:
            st.next("x.b", hop=0)
            st.next("x.b", hop=1)
        outer.next("x.tail")
    r = stages.read()
    got = [(s["name"], s["attrs"], s["depth"]) for s in r.spans]
    # Spans in the order they close; inner ones first.
    assert got == [("x.a", {}, 1), ("x.b", {"hop": 0}, 1),
                   ("x.b", {"hop": 1}, 1), ("x.outer", {"part": 1}, 0),
                   ("x.tail", {}, 0)]
    assert r.lost == r.unmatched == r.open == 0
    # Shared boundaries: 1 + 2 + 1 stamps inside, 1 + 1 + 1 outside.
    assert int(stages._rings["cpu"].cursor[0]) == 7
    spans = {(s["name"], s["attrs"].get("hop")): s for s in r.spans}
    assert spans[("x.a", None)]["t1_ns"] == spans[("x.b", 0)]["t0_ns"]
    assert spans[("x.outer", None)]["t0_ns"] <= spans[("x.a", None)]["t0_ns"]
    # Eagerly each stage is also a host span of its name and attributes.
    host = [(e["name"], e["args"].get("hop")) for e in tracer.events]
    assert sorted(host, key=str) == sorted(
        [("x.a", None), ("x.b", 0), ("x.b", 1), ("x.outer", None),
         ("x.tail", None)], key=str)
    assert r.totals()["x.b"] > 0 and r.counts() == {
        "x.a": 1, "x.b": 2, "x.outer": 1, "x.tail": 1}


def _tag(lane, sid, op):
    return (lane << 32) | (sid << 2) | op


def test_marks_pair_per_lane_and_count_the_unmatched():
    b, e, n = stages._BEGIN, stages._END, stages._NEXT
    rows = [
        [_tag(0, 1, b), 10], [_tag(1, 5, b), 11],   # two lanes interleave
        [_tag(0, 2, n), 20], [_tag(1, 5, e), 25],
        [_tag(0, 2, e), 30],
        [_tag(0, 3, e), 40],                        # its begin was lost
        [_tag(0, 4, n), 50],                        # so was its sibling's
        [_tag(0, 4, e), 60],
        [_tag(0, 6, b), 70], [_tag(0, 7, b), 71],   # an inner end lost
        [_tag(0, 6, e), 90],
        [_tag(2, 8, b), 95],                        # still open
    ]
    spans, unmatched, still_open = stages._pair(rows)
    assert spans == [(0, 0, 1, 10, 20), (1, 0, 5, 11, 25),
                     (0, 0, 2, 20, 30), (0, 0, 4, 50, 60),
                     (0, 0, 6, 70, 90)]
    assert unmatched == 3 and still_open == 1


def test_ring_wrap_keeps_the_newest_and_counts_the_lost(monkeypatch):
    monkeypatch.setattr(stages, "RING_ENTRIES", 8)
    obs.start_trace()
    for i in range(7):                     # 14 stamps into 8 slots
        with obs.stage("x.s", device="cpu", i=i):
            pass
    r = stages.read()
    assert r.lost == 6
    assert [s["attrs"]["i"] for s in r.spans] == [3, 4, 5, 6]
    assert r.unmatched == 0 and r.open == 0
    stages.reset()
    assert stages.read().spans == [] and stages.read().lost == 0


def test_device_counters_sum_snapshot_and_reset():
    obs.start_trace()
    c = obs.device_counter("glt.test.rows", "cpu")
    assert obs.device_counter("glt.test.rows", "cpu") is c
    c.add_(torch.tensor(5, dtype=torch.int32))
    obs.device_counter("glt.test.rows", "cpu").add_(torch.tensor(True))
    obs.device_counter("glt.test.other", "cpu").add_(2)
    snap = metrics.snapshot()
    assert snap["glt.test.rows"] == 6.0 and snap["glt.test.other"] == 2.0
    assert stages.counter_values() == {"glt.test.rows": 6.0,
                                       "glt.test.other": 2.0}
    metrics.reset()
    assert metrics.snapshot()["glt.test.rows"] == 0.0
    obs.install(None)
    assert obs.device_counter("glt.test.rows", "cpu") is not c


def test_export_has_a_valid_device_track(tmp_path):
    from glt_tpu.obs import validate_chrome_trace as jvalidate

    tracer = obs.start_trace(process_name="t")
    with obs.span("x.host"):
        with obs.stage("x.a", device="cpu") as st:
            st.next("x.b")
    path = str(tmp_path / "t.json")
    obs.stop_trace(path)
    got = json.load(open(path))
    assert obs.validate_chrome_trace(got) == [] and jvalidate(got) == []
    dev = [e for e in got["traceEvents"] if e.get("cat") == "glt.device"]
    assert [e["name"] for e in dev] == ["x.a", "x.b"]
    assert {e["tid"] for e in dev} == {stages.DEVICE_TID_BASE}
    names = [e for e in got["traceEvents"] if e["ph"] == "M"]
    assert names[-1]["args"]["name"].startswith("device stages cpu")
    host = next(e for e in got["traceEvents"] if e["name"] == "x.host")
    # CPU stamps are host times: the device track sits inside the span.
    assert host["ts"] <= dev[0]["ts"]
    assert dev[1]["ts"] + dev[1]["dur"] <= host["ts"] + host["dur"] + 1
    assert got["glt"]["device_lost"] == 0
    assert tracer.events and got["glt"]["device_unmatched"] == 0


# -- the instrumented layers -------------------------------------------------
def _graph(n=200, e=2000, seed=0):
    rng = np.random.default_rng(seed)
    return Graph(CSRTopo(rng.integers(0, n, (2, e)), num_nodes=n),
                 device="cpu")


def test_sampler_stages_and_counters():
    g = _graph()
    s = NeighborSampler(g, [4, 3], batch_size=16, with_edge=False)
    blk = np.full((3, 16), -1)
    blk[:2] = np.arange(32).reshape(2, 16)
    tracer = obs.start_trace()
    out = s.sample_from_nodes_batched(blk)
    r = stages.read()
    # Every batch of the block runs its stages, the padded one too.
    assert r.counts() == {"sampler.init": 3, "sampler.draw": 6,
                          "sampler.induce": 6, "sampler.finish": 3}
    assert sorted({s["attrs"].get("hop") for s in r.spans
                   if s["name"] == "sampler.draw"}) == [0, 1]
    snap = metrics.snapshot()
    assert snap["glt.sample.batches"] == 2.0
    assert snap["glt.sample.edges"] == float(out.num_sampled_edges.sum())
    assert snap["glt.sample.unique_nodes"] == float(
        out.node_mask.sum())
    names = [e["name"] for e in tracer.events]
    assert names.count("sampler.batched") == 1
    assert set(names) == set(SAMPLER_STAGES) | {"sampler.batched"}
    # Off again: the same call adds nothing.
    obs.install(None)
    s.sample_from_nodes_batched(blk)
    assert stages.read().counts() == r.counts()
    assert metrics.snapshot()["glt.sample.batches"] == 2.0


@pytest.mark.parametrize("route", [dict(fused=True), dict(dedup=True), {}])
def test_gather_route_is_a_stage(route):
    name = "gather." + ("fused" if route.get("fused")
                        else "dedup" if route.get("dedup") else "plain")
    gather_xy = make_gather_xy(None, **route)
    rows, labels = torch.randn(50, 4), torch.arange(50)
    node = torch.tensor([3, 1, 3, -1, 7], dtype=torch.int32)
    want = gather_xy(rows, labels, type("Out", (), {"node": node}))
    tracer = obs.start_trace()
    got = gather_xy(rows, labels, type("Out", (), {"node": node}))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert stages.read().counts() == {name: 1}
    assert [e["name"] for e in tracer.events] == [name]


def test_node_train_block_stages():
    g = _graph(60, 600, 1)
    s = NeighborSampler(g, [4, 4], batch_size=16, with_edge=False)
    feat = torch.randn(60, 8)
    labels = torch.randint(0, 3, (60,))
    torch.manual_seed(0)
    model = GraphSAGE(8, 16, 3, num_layers=2, dropout_rate=0.0)
    step = make_scanned_node_train_step(s, feat, labels, 16,
                                        fused_frontier=True)
    state = create_train_state(model, adam(1e-2))
    blk = np.full((3, 16), -1)
    blk[:2] = np.arange(32).reshape(2, 16)
    tracer = obs.start_trace()
    state, losses, _, _ = step(state, blk, trandom.PRNGKey(0, device="cpu"))
    assert state.step == 2
    counts = stages.read().counts()
    # Two real batches; the padded one is skipped before it samples.
    assert counts == {"sampler.init": 2, "sampler.draw": 4,
                      "sampler.induce": 4, "sampler.finish": 2,
                      "gather.fused": 2, "train.fwd": 2, "train.bwd": 2,
                      "train.optim": 2}
    # Eagerly the stages are the step's only host spans.
    assert {e["name"] for e in tracer.events} == set(counts)
    assert torch.isfinite(losses).all()


# -- on the card -------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stamp kernel has no CPU mode)")
    return torch.device("cuda")


def _staged(x):
    with obs.stage("x.a", device=x.device) as st:
        y = x * 2
        st.next("x.b")
        y = y + 1
    if obs.tracing():
        obs.device_counter("glt.test.calls", x.device).add_(1)
    return y


@pytest.mark.cuda
def test_captured_graph_stamps_at_every_replay(cuda_device):
    from glt_tpu_torch.utils.graphs import CapturedProgram

    tracer = obs.start_trace()
    buf = torch.arange(8.0, device=cuda_device)
    # The first stamp falls inside the capture (no warm-up): the ring is
    # made on a helper thread, outside the graph's pool.
    prog = CapturedProgram(_staged, [buf], warmup=0)
    stages.reset()
    n = 5
    for _ in range(n):
        prog.replay()
    r = stages.read()
    names = [s["name"] for s in r.spans]
    assert names == ["x.a", "x.b"] * n
    t = [(s["t0_ns"], s["t1_ns"]) for s in r.spans]
    assert all(a <= b for a, b in t)
    assert all(t[i][1] <= t[i + 1][0] for i in range(len(t) - 1))
    assert r.lost == r.unmatched == r.open == 0
    assert metrics.snapshot()["glt.test.calls"] == float(n)
    # A replay opens no stage host span; the call opens graph.replay.
    host = [e["name"] for e in tracer.events]
    assert "x.a" not in host and host.count("graph.replay") == n
    # Uninstalled, the graph keeps its stamps.
    obs.install(None)
    prog.replay()
    assert len(stages.read().spans) == 2 * n + 2
    out = obs.Tracer()
    assert out.chrome_trace()["traceEvents"] == []   # before its start


@pytest.mark.cuda
def test_graph_captured_off_launches_the_kernels_without_stages(
        cuda_device, monkeypatch):
    from glt_tpu_torch.sampler import neighbor_sampler as ns
    from glt_tpu_torch.utils.graphs import CapturedProgram

    g = Graph(CSRTopo(np.random.default_rng(0).integers(0, 500, (2, 5000)),
                      num_nodes=500), device=cuda_device)
    s = NeighborSampler(g, [5, 3], batch_size=64, with_edge=False)
    seeds = torch.arange(64, dtype=torch.int32, device=cuda_device)
    key = trandom.PRNGKey(1, device=cuda_device)

    def kernels():
        prog = CapturedProgram(lambda sd, k: s._sample_impl(
            g.indptr, g.indices, g.gather_edge_ids, sd, k), [seeds, key])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prog.replay()
            torch.cuda.synchronize()
        return sorted(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)

    off = kernels()

    class _Plain:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def next(self, *a, **k):
            pass

    monkeypatch.setattr(ns, "_stage", lambda *a, **k: _Plain())
    monkeypatch.setattr(ns, "_tracing", lambda: False)
    bare = kernels()
    assert off == bare and not any("stamp" in k for k in off)


def _hetero_block(dev):
    """The scanned hetero step over the published R-GAT on the small
    IGBH-shaped graph of ``test_torch_rgnn``, on ``dev``."""
    import test_torch_rgnn as tr

    from glt_tpu_torch.sampler import HeteroNeighborSampler

    gd, graphs = tr.igbh_small()
    widths = tr.calibrated(gd, graphs).hop_widths[1:]
    if dev.type != "cpu":
        graphs = {et: Graph(CSRTopo.from_csr_arrays(ip, ix), device=dev)
                  for et, (ip, ix) in gd.csr.items()}
    s = HeteroNeighborSampler(graphs, tr.FANOUT, "paper", batch_size=tr.BS,
                              frontier_widths=widths)
    step = make_scanned_hetero_train_step(
        s, {t: v.to(dev) for t, v in gd.tables.items()},
        {"paper": gd.labels.to(dev)}, tr.BS)
    state = create_train_state(tr.model_of(gd).to(dev), adam(1e-3))
    blk = np.full((3, tr.BS), -1)
    blk[:2] = gd.train_idx[: 2 * tr.BS].reshape(2, tr.BS)
    return s, step, state, blk


def _hetero_counts(s, batches):
    """Stage spans a hetero block of ``batches`` real batches opens."""
    sampled = sum(1 for et in s.edge_types
                  for h, f in enumerate(s.num_neighbors[et])
                  if f > 0 and s.hop_widths[h][et[0]] > 0)
    induced = len({(h, et[2]) for et in s.edge_types
                   for h, f in enumerate(s.num_neighbors[et])
                   if f > 0 and s.hop_widths[h][et[0]] > 0})
    rels = 3 * len(s.edge_types)
    per = {"sampler.init": 1, "sampler.draw": sampled,
           "sampler.induce": induced, "sampler.finish": 1,
           "gather.plain": len(s.node_types), "train.fwd": 1,
           "rgat.proj": rels, "rgat.attn": rels, "train.bwd": 1,
           "train.optim": 1}
    return {k: v * batches for k, v in per.items()}


def test_hetero_train_block_stages():
    s, step, state, blk = _hetero_block(torch.device("cpu"))
    tracer = obs.start_trace()
    state, losses, _, ovf = step(state, blk, trandom.PRNGKey(0, device="cpu"))
    assert state.step == 2 and ovf.shape == (3,)
    r = stages.read()
    assert r.counts() == _hetero_counts(s, 2)
    assert r.unmatched == r.open == 0
    attrs = {k: {tuple(sorted(sp["attrs"].items())) for sp in r.spans
                 if sp["name"] == k} for k in ("gather.plain", "rgat.proj")}
    assert {dict(a)["node_type"] for a in attrs["gather.plain"]} == set(
        s.node_types)
    assert {dict(a)["layer"] for a in attrs["rgat.proj"]} == {0, 1, 2}
    assert {e["name"] for e in tracer.events} >= {"train.fwd", "rgat.attn"}
    snap = metrics.snapshot()
    assert snap["glt.sample.batches"] == 2.0
    assert all(f"glt.sample.unique_nodes{{node_type={t}}}" in snap
               for t in s.node_types)
    assert torch.isfinite(losses).all()


@pytest.mark.cuda
def test_hetero_block_stages_pair_up_inside_its_graph(cuda_device):
    s, step, state, blk = _hetero_block(cuda_device)
    obs.start_trace()
    for i in range(2):          # eager, then the capture and its replay
        state, *_ = step(state, blk, trandom.PRNGKey(i, device=cuda_device))
    stages.reset()
    n = 3
    for i in range(n):
        state, *_ = step(state, blk, trandom.PRNGKey(5, device=cuda_device))
    torch.cuda.synchronize()
    r = stages.read()
    assert r.counts() == _hetero_counts(s, 2 * n)
    assert r.lost == r.unmatched == r.open == 0
    assert all(sp["t0_ns"] <= sp["t1_ns"] for sp in r.spans)
    assert metrics.snapshot()["glt.sample.batches"] == float(2 * n)
