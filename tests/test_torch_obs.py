"""glt_tpu_torch.obs against glt_tpu.obs on the CPU.

Both packages get the same scripted inputs: the metrics exposition text,
the merged traces and their summaries, the SLO alert sequence under an
injected clock, compilewatch's storm point, the attribution byte models
and roofline fractions compare with ``==``.  Traces and flight dumps
written by the port validate with ``glt_tpu``'s validators and the other
way round.  On the CPU the device gauges publish nothing and never
raise; a ``torch.profiler`` capture writes its directory and its flight
index; the training and loader hooks emit their spans and metrics, and
nothing inside a scanned step opens a span.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from glt_tpu import obs as jobs
from glt_tpu.obs import attrib as jattrib
from glt_tpu.obs import compilewatch as jcw
from glt_tpu.obs import flight as jflight
from glt_tpu.obs import metrics as jmetrics
from glt_tpu.obs import roofline as jroof
from glt_tpu.obs import slo as jslo
from glt_tpu_torch import obs
from glt_tpu_torch import random as trandom
from glt_tpu_torch.data import CSRTopo, Dataset, Graph
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import (GraphSAGE, adam, create_train_state,
                                  make_scanned_node_train_step,
                                  run_scanned_epoch)
from glt_tpu_torch.obs import attrib, compilewatch, device, flight, metrics
from glt_tpu_torch.obs import profiler, roofline, slo
from glt_tpu_torch.sampler import NeighborSampler
from tests.test_trace_merge import (_client_trace, _server_trace,
                                    _worker_trace)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_obs_state():
    """Every test starts (and leaves) with tracing off and metrics
    disabled in both packages."""
    for o, m in ((obs, metrics), (jobs, jmetrics)):
        o.install(None)
        m.disable()
    yield
    for o, m in ((obs, metrics), (jobs, jmetrics)):
        o.install(None)
        m.disable()
        m.reset()


def _script(mod):
    """One scripted sequence on a fresh registry of ``mod``."""
    reg = mod.Registry()
    c = reg.counter("glt.t.requests", "requests served",
                    labels={"route": "graph"})
    c.inc()
    c.inc(2.5)
    reg.counter("glt.t.requests", labels={"route": 'eager "x"\n'}).inc(4)
    g = reg.gauge("glt.t.depth", "queue depth")
    g.set(7)
    g.inc(-2)
    h = reg.histogram("glt.t.lat_ms", "latency", buckets=(1.0, 5.0, 25.0))
    for v in (0.5, 1.0, 3.0, 3.0, 7.5, 100.0):
        h.observe(v)
    reg.histogram("glt.t.empty_ms").observe(1.0)
    return reg


def test_metrics_exposition_equals_jax():
    metrics.enable()
    jmetrics.enable()
    ours, ref = _script(metrics), _script(jmetrics)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert (ours.histogram("glt.t.lat_ms").quantile(q)
                == ref.histogram("glt.t.lat_ms").quantile(q))


def test_metrics_disabled_record_nothing():
    reg = _script(metrics)          # metrics are off
    assert reg.snapshot()["glt.t.depth"] == 0.0
    assert reg.snapshot()["glt.t.lat_ms.count"] == 0.0
    assert metrics.prune_unmeasured({"a": 1, "b": None}) == {"a": 1}


def _traced_run(tmp_path, name):
    tracer = obs.start_trace(process_name="trainer")
    with obs.span("epoch", epoch=1) as sp:
        for i in range(3):
            with obs.span("step", i=i) as st:
                x = torch.arange(8.0) * i
                st.fence((x, {"y": [x + 1]}))
        sp.set(steps=3)
    with obs.span("tail") as sp:
        assert sp.fence(5) == 5
    tracer.instant("mark", k=1)
    path = str(tmp_path / name)
    assert obs.stop_trace(path) is tracer
    return path


def test_port_trace_validates_in_both_packages(tmp_path):
    path = _traced_run(tmp_path, "port.json")
    got = json.load(open(path))
    assert jobs.validate_chrome_trace(got) == []
    assert obs.validate_chrome_trace(got) == []
    events = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in events].count("step") == 3
    step = next(e for e in events if e["name"] == "step")
    # A fenced span keeps glt_tpu's split of dispatch and device wait.
    assert step["args"]["dispatch_us"] >= 0
    assert step["args"]["device_wait_us"] >= 0
    assert step["args"]["depth"] == 1
    assert got["glt"]["process_name"] == "trainer"
    # The summaries of the file agree too.
    assert obs.summarize_trace(got) == jobs.summarize_trace(got)


def test_jax_trace_validates_in_port(tmp_path):
    tracer = jobs.start_trace()
    with jobs.span("outer"):
        with jobs.span("inner"):
            pass
    path = str(tmp_path / "jax.json")
    jobs.stop_trace(path)
    assert tracer is not None
    assert obs.validate_chrome_trace(json.load(open(path))) == []


def test_validate_catches_overlap_like_jax():
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 10.0, "pid": 1,
         "tid": 1},
        {"name": "b", "ph": "X", "ts": 5.0, "dur": 10.0, "pid": 1,
         "tid": 1},
        {"name": "c", "ph": "X", "ts": 0.0, "dur": -1.0, "pid": 1,
         "tid": 2}]}
    assert obs.validate_chrome_trace(bad) == jobs.validate_chrome_trace(bad)
    assert len(obs.validate_chrome_trace(bad)) == 2


def _write(tmp_path, name, obj):
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return path


def test_merge_and_summarize_equal_jax(tmp_path):
    paths = [_write(tmp_path, n, f()) for n, f in (
        ("client.json", _client_trace), ("server.json", _server_trace),
        ("worker.json", _worker_trace))]
    ours = obs.merge_traces(paths, out=str(tmp_path / "m1.json"))
    ref = jobs.merge_traces(paths, out=str(tmp_path / "m2.json"))
    assert ours == ref
    assert json.load(open(tmp_path / "m1.json")) == json.load(
        open(tmp_path / "m2.json"))
    assert obs.span_tree_check(ours) == jobs.span_tree_check(ref)
    rows = obs.summarize_trace(ours)
    assert rows == jobs.summarize_trace(ref)
    assert obs.format_summary(rows) == jobs.format_summary(rows)


def test_flight_dumps_validate_both_ways(tmp_path):
    ours = flight.FlightRecorder(capacity=8, role="port")
    ref = jflight.FlightRecorder(capacity=8, role="jax")
    for i in range(11):                      # wraps: 3 dropped
        ours.record("train.epoch", blocks=i, seq=i)
        ref.record("train.epoch", blocks=i)
    p1 = ours.dump(str(tmp_path / "port.json"), reason="test")
    p2 = ref.dump(str(tmp_path / "jax.json"), reason="test")
    d1, d2 = json.load(open(p1)), json.load(open(p2))
    assert jflight.validate_flight_dump(d1) == []
    assert flight.validate_flight_dump(d2) == []
    assert d1["dropped"] == d2["dropped"] == 3
    assert d1["events"][-1]["x_seq"] == 10       # envelope kept
    merged = flight.merge_flight_dumps([p1, p2])
    assert merged == jflight.merge_flight_dumps([p1, p2])
    assert jflight.validate_flight_dump(merged) == []
    torn = dict(d1, dropped=0)
    assert (flight.validate_flight_dump(torn)
            == jflight.validate_flight_dump(torn) != [])


def _slo_sequence(m, s, name):
    """glt_tpu's overload scenario (tests/test_flight.py) on ``name``."""
    m.enable()
    h = m.histogram(name, buckets=(1.0, 10.0, 100.0))
    bad = m.counter(name + ".bad")
    good = m.counter(name + ".good")
    seen = []
    mon = s.SloMonitor(
        [s.SloSpec(name="p99", metric=name, objective=10.0, q=0.99,
                   windows=((30.0, 1.0), (5.0, 1.0))),
         s.SloSpec(name="rejects", metric=name + ".bad",
                   denom=name + ".good", kind="ratio", objective=0.1,
                   windows=((30.0, 1.0), (5.0, 1.0)))],
        on_alert=seen.append)
    out = [mon.tick(now=0.0)]
    for _ in range(20):
        h.observe(50.0)
    bad.inc(50)
    good.inc(50)
    out.append(mon.tick(now=40.0))
    for _ in range(5):
        h.observe(50.0)
    out += [mon.tick(now=43.0), mon.tick(now=49.0), mon.tick(now=80.0)]
    for alerts in out:
        for a in alerts:
            a.pop("ts", None)
    return out, mon.firing(), len(seen)


def test_slo_alert_sequence_equals_jax():
    ours = _slo_sequence(metrics, slo, "glt.slo_port.e2e_ms")
    ref = _slo_sequence(jmetrics, jslo, "glt.slo_port.e2e_ms")
    # NaN burns (an empty window) compare equal through their JSON text.
    assert json.dumps(ours, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert [a["state"] for batch in ours[0] for a in batch] == [
        "firing", "firing", "resolved", "resolved"]
    assert [s.name for s in slo.default_specs()] == [
        s.name for s in jslo.default_specs()]


def test_compilewatch_storm_at_the_same_count():
    def storm_at(cw, fl, program):
        cw.reset_for_tests()
        before = len(fl.recorder().events())
        for i in range(1, 30):
            cw._note_compile(program, 1.0, now=100.0 + i)
            if any(e["kind"] == "compile.storm"
                   for e in fl.recorder().events()[before:]):
                return i, cw.counts(program)
        return None

    got = storm_at(compilewatch, flight, "port_storm")
    assert got == storm_at(jcw, jflight, "port_storm")
    assert got == (compilewatch.STORM_K + 1, compilewatch.STORM_K + 1)
    assert compilewatch.storm_ratio_spec().metric == "glt.compile.recompiles"


def test_compilewatch_labels_and_note_compile():
    compilewatch.reset_for_tests()
    metrics.enable()
    assert compilewatch.install() is True
    assert compilewatch.current_label() == "unlabelled"
    with compilewatch.label("scanned_node_step"):
        with compilewatch.label("inner"):
            compilewatch.note_compile(None, 2.0)
        compilewatch.note_compile(None, 3.0)
    compilewatch.note_compile("nvcc", 4.0)
    compilewatch.wrap(lambda: compilewatch.note_compile(None, 1.0),
                      "wrapped")()
    assert compilewatch.counts() == {"inner": 1, "scanned_node_step": 1,
                                     "nvcc": 1, "wrapped": 1}
    assert compilewatch.total_compiles() == 4
    snap = metrics.snapshot()
    assert snap["glt.compile.count{program=nvcc}"] == 1.0
    assert snap["glt.compile.ms{program=inner}.sum"] == 2.0


@pytest.mark.parametrize("args", [(2, (2,)), (1024, (15, 10, 5)),
                                  (7, (3, 0, 4))])
def test_attrib_models_equal_jax(args):
    assert (attrib.sample_expected_bytes(*args)
            == jattrib.sample_expected_bytes(*args))
    n = args[0] * 37
    assert attrib.dedup_expected_bytes(n) == jattrib.dedup_expected_bytes(n)
    assert (attrib.gather_expected_bytes(n, 100, 2)
            == jattrib.gather_expected_bytes(n, 100, 2))
    assert (attrib.train_expected_bytes(n, 3 * n)
            == jattrib.train_expected_bytes(n, 3 * n))
    ms = {"sample": 2.0, "gather": 0.5, "train": None, "dedup": 1.0}
    nb = {"sample": 2e6 * args[0], "gather": 3e5, "train": 1e6}
    for ceiling in (0.0, 10.0, 3350.0):
        assert (attrib.stage_roofline_table(ms, nb, ceiling)
                == jattrib.stage_roofline_table(ms, nb, ceiling))
        tbl = attrib.stage_roofline_table(ms, nb, ceiling)
        assert (attrib.flat_roofline_fracs(tbl, skip=("gather",))
                == jattrib.flat_roofline_fracs(tbl, skip=("gather",)))
    for a, b in ((1.0, 2.0), (3350.0, 3350.0), (5.0, 0.0)):
        assert (roofline.roofline_fraction(a, b)
                == jroof.roofline_fraction(a, b))


def test_param_nbytes_and_no_cost_analysis():
    model = torch.nn.Linear(4, 4).to(torch.bfloat16)
    assert attrib.param_nbytes(model) == (16 + 4) * 2
    sd = {"w": torch.zeros(4, 4), "b": torch.zeros(4, dtype=torch.bfloat16)}
    assert attrib.param_nbytes(sd) == 4 * 4 * 4 + 4 * 2
    assert attrib.compiled_cost_bytes(lambda x: x, 1) is None


def test_roofline_refuses_the_cpu_and_names_its_source(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.measure_memcpy_roofline(nbytes=1 << 12, device="cpu")
    monkeypatch.setenv("GLT_HBM_GBPS", "1234.5")
    assert roofline.peak_hbm_gb_s() == {"gb_s": 1234.5, "source": "env"}
    monkeypatch.delenv("GLT_HBM_GBPS")
    assert roofline.peak_hbm_gb_s(measure_fallback=True) == {
        "gb_s": 3350.0, "source": "default_h100_sxm"}
    names = [n for n, _ in roofline.DEVICE_HBM_GB_S]
    assert names == ["h100nvl", "h100pcie", "h100"]


def test_device_gauges_publish_nothing_on_cpu():
    metrics.enable()
    device.reset_owners_for_tests()
    before = set(metrics.snapshot())
    assert device.publish_device_stats() == {}
    assert device.peak_bytes_in_use() is None
    watch = device.LeakWatch(epochs=2)
    state = device.observe_epoch()
    assert set(state) == {"live_bytes", "run", "suspect"}
    assert not any(k.startswith("glt.device.") and "leak" not in k
                   for k in set(metrics.snapshot()) - before)
    # The census and the leak watch still work from registered buffers.
    t = torch.zeros(16)
    host = np.zeros(4)
    device.register_owner("params", t)
    device.register_owner("params", t[4:])     # one storage, counted once
    device.register_owner("stager", host)
    device.register_owner("bogus", 3)          # never raises
    snap = device.snapshot()
    assert snap["owners"] == {"params": {"count": 1, "bytes": 64},
                              "stager": {"count": 1, "bytes": 32}}
    assert snap["total"] == {"count": 2, "bytes": 96}
    assert snap["devices"] == {}
    assert watch.observe_epoch(100)["run"] == 0
    assert watch.observe_epoch(200)["run"] == 1
    assert watch.observe_epoch(300)["suspect"]
    assert watch.observe_epoch(300)["run"] == 0
    del t
    assert "params" not in device.owners()
    device.reset_owners_for_tests()


def test_profiler_cpu_capture_writes_dir_and_flight_index(tmp_path):
    before = len(flight.recorder().events())
    d = str(tmp_path / "cap")
    with profiler.capture(d, millis=5, reason="manual") as got:
        torch.ones(64).sum()
    assert got == d
    assert os.path.isfile(os.path.join(d, "trace.json"))
    caps = profiler.capture_index(flight.recorder().events()[before:])
    assert [(c["dir"], c["reason"]) for c in caps] == [(d, "manual")]
    prof = profiler.TriggeredProfiler(str(tmp_path / "trig"), millis=1,
                                      min_interval_s=60.0, max_captures=1)
    first = prof.trigger("slo:p99", now=0.0)
    assert first is not None and os.path.isdir(first)
    assert prof.trigger("again", now=1.0) is None          # rate limited
    assert prof.trigger("later", now=100.0) is None        # capped
    seen = []
    on_alert = prof.slo_on_alert(seen.append)
    on_alert({"state": "firing", "slo": "x"})
    assert seen == [{"state": "firing", "slo": "x"}]


def test_spike_detector_and_arming(tmp_path):
    det = profiler.SpikeDetector(factor=4.0, min_samples=4)
    assert not any(det.observe(10.0) for _ in range(4))
    assert det.observe(100.0)
    assert profiler.spike_observe(1e6) is False          # disarmed
    prof = profiler.arm(str(tmp_path), millis=1, spike_min_samples=2)
    try:
        assert profiler.armed() is prof
        for _ in range(2):
            profiler.spike_observe(1.0)
        assert profiler.spike_observe(1000.0)
        assert len(prof.captures) == 1
    finally:
        profiler.disarm()


def _tiny_training():
    rng = np.random.default_rng(0)
    n, dim = 60, 8
    ei = np.stack([np.repeat(np.arange(n), 4), rng.integers(0, n, 4 * n)])
    feat = rng.normal(size=(n, dim)).astype(np.float32)
    labels = (np.arange(n) % 3).astype(np.int32)
    sampler = NeighborSampler(Graph(CSRTopo(ei, num_nodes=n), device="cpu"),
                              [4, 4], batch_size=16, with_edge=False)
    torch.manual_seed(0)
    model = GraphSAGE(dim, 16, 3, num_layers=2, dropout_rate=0.0)
    return ei, feat, labels, sampler, model


def test_train_hooks_emit_spans_and_metrics(tmp_path):
    _, feat, labels, sampler, model = _tiny_training()
    device.reset_owners_for_tests()
    step = make_scanned_node_train_step(sampler, feat, labels, 16)
    state = create_train_state(model, adam(1e-2))
    assert device.owners() == {"params": len(list(model.parameters()))}
    metrics.enable()
    metrics.reset()
    before = len(flight.recorder().events())
    tracer = obs.start_trace()
    # The step alone opens no span: only the epoch driver's host loop is
    # instrumented, never the block it dispatches.
    state, *_ = step(state, np.arange(32).reshape(2, 16),
                     trandom.PRNGKey(0, device="cpu"))
    assert tracer.events == []
    run_scanned_epoch(step, state, np.arange(40), 16, 2,
                      np.random.default_rng(1),
                      trandom.PRNGKey(1, device="cpu"),
                      on_block=lambda st, i: None)
    path = str(tmp_path / "t.json")
    obs.stop_trace(path)
    got = json.load(open(path))
    assert jobs.validate_chrome_trace(got) == []
    names = [e["name"] for e in got["traceEvents"]]
    assert names.count("train.scanned_epoch") == 1
    assert names.count("train.scanned_block_dispatch") == 2
    snap = metrics.snapshot()
    assert snap["glt.train.steps"] == 2.0
    assert snap["glt.train.epochs"] == 1.0
    assert snap["glt.train.block_ms.count"] == 2.0
    epochs = [e for e in flight.recorder().events()[before:]
              if e["kind"] == "train.epoch"]
    assert len(epochs) == 1 and epochs[0]["blocks"] == 2
    device.reset_owners_for_tests()


def test_loader_hooks_emit_spans_and_metrics():
    ei, feat, labels, _, _ = _tiny_training()
    ds = (Dataset(device="cpu").init_graph(ei, num_nodes=60)
          .init_node_features(feat).init_node_labels(labels))
    loader = NeighborLoader(ds, [4, 4], np.arange(40), batch_size=16,
                            prefetch=2)
    metrics.enable()
    metrics.reset()
    tracer = obs.start_trace()
    assert len(list(loader)) == 3
    names = [e["name"] for e in tracer.events]
    assert names.count("loader.sample_dispatch") == 3
    assert names.count("loader.collate") == 3
    snap = metrics.snapshot()
    assert snap["glt.loader.batches"] == 3.0
    assert snap["glt.loader.sample_dispatch_ms.count"] == 3.0
    assert snap["glt.loader.collate_ms.count"] == 3.0


def test_cache_and_store_publish_gauges(tmp_path):
    from glt_tpu_torch.data.feature_cache import (cache_init, cache_stats,
                                                  publish_cache_stats)
    from glt_tpu_torch.store import (DiskFeatureStore, DramStager,
                                     publish_store_stats,
                                     write_feature_store)

    metrics.enable()
    metrics.reset()
    cache = cache_init(50, 8, 4, device="cpu")
    stats = publish_cache_stats(cache)
    assert stats == cache_stats(cache)
    assert metrics.snapshot()["glt.cache.capacity"] == 8.0
    x = np.random.default_rng(0).standard_normal((64, 4)).astype(np.float32)
    st = DiskFeatureStore(write_feature_store(str(tmp_path / "s"), x))
    before = len(flight.recorder().events())
    stager = DramStager(st, 16 * st.row_nbytes)
    try:
        stager.stage_ahead(np.arange(16)).result()
        stager.stage_ahead(np.arange(16, 24)).result()   # evicts 8
        stager.gather(np.arange(40))
        evicts = [e for e in flight.recorder().events()[before:]
                  if e["kind"] == "store.evict"]
        assert evicts and all(e["count"] > 0 for e in evicts)
        ep = stager.publish_epoch_stats()
        assert metrics.snapshot()["glt.store.misses"] == float(ep["misses"])
        assert publish_store_stats({"hits": 3}, "glt.s2") == {"hits": 3}
        assert metrics.snapshot()["glt.s2.hits"] == 3.0
    finally:
        stager.close()


def test_cli_summarize_validate_merge(tmp_path):
    trace = _traced_run(tmp_path, "t.json")
    paths = [_write(tmp_path, n, f()) for n, f in (
        ("client.json", _client_trace), ("server.json", _server_trace))]
    env = dict(os.environ, PYTHONPATH=REPO)

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "glt_tpu_torch.obs",
                               *args], capture_output=True, text=True,
                              cwd=REPO, env=env, timeout=120)

    out = cli("summarize", trace)
    assert out.returncode == 0, out.stderr
    assert "step" in out.stdout and "epoch" in out.stdout
    assert cli("validate", trace).returncode == 0
    merged = str(tmp_path / "merged.json")
    res = cli("merge", "-o", merged, *paths)
    assert res.returncode == 0, res.stderr
    assert json.load(open(merged)) == jobs.merge_traces(paths)
