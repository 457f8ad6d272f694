"""The program's instruments in a traced run, on the CPU: the idle gaps
put down to layers on a trace made by hand, the glue that installs,
empties and reads the program's tracer, stages and counters, and each
reader of them on a record made by hand."""
import numpy as np
import pytest
import torch

from portbench import layers, progtrace, registry

#: Metric name -> the reader's file it resolves to, for the two cells.
NEW = {
    "sampler.draw_ms.sample": "sampler.draw_ms",
    "sampler.draw_ms.train": "sampler.draw_ms",
    "sampler.induce_ms.sample": "sampler.induce_ms",
    "sampler.induce_ms.train": "sampler.induce_ms",
    "sampler.fill_share.sample": "sampler.fill_share",
    "sampler.fill_share.train": "sampler.fill_share",
    "gather.fused_ms.train": "gather.fused_ms",
    "train.fwd_ms.train": "train.fwd_ms",
    "train.bwd_ms.train": "train.bwd_ms",
    "train.optim_ms.train": "train.optim_ms",
    "gather.host_ms.sample": "gather.host_ms",
    "gather.idle_share.sample": "gather.idle_share",
    "sampler.idle_share.sample": "sampler.idle_share",
}


def _ev(name, ts, dur, cat="user_annotation", tid=1, **kw):
    return dict({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                 "pid": 1, "tid": tid}, **kw)


def test_idle_gaps_by_layer_by_hand():
    ev = [
        _ev("portbench.block", 0, 100),
        _ev("sampler.batched", 0, 40),
        _ev("graph.replay", 5, 10),                  # not a layer
        _ev("gather.fused", 50, 20),
        _ev("gather.fused", 75, 10),
        _ev("sampler.outputs", 60, 5),               # inside gather.fused
        _ev("train.fwd", 0, 100, tid=2),             # another thread
        _ev("void k()", 20, 10, cat="kernel", tid=7),
        _ev("void k()", 90, 30, cat="kernel", tid=7),
    ]
    # Window 0-120; busy 20-30 and 90-120; gaps 0-20 and 30-90.
    got = layers.idle_by_layer(ev)
    assert got == pytest.approx({"sampler": 35e-6, "gather": 25e-6,
                                 "host": 20e-6})
    assert sum(got.values()) == pytest.approx(80e-6)
    # No program span at all: every gap is the host's.
    bare = [e for e in ev if not e["name"].startswith(("sampler", "gather",
                                                       "train"))]
    assert layers.idle_by_layer(bare) == pytest.approx({"host": 80e-6})
    assert layers.idle_by_layer(ev[1:]) == {}


def test_host_self_leaves_out_children():
    ev = [_ev("a", 0, 100, args={"span_id": 1}),
          _ev("b", 10, 30, args={"span_id": 2, "parent_span_id": 1}),
          _ev("b", 50, 20, args={"span_id": 3, "parent_span_id": 1}),
          _ev("c", 12, 5, args={"span_id": 4, "parent_span_id": 2})]
    assert progtrace.host_self(ev) == pytest.approx(
        {"a": 50e-6, "b": 45e-6, "c": 5e-6})


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_metric_has_its_reader(name):
    here = registry.HERE
    read = registry.reader(name, here)
    assert read is not None
    assert read.__module__.endswith(NEW[name].replace(".", "_"))


def _record():
    return {"batches": 4, "node_capacity": 100,
            "prog": {"stage_s": {"sampler.init": 0.001, "sampler.draw": 0.002,
                                 "sampler.induce": 0.003,
                                 "sampler.finish": 0.0005,
                                 "gather.fused": 0.004, "train.fwd": 0.008,
                                 "train.bwd": 0.016, "train.optim": 0.002},
                     "host_self_s": {"gather.fused": 0.0004},
                     "counters": {"glt.sample.batches": 5.0,
                                  "glt.sample.unique_nodes": 250.0,
                                  "glt.sample.edges": 1000.0}},
            "trace": {"window_s": 0.5,
                      "idle_layer_s": {"sampler": 0.05, "gather": 0.1,
                                       "host": 0.02}}}


WANT = {"sampler.draw_ms": 0.5, "sampler.induce_ms": 1.0,
        "sampler.fill_share": 50.0, "gather.fused_ms": 1.0,
        "train.fwd_ms": 2.0, "train.bwd_ms": 4.0, "train.optim_ms": 0.5,
        "gather.host_ms": 0.1, "gather.idle_share": 20.0,
        "sampler.idle_share": 10.0}


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_on_a_record_by_hand(name):
    read = registry.reader(name)
    assert read(_record(), name) == pytest.approx(WANT[NEW[name]])
    # A program without the instruments: nothing to read, nothing raised.
    bare = {"batches": 4, "node_capacity": 100, "trace": {"window_s": 0.5}}
    assert read(bare, name) is None


def _sampler():
    from glt_tpu_torch.data import CSRTopo, Graph
    from glt_tpu_torch.sampler import NeighborSampler

    rng = np.random.default_rng(0)
    g = Graph(CSRTopo(rng.integers(0, 300, (2, 3000)), num_nodes=300),
              device="cpu")
    return NeighborSampler(g, [4, 3], batch_size=16, with_edge=False)


def test_glue_reads_the_window_alone():
    from glt_tpu_torch import obs

    assert progtrace.install({"trace": False}) is None
    s = _sampler()
    tracer = progtrace.install({"trace": True})
    try:
        s.sample_from_nodes_batched(np.arange(32).reshape(2, 16))  # set-up
        progtrace.window_start(tracer)
        blk = np.full((2, 16), -1)
        blk[0] = np.arange(16, 32)
        out = s.sample_from_nodes_batched(blk)
        rec = {"batches": 1, "node_capacity": s.node_capacity}
        progtrace.window_end(tracer, rec)
    finally:
        obs.install(None)
    assert not obs.tracing()
    prog = rec["prog"]
    assert prog["stage_n"]["sampler.init"] == 2
    assert set(prog["stage_s"]) == {"sampler.init", "sampler.draw",
                                    "sampler.induce", "sampler.finish"}
    assert prog["counters"]["glt.sample.batches"] == 1.0
    assert prog["counters"]["glt.sample.edges"] == float(
        out.num_sampled_edges.sum())
    assert prog["lost"] == prog["unmatched"] == 0
    assert prog["host_self_s"]["sampler.batched"] > 0
    assert registry.reader("sampler.fill_share")(rec, "x") == pytest.approx(
        100.0 * float(out.node_mask[0].sum()) / s.node_capacity)


def test_glue_on_a_program_without_stages(monkeypatch):
    from glt_tpu_torch import obs

    monkeypatch.delattr(obs, "stages")
    tracer = progtrace.install({"trace": True})
    try:
        progtrace.window_start(tracer)
        with obs.span("gather.fused"):
            torch.ones(3).sum()
        rec = {"batches": 1}
        progtrace.window_end(tracer, rec)
    finally:
        obs.install(None)
    assert set(rec["prog"]) == {"host_self_s"}
    assert registry.reader("sampler.draw_ms")(rec, "x") is None
    assert registry.reader("gather.host_ms")(rec, "x") > 0
