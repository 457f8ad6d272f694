"""A whole run on the CPU at a tiny size: the line's keys, a sound run
comes out correct, a run with the timed path broken underneath comes out
not correct, and the command refuses to measure without a card."""
import contextlib
import io
import json
import os
import time

import pytest
import torch

from portbench import faults, run, trace

CELLS = ("sage-products.train", "sage-papers100m.sample")


def execute(tiny_root, cell, seed=2 ** 31 + 11):
    root, here = tiny_root
    return run.execute(root, cell, seed, 0.5, False, "cpu",
                       time.perf_counter(), here)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_and_its_line(tiny_root, cell):
    out = execute(tiny_root, cell)
    assert out["correct"], out["checks"]
    line = json.loads(json.dumps(run.line_of(out)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    assert "setup_s" in line["metrics"] and line["attempted"] > 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


FAULTS = [
    ("sage-products.train", "skip_update"),
    ("sage-products.train", "half_batch"),
    ("sage-products.train", "block_key"),
    ("sage-products.train", "block_seeds"),
    ("sage-products.train", "frozen_dropout"),
    ("sage-products.train", "altered_edge"),
    ("sage-papers100m.sample", "altered_row"),
    ("sage-papers100m.sample", "altered_edge"),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c.split('.')[-1]}-{f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        out = execute(tiny_root, cell)
    assert not out["correct"], out["checks"]


def test_no_card_no_result(monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(run.__file__)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1"])
    assert rc != 0 and buf.getvalue() == ""


def test_trace_summary_by_hand():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.block",
         "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.sample",
         "ts": 0, "dur": 40, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "ts": 10, "dur": 5, "pid": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 60,
         "dur": 30, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "void sample_kernel(Args)",
         "ts": 20, "dur": 30, "pid": 0, "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "fused_frontier_kernel<float>",
         "ts": 100, "dur": 100, "pid": 0, "tid": 7, "args": {}},
    ]
    s = trace.summarize(ev, ("portbench.sample",))
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(130e-6)
    assert s["range_s"]["portbench.sample"] == pytest.approx(30e-6)
    assert trace.kernel_time(s, "sample_kernel") == pytest.approx(30e-6)
    assert trace.kernel_time(s, "fused_frontier_kernel") == pytest.approx(
        100e-6)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
