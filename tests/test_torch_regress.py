"""The port's ``obs/regress.py`` against ``glt_tpu.obs.regress``.

Both get the same inputs: the committed ``BENCH_r*.json`` history read
as data (as ``tests/test_regress.py`` reads it), its snapshot shapes
(driver wrapper, captured stdout tail, raw bench line), and seeded
synthetic histories.  ``direction``, ``load_bench_metrics``, ``compare``
and ``markdown_report`` give ``==`` results, with the port's target
tables patched to ``glt_tpu``'s for the algorithm check.  The port
ships those tables empty: their targets are the card's own.
"""
import copy
import glob
import json
import os

import numpy as np
import pytest
import torch

from glt_tpu.obs import regress as jreg
from glt_tpu_torch.obs import regress as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)


def _history():
    runs = []
    for path in sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json"))):
        metrics = jreg.load_bench_metrics(path)
        assert metrics is not None, path
        assert treg.load_bench_metrics(path) == metrics
        runs.append((os.path.basename(path), metrics))
    assert len(runs) >= 5
    return runs


@pytest.fixture
def jax_targets(monkeypatch):
    """The port's target tables set to glt_tpu's, for the algorithm."""
    monkeypatch.setattr(treg, "ASPIRATIONS", dict(jreg.ASPIRATIONS))
    monkeypatch.setattr(treg, "CEILINGS", dict(jreg.CEILINGS))


def _same_report(runs, **kw):
    want = jreg.compare(copy.deepcopy(runs), **kw)
    got = treg.compare(copy.deepcopy(runs), **kw)
    assert got == want
    assert treg.markdown_report(got) == jreg.markdown_report(want).replace(
        "glt_tpu/obs/regress.py", "glt_tpu_torch/obs/regress.py")
    return got


def test_direction_tables_match_jax():
    assert treg.EXPLICIT_DIRECTIONS == jreg.EXPLICIT_DIRECTIONS
    assert (treg.UP, treg.DOWN, treg.NEUTRAL) == (jreg.UP, jreg.DOWN,
                                                  jreg.NEUTRAL)
    names = set(jreg.EXPLICIT_DIRECTIONS)
    for _, metrics in _history():
        names |= set(metrics)
    rng = np.random.default_rng(0)
    stems = ["gather", "sample", "serving_p99", "epoch", "train_step"]
    tails = ["_ms", "_gb_s", "_m_edges_s", "_edges_s", "_tflops_bf16",
             "_per_s", "_speedup", "_frac", "_ms_per_batch", "_gb_s_dedup",
             "_ms_d128", "_s_config1", "_best", "_count", ""]
    for _ in range(200):
        names.add(str(rng.choice(stems)) + str(rng.choice(tails)))
    for name in sorted(names):
        assert treg.direction(name) == jreg.direction(name), name


def test_load_bench_metrics_shapes_match_jax(tmp_path):
    base = jreg.load_bench_metrics(os.path.join(REPO, "BENCH_r05.json"))
    line = json.dumps(base)
    shapes = {
        "parsed.json": json.dumps({"parsed": base}),
        "tail.json": json.dumps({"tail": "noise\n{bad json\n" + line}),
        "raw.json": line + "\n",
        "stdout.log": "progress...\n" + line + "\ntrailing text\n",
        "garbage.json": "not json at all",
        "empty_tail.json": json.dumps({"tail": ""}),
        "list.json": json.dumps([1, 2, 3]),
    }
    for name, text in shapes.items():
        path = tmp_path / name
        path.write_text(text)
        assert treg.load_bench_metrics(str(path)) == \
            jreg.load_bench_metrics(str(path)), name
    missing = str(tmp_path / "missing.json")
    assert treg.load_bench_metrics(missing) is jreg.load_bench_metrics(
        missing) is None


@pytest.mark.parametrize("fresh", ["copy", "drop_overlap", "regress",
                                   "improve"])
def test_committed_history_matches_jax(jax_targets, fresh):
    runs = _history()
    last = dict(runs[-1][1])
    if fresh == "drop_overlap":
        last = {k: v for k, v in last.items() if not k.startswith("overlap")}
    elif fresh in ("regress", "improve"):
        f = 3.0 if fresh == "regress" else 1 / 3.0
        last = {k: (v * f if isinstance(v, float) and k.endswith("_ms")
                    else v) for k, v in last.items()}
    runs.append(("fresh", last))
    rep = _same_report(runs)
    assert rep["labels"][-1] == "fresh"


def _synthetic_history(seed):
    """Runs over metrics of every direction and a target, with noise,
    step changes, flat stretches, new/gone metrics, strings and bools."""
    rng = np.random.default_rng(seed)
    names = (list(jreg.ASPIRATIONS) + list(jreg.CEILINGS)
             + ["x_ms", "y_gb_s", "z_frac", "tunnel_rtt_ms", "w_per_s",
                "gather_ms_d128", "q_count"])
    n_runs = int(rng.integers(2, 8))
    base = {m: float(rng.uniform(0.5, 100.0)) for m in names}
    runs = []
    for r in range(n_runs):
        metrics = {}
        for m in names:
            if rng.random() < 0.1:
                continue                               # gone or new here
            v = base[m] * (1 + rng.normal(0, 0.03))
            if r == n_runs - 1 and rng.random() < 0.4:
                v *= float(rng.choice([0.5, 2.0]))     # a step change
            if m in jreg.CEILINGS and rng.random() < 0.5:
                v = jreg.CEILINGS[m] * float(rng.uniform(0.5, 1.5))
            if rng.random() < 0.2:
                v = base[m]                            # exactly flat
            metrics[m] = int(v) if rng.random() < 0.1 else v
        metrics["path"] = str(rng.choice(["dedup", "naive"]))
        metrics["flag"] = bool(rng.random() < 0.5)
        runs.append((f"r{r:02d}", metrics))
    return runs


@pytest.mark.parametrize("seed", range(12))
def test_synthetic_histories_match_jax(jax_targets, seed):
    runs = _synthetic_history(seed)
    _same_report(runs)
    _same_report(runs, rel_tol=0.01, noise_k=1.5, flat_tol=0.2,
                 flat_window=2)


def test_edge_cases_match_jax(jax_targets):
    for runs in ([("only", {"x_ms": 1.0})], []):
        for mod in (jreg, treg):
            with pytest.raises(ValueError, match="at least two runs"):
                mod.compare(runs)
    _same_report([("r1", {"x_ms": 0.0}), ("fresh", {"x_ms": 0.0})])
    _same_report([("r1", {"x_ms": 0.0}), ("fresh", {"x_ms": 2.0})])
    _same_report([("r1", {"s": "a"}), ("fresh", {"s": "b"})])


def test_port_ships_no_targets():
    """The JAX package's targets were set for another machine; the
    port's benchmark sets the card's own.  Without targets a flat miss
    is not ``stuck`` and no ceiling verdicts a NEUTRAL metric."""
    assert treg.ASPIRATIONS == {} and treg.CEILINGS == {}
    flat = [(f"r{i}", {"best_step_ms": 51.9, "hbm_peak_bytes": 1e12})
            for i in range(3)]
    rep = treg.compare(flat)
    assert rep["stuck"] == [] and rep["regressions"] == []
    assert jreg.compare(flat)["stuck"] == ["best_step_ms"]
