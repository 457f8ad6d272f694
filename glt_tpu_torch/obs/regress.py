"""Perf-regression tracking over a history of bench runs (cf.
``glt_tpu/obs/regress.py``; stdlib only).

It turns a series of bench snapshots (oldest first, the last one under
judgment) into a markdown trend table and a direction-aware
regress/improve verdict.  Three ideas, each deliberately simple:

* **Direction awareness.**  ``*_ms`` down is good, ``*_gb_s`` /
  ``*_frac`` up is good; metrics with no inherent direction (capacity
  choices, occupancy counts, configuration readings) are tracked but
  never verdicted.  :func:`direction` resolves explicit names first,
  then suffix/infix conventions.

* **Noise tolerance.**  A metric regresses only when the latest value
  is worse than the history's median by more than
  ``max(rel_tol * |median|, noise_k * sigma)`` where ``sigma`` is a
  robust spread (MAD) of the prior runs: one noisy run does not page
  anyone, a real step change does.

* **Stuck detection.**  A metric with a *target* (:data:`ASPIRATIONS`)
  that is flat across the recent runs while failing it is flagged
  ``stuck``: the "nothing regressed, but nothing is getting better
  either" state a pure-delta check never reports.

The port's :data:`ASPIRATIONS` and :data:`CEILINGS` start empty: their
targets are the card's own, set where the port's benchmark measures
them.
"""
from __future__ import annotations

import json
import statistics
from typing import Any, Dict, List, Optional, Sequence, Tuple

UP = 1        # bigger is better
DOWN = -1     # smaller is better
NEUTRAL = 0   # tracked, never verdicted

#: Exact-name directions (override every convention below); the same
#: names and directions as ``glt_tpu``'s table, so one bench history
#: reads the same in both packages.
EXPLICIT_DIRECTIONS: Dict[str, int] = {
    "value": UP,
    "vs_baseline": UP,
    "vs_ref_cpu": UP,
    "best_step_ms": DOWN,
    "scanned_step_ms": DOWN,
    "dist_scanned_step_ms_tpu": DOWN,
    "cache_hit_rate": UP,
    "cache_hit_rate_cold": UP,
    "est_hbm_fraction": UP,
    "gather_roofline_frac": UP,
    "sample_roofline_frac": UP,
    "dedup_roofline_frac": UP,
    "train_roofline_frac": UP,
    "sample_ms_xla": DOWN,
    "sample_ms_pallas": DOWN,
    "sample_roofline_frac_xla": UP,
    "sample_roofline_frac_pallas": UP,
    "fused_frontier_ms": DOWN,
    "fused_frontier_ms_unfused": DOWN,
    "scanned_fused_step_ms": DOWN,
    "obs_disabled_overhead_frac": DOWN,
    "sampling_overhead_frac": DOWN,
    "sampling_overhead_frac_epoch": DOWN,
    "ckpt_overhead_frac": DOWN,
    "ckpt_bytes": NEUTRAL,
    "overflow_rate": DOWN,
    "dist_routing_overhead": DOWN,
    "obs_noop_ns_per_call": DOWN,
    "dist_flat_step_ms": DOWN,
    "dist_hier_step_ms": DOWN,
    "dcn_bytes_flat": NEUTRAL,
    "dcn_bytes_hier": DOWN,
    "hier_dedup_factor": UP,
    "serving_p50_ms": DOWN,
    "serving_p99_ms": DOWN,
    "serving_p99_light_ms": DOWN,
    "serving_single_ms": DOWN,
    "serving_coalesce_speedup": UP,
    "serving_rps_coalesced": UP,
    "serving_rps_per_request": NEUTRAL,
    "serving_overload_reject_frac": NEUTRAL,
    "serving_offered_rps": NEUTRAL,
    "dram_hit_rate": UP,
    "store_epoch_ms": DOWN,
    "disk_bytes_per_epoch": NEUTRAL,
    "bytes_from_dram": NEUTRAL,
    "bytes_from_disk": NEUTRAL,
    "bytes_from_hbm": NEUTRAL,
    "store_budget_bytes": NEUTRAL,
    "hbm_peak_bytes": NEUTRAL,
    "hbm_bw_gb_s": NEUTRAL,
    "hbm_fraction_measured": UP,
    "compile_count_epoch": DOWN,
    "tunnel_rtt_ms": NEUTRAL,
    "dedup_ratio": NEUTRAL,
    "cap_fraction": NEUTRAL,
    "occupancy_p50": NEUTRAL,
    "occupancy_p99": NEUTRAL,
    "node_cap_full": NEUTRAL,
    "node_cap_calibrated": NEUTRAL,
    "cache_capacity_rows": NEUTRAL,
    "epoch_batches": NEUTRAL,
    "scanned_group": NEUTRAL,
    "refresh_nodes_per_s": UP,
    "refresh_bytes_from_hbm": NEUTRAL,
    "refresh_bytes_from_dram": NEUTRAL,
    "refresh_bytes_from_disk": NEUTRAL,
    "refresh_stage_errors": DOWN,
    "gather_effective_speedup_bf16": UP,
    "gather_effective_speedup_int8": UP,
    "fleet_affinity_hit_rate": UP,
    "fleet_random_hit_rate": NEUTRAL,
    "fleet_affinity_gain": UP,
    "fleet_p99_ms": DOWN,
    "fleet_recovery_s": DOWN,
    "fleet_structured_reject_frac": NEUTRAL,
    "fleet_unstructured_errors": DOWN,
    "fleet_hit_rate_reconverged": UP,
    "fleet_replica_kills": NEUTRAL,
}

#: ``(suffix, direction)`` checked in order after the explicit table.
_SUFFIX_DIRECTIONS: Tuple[Tuple[str, int], ...] = (
    ("_gb_s", UP),
    ("_m_edges_s", UP),
    ("_edges_s", UP),
    ("_tflops", UP),
    ("_per_s", UP),
    ("_speedup", UP),
    ("_frac", UP),
    ("_ms", DOWN),
    ("_ms_per_batch", DOWN),
)

#: ``(infix, direction)`` for width/variant-suffixed families
#: (``gather_gb_s_naive``, ``gather_ms_d128``, ``epoch_s_config1``).
_INFIX_DIRECTIONS: Tuple[Tuple[str, int], ...] = (
    ("_gb_s_", UP),
    ("tflops", UP),
    ("_ms_", DOWN),
    ("epoch_s_", DOWN),
    ("epoch_best", DOWN),
)

#: Metric targets, ``{metric: (">=" | "<=", target)}``: flat while
#: unmet => ``stuck``.  Empty until the port's benchmark sets the
#: card's targets.
ASPIRATIONS: Dict[str, Tuple[str, float]] = {}

#: NEUTRAL-with-ceiling: metrics with no better/worse direction that
#: must still stay under a hard bound (peak device memory against the
#: card's capacity).  A NEUTRAL metric normally short-circuits to
#: ``info``; exceeding its ceiling verdicts ``regress``.  Empty until
#: the port's benchmark records one.
CEILINGS: Dict[str, float] = {}


def direction(metric: str) -> int:
    if metric in EXPLICIT_DIRECTIONS:
        return EXPLICIT_DIRECTIONS[metric]
    for suffix, d in _SUFFIX_DIRECTIONS:
        if metric.endswith(suffix):
            return d
    for infix, d in _INFIX_DIRECTIONS:
        if infix in metric:
            return d
    return NEUTRAL


def load_bench_metrics(path: str) -> Optional[Dict[str, Any]]:
    """The metrics dict of one bench snapshot, or None if unparseable.

    Accepts three shapes: the driver wrapper (``{"parsed": {...}}`` or
    ``{"tail": "...<one JSON line>..."}``), and a raw ``bench.py``
    output line / JSON object (``{"metric": ..., "value": ...}``) as
    written by ``GLT_BENCH_OUT``.
    """
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    try:
        obj = json.loads(text)
    except ValueError:
        obj = None
    if isinstance(obj, dict):
        if isinstance(obj.get("parsed"), dict):
            return obj["parsed"]
        if "metric" in obj or "value" in obj:
            return obj
        text = obj.get("tail", "")
    # Fall back to the last parseable JSON line (bench stdout capture).
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
        if isinstance(parsed, dict):
            return parsed
    return None


def _aspiration_met(metric: str, value: float) -> Optional[bool]:
    asp = ASPIRATIONS.get(metric)
    if asp is None:
        return None
    op, target = asp
    return value >= target if op == ">=" else value <= target


def compare(
    runs: Sequence[Tuple[str, Dict[str, Any]]],
    rel_tol: float = 0.05,
    noise_k: float = 3.0,
    flat_tol: float = 0.05,
    flat_window: int = 3,
) -> Dict[str, Any]:
    """Trend + verdict over ``[(label, metrics), ...]`` (oldest first,
    the last run is the one under judgment — typically a fresh bench).

    Returns ``{"labels", "rows", "regressions", "improvements",
    "stuck", "verdict"}``; each row carries the per-run values, the
    baseline (median of prior rounds), the direction-adjusted relative
    delta, and a status in ``regress / improve / stuck / ok / flat /
    new / gone / info``.
    """
    if len(runs) < 2:
        raise ValueError("need at least two runs to compare")
    labels = [label for label, _ in runs]
    ordered: List[str] = []
    seen = set()
    for _, metrics in reversed(runs):      # latest run's order wins
        for k in metrics:
            if k not in seen:
                seen.add(k)
                ordered.append(k)

    rows: List[Dict[str, Any]] = []
    regressions: List[str] = []
    improvements: List[str] = []
    stuck: List[str] = []
    for metric in ordered:
        values: List[Optional[float]] = []
        for _, metrics in runs:
            v = metrics.get(metric)
            values.append(float(v)
                          if isinstance(v, (int, float))
                          and not isinstance(v, bool) else None)
        if all(v is None for v in values):
            continue                        # string metric (paths, units)
        d = direction(metric)
        latest = values[-1]
        prior = [v for v in values[:-1] if v is not None]
        row: Dict[str, Any] = {"metric": metric, "values": values,
                               "direction": d, "baseline": None,
                               "rel_delta": None}
        if latest is None:
            row["status"] = "gone"
            rows.append(row)
            continue
        if not prior:
            row["status"] = "new"
            rows.append(row)
            continue
        baseline = statistics.median(prior)
        row["baseline"] = baseline
        delta = latest - baseline
        rel = delta / abs(baseline) if baseline else (0.0 if not delta
                                                      else float("inf"))
        row["rel_delta"] = rel
        if d == NEUTRAL:
            ceiling = CEILINGS.get(metric)
            if ceiling is not None and latest > ceiling:
                row["status"] = "regress"
                row["ceiling"] = ceiling
                regressions.append(metric)
            else:
                row["status"] = "info"
            rows.append(row)
            continue
        # Robust spread of the history: MAD scaled to sigma.
        if len(prior) >= 2:
            mad = statistics.median(abs(v - baseline) for v in prior)
            sigma = 1.4826 * mad
        else:
            sigma = 0.0
        threshold = max(rel_tol * abs(baseline), noise_k * sigma)
        status = "ok"
        if abs(delta) > threshold:
            status = "improve" if delta * d > 0 else "regress"
        # Stuck: flat over the recent window while missing the target.
        met = _aspiration_met(metric, latest)
        if met is False and status in ("ok", "regress"):
            recent = [v for v in values[-flat_window:] if v is not None]
            if len(recent) >= flat_window:
                center = statistics.median(recent)
                spread = max(recent) - min(recent)
                if abs(center) > 0 and spread <= flat_tol * abs(center):
                    status = "stuck"
        row["status"] = status
        if status == "regress":
            regressions.append(metric)
        elif status == "improve":
            improvements.append(metric)
        elif status == "stuck":
            stuck.append(metric)
        rows.append(row)

    verdict = ("regress" if regressions
               else "improve" if improvements else "ok")
    return {"labels": labels, "rows": rows, "regressions": regressions,
            "improvements": improvements, "stuck": stuck,
            "verdict": verdict}


_STATUS_MARK = {"regress": "🔴 regress", "improve": "🟢 improve",
                "stuck": "🟡 stuck", "ok": "ok", "flat": "ok",
                "new": "new", "gone": "gone", "info": "·"}


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "—"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.4g}"


def markdown_report(report: Dict[str, Any]) -> str:
    """The trend table + verdict as CI-artifact markdown."""
    labels = report["labels"]
    lines = ["# Bench trend report", ""]
    lines.append(f"**Verdict: {report['verdict']}** — "
                 f"{len(report['regressions'])} regressed, "
                 f"{len(report['improvements'])} improved, "
                 f"{len(report['stuck'])} stuck "
                 f"(latest run: `{labels[-1]}`).")
    lines.append("")
    for kind, names in (("Regressions", report["regressions"]),
                        ("Improvements", report["improvements"]),
                        ("Stuck (flat while missing target)",
                         report["stuck"])):
        if names:
            lines.append(f"**{kind}:** " + ", ".join(
                f"`{n}`" for n in names))
            lines.append("")
    header = ["metric"] + labels + ["Δ vs median", "status"]
    lines.append("| " + " | ".join(header) + " |")
    lines.append("|" + "|".join(["---"] * len(header)) + "|")
    for row in report["rows"]:
        rel = row["rel_delta"]
        rel_s = "—" if rel is None else f"{rel:+.1%}"
        cells = ([f"`{row['metric']}`"]
                 + [_fmt(v) for v in row["values"]]
                 + [rel_s, _STATUS_MARK.get(row["status"],
                                            row["status"])])
        lines.append("| " + " | ".join(cells) + " |")
    lines.append("")
    lines.append("Directions: `*_ms` down-good, `*_gb_s`/`*_frac`/"
                 "throughput up-good; `·` rows are tracked but "
                 "directionless.  Thresholds are noise-tolerant "
                 "(median ± max(rel_tol, 3·MAD)); see "
                 "`glt_tpu_torch/obs/regress.py`.")
    return "\n".join(lines)
