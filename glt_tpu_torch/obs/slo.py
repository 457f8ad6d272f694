"""SLO monitor: declarative objectives + multi-window burn-rate alerts.

Shed-load and scaling decisions derive from the ``glt.serving.*``
histograms; this module evaluates those histograms against targets.  Specs are
declarative (:class:`SloSpec`), evaluation is windowed (the monitor
samples instrument state on a thread and differences cumulative
counters/buckets over sliding windows), and the output is three-way:

* a structured ``slo.alert`` event into the flight recorder (the
  postmortem sees WHICH objective burned before the crash),
* ``glt.slo.*`` instruments for the Prometheus exposition
  (``glt.slo.firing{slo=...}`` gauge + ``glt.slo.alerts`` counter),
* an ``on_alert`` callback seam — the serving front consumes it to
  shed load.

**Burn rate** is consumption of the error budget, normalized so 1.0
means "exactly at objective": a ratio spec with objective 0.05 burning
at 2.0 is rejecting 10% of requests; a ``<=`` latency spec burning at
2.0 has a windowed p99 at twice its bound.  An alert FIRES only when
every configured window exceeds its threshold — the classic
multi-window rule: the long window proves sustained damage, the short
window proves it is still happening (so alerts auto-resolve quickly
once the burn stops).

Windowed quantiles come from differencing a histogram's cumulative
bucket counts between two samples — the delta IS the window's
histogram, fed through the same interpolation as
:meth:`~glt_tpu_torch.obs.metrics.Histogram.quantile`.

Stdlib only (usable wherever :mod:`.metrics` is).  All window math uses
``time.monotonic()`` (GLT015: wall clock never measures durations).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

from . import flight as _flight
from . import metrics as _metrics

#: (window_seconds, burn_threshold) pairs: fast-burn page + slow-burn
#: confirmation, scaled down from the SRE-book hours to engine-loop
#: seconds (a serving incident is over in minutes, not days).
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((30.0, 1.0),
                                                    (5.0, 1.0))

_M_ALERTS = _metrics.counter(
    "glt.slo.alerts", "SLO burn alerts fired (all specs)")
_M_TICKS = _metrics.counter(
    "glt.slo.ticks", "SLO monitor evaluation passes")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative objective over existing ``glt.*`` instruments.

    ``kind``:
      * ``"quantile"`` — windowed q-quantile of histogram ``metric``
        compared against ``objective`` (ms, usually).
      * ``"ratio"`` — windowed ``metric`` delta over the windowed
        ``metric + denom`` delta (bad events over total events),
        objective = the budgeted bad fraction.
      * ``"gauge"`` — instantaneous gauge value against ``objective``.

    ``comparison`` is the HEALTHY direction (``"<="``: healthy while
    value <= objective).  ``windows`` is a sequence of
    ``(window_seconds, burn_threshold)``; ALL must exceed to fire.
    ``shed_frac`` rides into the alert payload for admission-control
    consumers.
    """
    name: str
    metric: str
    objective: float
    kind: str = "quantile"
    q: float = 0.99
    denom: Optional[str] = None
    comparison: str = "<="
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    shed_frac: float = 0.5

    def __post_init__(self):
        if self.kind not in ("quantile", "ratio", "gauge"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.comparison not in ("<=", ">="):
            raise ValueError(f"comparison must be <= or >=, "
                             f"got {self.comparison!r}")
        if self.kind == "ratio" and not self.denom:
            raise ValueError(f"ratio spec {self.name!r} needs denom")
        if self.objective <= 0:
            raise ValueError(f"objective must be > 0 for burn math "
                             f"(spec {self.name!r})")
        if not self.windows:
            raise ValueError(f"spec {self.name!r} has no windows")


def spec_from_dict(d: Mapping[str, Any]) -> SloSpec:
    """Parse the declarative form documented in docs/observability.md:

        {"name": "serving_p99", "metric": "glt.serving.e2e_ms",
         "kind": "quantile", "q": 0.99, "objective": 50.0,
         "comparison": "<=", "windows": [[30, 1.0], [5, 1.0]]}
    """
    d = dict(d)
    if "windows" in d:
        d["windows"] = tuple((float(w), float(t)) for w, t in d["windows"])
    return SloSpec(**d)


def default_specs(serving_p99_ms: float = 100.0,
                  reject_budget: float = 0.10,
                  step_ms: float = 1000.0,
                  store_hit_rate: float = 0.5) -> List[SloSpec]:
    """The fleet objectives, over existing instruments."""
    return [
        SloSpec(name="serving_p99",
                metric="glt.serving.e2e_ms", kind="quantile", q=0.99,
                objective=serving_p99_ms, comparison="<="),
        SloSpec(name="serving_rejects",
                metric="glt.serving.rejected_overload", kind="ratio",
                denom="glt.serving.requests",
                objective=reject_budget, comparison="<="),
        SloSpec(name="train_step",
                metric="glt.train.block_ms", kind="quantile", q=0.95,
                objective=step_ms, comparison="<="),
        SloSpec(name="store_hit_rate",
                metric="glt.store.hit_rate", kind="gauge",
                objective=store_hit_rate, comparison=">="),
    ]


class _History:
    """Per-spec sample history: (monotonic t, state) tuples, pruned to
    the spec's longest window."""

    def __init__(self, horizon_s: float):
        self.horizon_s = horizon_s
        self.samples: List[Tuple[float, Any]] = []

    def push(self, t: float, state: Any) -> None:
        self.samples.append((t, state))
        cutoff = t - self.horizon_s - 1.0
        while len(self.samples) > 2 and self.samples[1][0] <= cutoff:
            self.samples.pop(0)

    def at_or_before(self, t: float) -> Optional[Tuple[float, Any]]:
        best = None
        for s in self.samples:
            if s[0] <= t:
                best = s
            else:
                break
        return best


class SloMonitor:
    """Evaluate :class:`SloSpec` objectives on a sampling loop.

    ``tick()`` is the whole evaluation pass and is public so tests and
    CI smoke steps drive it deterministically (with an injected ``now``
    to simulate minutes in microseconds); ``start()`` runs it on a
    daemon thread at ``interval_s``.  Alerts go to the flight recorder,
    the ``glt.slo.*`` instruments, and ``on_alert(alert_dict)``.
    """

    def __init__(self, specs: Sequence[SloSpec],
                 interval_s: float = 1.0,
                 on_alert: Optional[Callable[[dict], None]] = None,
                 delta_interval_s: float = 30.0):
        self.specs = list(specs)
        self.interval_s = float(interval_s)
        self.on_alert = on_alert
        self.delta_interval_s = float(delta_interval_s)
        self._hist: Dict[str, _History] = {
            s.name: _History(max(w for w, _ in s.windows))
            for s in self.specs}
        self._firing: Dict[str, bool] = {s.name: False for s in self.specs}
        self._gauges = {
            s.name: _metrics.gauge(
                "glt.slo.firing", "1 while the SLO is in burn alert",
                labels={"slo": s.name})
            for s in self.specs}
        self._last_eval: Dict[str, dict] = {}
        self._last_delta_t: Optional[float] = None
        self._last_snapshot: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- sampling ----------------------------------------------------------
    def _observe(self, spec: SloSpec) -> Optional[Any]:
        """Read the spec's instrument state (None: instrument absent)."""
        reg = _metrics.REGISTRY
        if spec.kind == "quantile":
            for inst in reg.instruments():
                if (isinstance(inst, _metrics.Histogram)
                        and inst.full_name == spec.metric):
                    with inst._lock:
                        return tuple(inst._counts)
            return None
        snap = None
        if spec.kind == "ratio":
            snap = _metrics.snapshot()
            bad = snap.get(spec.metric)
            good = snap.get(spec.denom)
            if bad is None and good is None:
                return None
            return (float(bad or 0.0), float(good or 0.0))
        snap = _metrics.snapshot()
        v = snap.get(spec.metric)
        return None if v is None else float(v)

    def _window_value(self, spec: SloSpec, hist: _History,
                      now: float, window_s: float) -> Optional[float]:
        """The spec's measured value over [now - window_s, now]."""
        cur = hist.at_or_before(now)
        if cur is None:
            return None
        if spec.kind == "gauge":
            return float(cur[1])
        past = hist.at_or_before(now - window_s)
        if past is None or past[0] == cur[0]:
            return None
        if spec.kind == "quantile":
            delta = [c - p for c, p in zip(cur[1], past[1])]
            if any(d < 0 for d in delta):     # reset mid-window
                return None
            return _metrics.quantile_from_counts(
                self._buckets_of(spec), delta, spec.q)
        bad = cur[1][0] - past[1][0]
        total = bad + (cur[1][1] - past[1][1])
        if bad < 0 or total <= 0:
            return None
        return bad / total

    def _buckets_of(self, spec: SloSpec) -> Tuple[float, ...]:
        for inst in _metrics.REGISTRY.instruments():
            if (isinstance(inst, _metrics.Histogram)
                    and inst.full_name == spec.metric):
                return inst.buckets
        return _metrics.DEFAULT_BUCKETS_MS

    def _burn(self, spec: SloSpec, value: float) -> float:
        if spec.comparison == "<=":
            return value / spec.objective
        # ">=": burn grows as the value falls below the objective.
        if value <= 0:
            return float("inf")
        return spec.objective / value

    # -- evaluation --------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One sample + evaluation pass; returns alerts EMITTED this
        pass (state transitions only, not steady firing)."""
        now = time.monotonic() if now is None else float(now)
        _M_TICKS.inc()
        emitted: List[dict] = []
        with self._lock:
            for spec in self.specs:
                state = self._observe(spec)
                hist = self._hist[spec.name]
                if state is not None:
                    hist.push(now, state)
                burns: Dict[str, Optional[float]] = {}
                values: Dict[str, Optional[float]] = {}
                all_exceeded = bool(spec.windows)
                for window_s, threshold in spec.windows:
                    v = self._window_value(spec, hist, now, window_s)
                    key = f"{window_s:g}s"
                    values[key] = v
                    if v is None:
                        burns[key] = None
                        all_exceeded = False
                        continue
                    b = self._burn(spec, v)
                    burns[key] = round(b, 4)
                    if not b > threshold:
                        all_exceeded = False
                was = self._firing[spec.name]
                self._last_eval[spec.name] = {
                    "firing": all_exceeded, "burn": burns,
                    "value": values,
                }
                if all_exceeded == was:
                    continue
                self._firing[spec.name] = all_exceeded
                alert = {
                    "slo": spec.name,
                    "state": "firing" if all_exceeded else "resolved",
                    "metric": spec.metric,
                    "objective": spec.objective,
                    "comparison": spec.comparison,
                    "burn": burns,
                    "value": values,
                    "shed_frac": spec.shed_frac if all_exceeded else 0.0,
                }
                emitted.append(alert)
        for alert in emitted:
            self._gauges[alert["slo"]].set(
                1.0 if alert["state"] == "firing" else 0.0)
            if alert["state"] == "firing":
                _M_ALERTS.inc()
            _flight.record("slo.alert", **alert)
            if self.on_alert is not None:
                try:
                    self.on_alert(alert)
                except Exception:  # noqa: BLE001 — the monitor must live
                    pass
        self._record_metric_deltas(now)
        return emitted

    def _record_metric_deltas(self, now: float) -> None:
        """Periodic ``metrics.delta`` flight events: the top changed
        counters since the last delta tick (bounded, so the ring holds
        trend context without drowning the discrete events)."""
        if (self._last_delta_t is not None
                and now - self._last_delta_t < self.delta_interval_s):
            return
        snap = _metrics.snapshot()
        prev, self._last_snapshot = self._last_snapshot, snap
        self._last_delta_t = now
        if not prev:
            return
        changed = {k: round(v - prev.get(k, 0.0), 4)
                   for k, v in snap.items()
                   if abs(v - prev.get(k, 0.0)) > 1e-12}
        if changed:
            top = dict(sorted(changed.items(),
                              key=lambda kv: -abs(kv[1]))[:12])
            _flight.record("metrics.delta", deltas=top)

    # -- queries / lifecycle -----------------------------------------------
    def states(self) -> Dict[str, dict]:
        """Last evaluation per spec (the health table wire ops serve)."""
        with self._lock:
            return {k: dict(v) for k, v in self._last_eval.items()}

    def firing(self) -> List[str]:
        with self._lock:
            return [k for k, v in self._firing.items() if v]

    def start(self) -> "SloMonitor":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="glt-slo-monitor")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — sampling must not die
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0 + self.interval_s)
