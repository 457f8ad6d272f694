"""Triggered ``torch.profiler`` capture: traces when something is wrong
(cf. ``glt_tpu/obs/profiler.py``).

Always-on device tracing is too heavy for production; never-on tracing
means the trace you need exists only for the run you didn't profile.
This module makes capture **event-driven**: a short, bounded
``torch.profiler`` trace fires exactly when an SLO burns, a step
latency spikes, or an operator asks — and every capture is indexed in
the flight ring so the postmortem knows which trace belongs to which
incident (``python -m glt_tpu_torch.obs merge`` folds the index into
the merged timeline).

* :func:`capture` — the balanced primitive: the profiler is started on
  entry and stopped in ``finally``, then its Chrome trace is written to
  ``<log_dir>/trace.json``; with CUDA it traces the card too, after
  ``SETTLE_S`` of idle time (the profiler can lose the device records
  of work launched just after it starts).  An optional ``millis`` floor
  lets a trigger path grab a fixed-length window with
  ``with capture(d, millis=50): pass``.
* :class:`TriggeredProfiler` — rate-limited trigger sink
  (``min_interval_s`` between captures, ``max_captures`` per process)
  with a per-capture index; :meth:`slo_on_alert` adapts it onto the
  :class:`~glt_tpu_torch.obs.slo.SloMonitor` ``on_alert`` seam (one
  capture per firing transition, resolved transitions pass through
  untouched).
* :class:`SpikeDetector` — the step-latency trigger: observes the same
  stream ``glt.train.block_ms`` records and fires when one block runs
  ``factor``× over the trailing median.
* Module arming — :func:`arm` / :func:`maybe_arm_from_env`
  (``GLT_PROFILE_TRIGGER_DIR``) install a process-default profiler;
  :func:`spike_observe` is the near-zero-cost hook the train loop
  calls per block (a global read + branch while disarmed).

Module-level code is stdlib-only; torch is imported inside
:func:`capture`.
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import statistics
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from . import flight as _flight
from . import metrics as _metrics

#: Upper bound on a single bounded capture: triggers must never turn
#: into minutes of tracing on a serving host.
MAX_CAPTURE_MILLIS = 2000.0

_M_CAPTURES = _metrics.counter(
    "glt.profiler.captures", "profiler captures completed")
_M_SUPPRESSED = _metrics.counter(
    "glt.profiler.suppressed",
    "profiler triggers suppressed by rate limiting")
_M_SPIKES = _metrics.counter(
    "glt.profiler.spikes", "step-latency spikes detected")


#: Idle time between the profiler's start and the traced work on the
#: card: without it the profiler can lose the device records of work
#: launched just after it starts.
SETTLE_S = 0.1


@contextlib.contextmanager
def capture(log_dir: str, millis: Optional[float] = None,
            reason: str = "manual"):
    """Balanced profiler capture into ``log_dir``.

    ``torch.profiler`` starts on entry (with CUDA activity when a card
    is present, after ``SETTLE_S`` of idle time) and stops in
    ``finally``; its Chrome trace goes to ``<log_dir>/trace.json``.
    With ``millis``, the capture lasts at least that long (the trigger
    paths use ``with capture(d, millis=50): pass``).  Indexed in the
    flight ring as a ``profiler.capture`` event.
    """
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.monotonic()
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(SETTLE_S)
        yield log_dir
        if millis is not None:
            remaining = min(float(millis),
                            MAX_CAPTURE_MILLIS) / 1e3 - (
                                time.monotonic() - t0)
            if remaining > 0:
                time.sleep(remaining)
        if cuda:
            torch.cuda.synchronize()
    finally:
        try:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        finally:
            dur_ms = (time.monotonic() - t0) * 1e3
            _M_CAPTURES.inc()
            _flight.record("profiler.capture", dir=str(log_dir),
                           reason=str(reason), ms=round(dur_ms, 3))


def capture_index(events: Iterable[dict]) -> List[dict]:
    """The ``profiler.capture`` events of a flight event stream —
    the per-incident trace index ``obs merge`` folds into merged
    dumps."""
    return [dict(e) for e in events
            if isinstance(e, dict) and e.get("kind") == "profiler.capture"]


class TriggeredProfiler:
    """Rate-limited capture sink for alert/spike/wire triggers.

    One bounded capture per trigger, at most one per
    ``min_interval_s`` and ``max_captures`` per process — an SLO that
    stays burning produces one trace per firing, not a trace storm on
    top of a latency storm.
    """

    def __init__(self, base_dir: str, millis: float = 50.0,
                 min_interval_s: float = 60.0, max_captures: int = 16):
        self.base_dir = str(base_dir)
        self.millis = min(float(millis), MAX_CAPTURE_MILLIS)
        self.min_interval_s = float(min_interval_s)
        self.max_captures = int(max_captures)
        self.captures: List[Dict[str, Any]] = []
        self._last_t: Optional[float] = None
        self._seq = 0
        self._lock = threading.Lock()

    def trigger(self, reason: str,
                now: Optional[float] = None) -> Optional[str]:
        """Run one bounded capture; returns its dir, or None when
        rate-limited, capped, or the capture itself failed (telemetry
        never raises into the trigger site)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if (self._last_t is not None
                    and now - self._last_t < self.min_interval_s):
                _M_SUPPRESSED.inc()
                return None
            if len(self.captures) >= self.max_captures:
                _M_SUPPRESSED.inc()
                return None
            self._last_t = now
            self._seq += 1
            seq = self._seq
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason))[:64]
        log_dir = os.path.join(self.base_dir, f"capture_{seq:03d}_{slug}")
        try:
            with capture(log_dir, millis=self.millis, reason=reason):
                pass
        except Exception as e:  # noqa: BLE001 — must not raise upward
            _flight.record("profiler.error", reason=str(reason),
                           error=repr(e))
            return None
        entry = {"dir": log_dir, "reason": str(reason), "seq": seq}
        with self._lock:
            self.captures.append(entry)
        return log_dir

    def slo_on_alert(self, downstream: Optional[Callable] = None
                     ) -> Callable[[dict], None]:
        """An ``SloMonitor(on_alert=...)`` adapter: capture once per
        firing transition, then forward the alert to ``downstream``
        (e.g. ``ServingFront.slo_alert``) untouched."""
        def on_alert(alert: dict) -> None:
            try:
                if alert.get("state") == "firing":
                    self.trigger("slo:" + str(alert.get("slo", "?")))
            finally:
                if downstream is not None:
                    downstream(alert)
        return on_alert


class SpikeDetector:
    """Step-latency spike trigger over the ``glt.train.block_ms``
    stream: one block ``factor``× over the trailing median fires."""

    def __init__(self, profiler: Optional[TriggeredProfiler] = None,
                 factor: float = 4.0, min_samples: int = 16,
                 window: int = 64):
        self.profiler = profiler
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self._recent: collections.deque = collections.deque(
            maxlen=int(window))
        self._lock = threading.Lock()

    def observe(self, ms: float) -> bool:
        """Feed one block latency; True when it is a spike."""
        ms = float(ms)
        with self._lock:
            baseline = (statistics.median(self._recent)
                        if len(self._recent) >= self.min_samples
                        else None)
            self._recent.append(ms)
        spike = baseline is not None and ms > self.factor * max(
            baseline, 1e-3)
        if spike:
            _M_SPIKES.inc()
            _flight.record("profiler.spike", ms=round(ms, 3),
                           baseline_ms=round(baseline, 3),
                           factor=self.factor)
            if self.profiler is not None:
                self.profiler.trigger(f"latency_spike_{ms:.0f}ms")
        return spike


# -- process-default arming -------------------------------------------------
_armed: Optional[TriggeredProfiler] = None
_spike: Optional[SpikeDetector] = None


def arm(base_dir: str, millis: float = 50.0, min_interval_s: float = 60.0,
        max_captures: int = 16, spike_factor: float = 4.0,
        spike_min_samples: int = 16) -> TriggeredProfiler:
    """Install the process-default profiler + spike detector."""
    global _armed, _spike
    prof = TriggeredProfiler(base_dir, millis=millis,
                             min_interval_s=min_interval_s,
                             max_captures=max_captures)
    _armed = prof
    _spike = SpikeDetector(profiler=prof, factor=spike_factor,
                           min_samples=spike_min_samples)
    _flight.record("profiler.armed", dir=str(base_dir), millis=millis)
    return prof


def disarm() -> None:
    global _armed, _spike
    _armed = None
    _spike = None


def armed() -> Optional[TriggeredProfiler]:
    return _armed


def maybe_arm_from_env() -> Optional[TriggeredProfiler]:
    """Arm from ``GLT_PROFILE_TRIGGER_DIR`` if set and not yet armed."""
    if _armed is None:
        base = os.environ.get("GLT_PROFILE_TRIGGER_DIR")
        if base:
            return arm(base)
    return _armed


def spike_observe(ms: float) -> bool:
    """Per-block hook (train loop): global read + branch when
    disarmed."""
    det = _spike
    if det is None:
        return False
    return det.observe(ms)
