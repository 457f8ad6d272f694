"""Flight recorder: an always-on black box for postmortem telemetry.

The tracer and metrics answer questions someone ASKED —
``GLT_OBS_TRACE`` armed, metrics enabled, the incident re-run.  Chaos
failures do not wait for arming: a peer dies, a producer is SIGKILLed,
an engine faults, and the process that noticed carries the only record
of the last few seconds.  This module keeps that record unconditionally:

* **Ring buffer.**  A fixed-size :class:`collections.deque` of
  structured events (reconnects, replays, admission rejections,
  evictions, supervisor beats/deaths, SLO alerts, epoch summaries).
  Recording is one lock + dict build + append — nanoseconds-to-
  microseconds, and every call site is an already-rare control-plane
  event, never the per-batch hot path.
* **Crash dump.**  The ring is dumped atomically (GLT011 tmp +
  ``os.replace``) on SIGTERM, on an uncaught exception, on
  an emergency checkpoint (the training loop calls :func:`dump_now`),
  and on demand (:meth:`FlightRecorder.dump`).  Handlers
  self-install on the FIRST recorded event — no arming step exists.
* **Fleet view.**  :func:`merge_flight_dumps` folds per-process dumps
  into one time-ordered stream (``python -m glt_tpu_torch.obs merge`` routes
  flight dumps here automatically).

Stdlib only (the :mod:`.metrics` constraint): importable from the
analysis CI image and from pure-host tooling, no torch/numpy.
The dump format is ``glt_tpu``'s: a dump written by either package
validates and merges in the other.

Event schema (docs/observability.md "Flight recorder"):

    {"seq": 42, "ts": <unix seconds>, "kind": "server.replay", ...}

``seq`` is a per-process monotonic counter (gaps at the front of a dump
mean the ring wrapped — ``dropped`` counts them); ``ts`` is wall-clock
``time.time()`` so dumps from different hosts merge on a common axis
(coarse NTP alignment is enough for postmortem ordering; durations are
never computed from it — gltlint GLT015).
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import socket
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

SCHEMA_KEY = "glt_flight"
SCHEMA_VERSION = 1

DEFAULT_CAPACITY = 512

_ENV_DIR = "GLT_FLIGHT_DIR"
_ENV_CAPACITY = "GLT_FLIGHT_EVENTS"


class FlightRecorder:
    """Fixed-capacity ring of structured events + atomic dumper.

    One per process (module singleton :func:`recorder`); thread-safe.
    """

    def __init__(self, capacity: Optional[int] = None,
                 role: Optional[str] = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get(_ENV_CAPACITY,
                                              DEFAULT_CAPACITY))
            except ValueError:
                capacity = DEFAULT_CAPACITY
        self.capacity = max(8, int(capacity))
        self.role = str(role) if role else "proc"
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._dumped: List[str] = []

    # The event envelope — no field may shadow these, or the dump's
    # ordering proof breaks (a replayed message's seq=0 once clobbered
    # the ring seq); colliding fields are kept under an x_ prefix.
    _ENVELOPE = ("seq", "ts", "kind")

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, /, **fields: Any) -> None:
        """Append one event.  Always on; never raises.  ``kind`` is
        positional-only so a stray ``kind=`` field (e.g. via ``**report``
        passthrough) lands in ``fields`` instead of a TypeError."""
        try:
            with self._lock:
                seq = self._seq
                self._seq += 1
                ev = {"seq": seq, "ts": time.time(), "kind": str(kind)}
                for k, v in fields.items():
                    ev["x_" + k if k in self._ENVELOPE else k] = v
                self._ring.append(ev)
        except Exception:  # noqa: BLE001 — the black box must not crash
            pass
        _install_crash_handlers()

    def events(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._ring]

    @property
    def recorded(self) -> int:
        """Total events ever recorded (>= len(ring) once wrapped)."""
        return self._seq

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around."""
        with self._lock:
            return max(0, self._seq - len(self._ring))

    def clear(self) -> None:
        """Drop all events and reset the sequence (tests)."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dumped = []

    # -- dumping -----------------------------------------------------------
    def snapshot(self, reason: str = "snapshot") -> dict:
        """JSON-able dump object: metadata + the ring's events."""
        with self._lock:
            events = [dict(ev) for ev in self._ring]
            seq = self._seq
        return {
            SCHEMA_KEY: SCHEMA_VERSION,
            "pid": os.getpid(),
            "role": self.role,
            "host": socket.gethostname(),
            "reason": str(reason),
            "dumped_at": time.time(),
            "capacity": self.capacity,
            "recorded": seq,
            "dropped": max(0, seq - len(events)),
            "events": events,
        }

    def default_path(self) -> str:
        d = os.environ.get(_ENV_DIR) or tempfile.gettempdir()
        return os.path.join(
            d, f"glt_flight-{self.role}-{os.getpid()}.json")

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        """Write the ring atomically (GLT011 tmp + ``os.replace``).

        The dump is readable at every instant: a reader sees either the
        previous complete dump or this one, never a torn file.
        """
        path = path or self.default_path()
        obj = self.snapshot(reason=reason)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(obj, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        with self._lock:
            self._dumped.append(path)
        return path


#: The process-global recorder every hook site records into.
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, /, **fields: Any) -> None:
    """Record one event into the process recorder (always on)."""
    _RECORDER.record(kind, **fields)


def configure(capacity: Optional[int] = None,
              role: Optional[str] = None) -> FlightRecorder:
    """Adjust the process recorder (capacity change drops nothing that
    still fits; role tags later dumps)."""
    global _RECORDER
    if capacity is not None and int(capacity) != _RECORDER.capacity:
        old = _RECORDER.events()
        fresh = FlightRecorder(capacity=capacity,
                               role=role or _RECORDER.role)
        for ev in old[-fresh.capacity:]:
            fresh._ring.append(ev)
        fresh._seq = _RECORDER._seq
        _RECORDER = fresh
    elif role is not None:
        _RECORDER.role = str(role)
    return _RECORDER


def dump_now(reason: str, path: Optional[str] = None) -> Optional[str]:
    """Best-effort dump for fatal paths (``SupervisedExit``, emergency
    checkpoint): never raises — the exception in flight outranks the
    black box.  Returns the written path, or None on failure."""
    try:
        return _RECORDER.dump(path=path, reason=reason)
    except Exception:  # noqa: BLE001 — fatal path; must not mask the cause
        return None


# -- crash-time dumping ------------------------------------------------------
# Mirrors the tracer's crash-flush discipline: handlers chain to
# whatever was installed before (the tracer's SIGTERM flush included) and
# install exactly once, from the first recorded event — so a process that
# ever produced an event needs zero arming to leave a black box behind.
_handlers_lock = threading.Lock()
_handlers_installed = False


def _dump_best_effort(reason: str) -> None:
    try:
        if _RECORDER.recorded:
            _RECORDER.dump(reason=reason)
    except Exception:  # noqa: BLE001 — dying; nothing useful to do
        pass


def _install_crash_handlers() -> None:
    global _handlers_installed
    if _handlers_installed:
        return
    with _handlers_lock:
        if _handlers_installed:
            return
        _handlers_installed = True

        prev_hook = sys.excepthook

        def hook(exc_type, exc, tb):
            record("process.uncaught", exc=getattr(
                exc_type, "__name__", str(exc_type)), msg=str(exc)[:200])
            _dump_best_effort(f"uncaught:{exc_type.__name__}")
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook
        atexit.register(_atexit_dump)
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def on_term(signum, frame):
                record("process.sigterm")
                _dump_best_effort("sigterm")
                # Chain: restore whatever was installed before (the
                # tracer's flush handler included) and re-raise, so the
                # process still dies with the TERM disposition.
                signal.signal(signum, prev if callable(prev)
                              else signal.SIG_DFL)
                os.kill(os.getpid(), signum)

            signal.signal(signal.SIGTERM, on_term)
        except ValueError:
            # Not the main thread — the atexit/excepthook half still runs.
            pass


def _atexit_dump() -> None:
    # Normal exits only leave a file when the operator opted in with
    # GLT_FLIGHT_DIR; crash paths (SIGTERM/uncaught/fatal) always dump.
    if os.environ.get(_ENV_DIR):
        _dump_best_effort("atexit")


# -- validation / merge ------------------------------------------------------
def validate_flight_dump(obj: Any) -> List[str]:
    """Structural problems of a flight dump ([] = valid).

    The contract the chaos tests and ``obs merge`` assert on: schema
    marker, metadata fields, events as dicts with monotonically
    increasing ``seq`` and the required ``ts``/``kind`` fields.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or SCHEMA_KEY not in obj:
        return [f"not a flight dump (missing {SCHEMA_KEY!r} marker)"]
    # A merged stream (merge_flight_dumps) carries per-source metadata
    # under "sources" and interleaves processes, so seq is monotonic
    # PER PROCESS rather than globally.
    is_merged = "merged_from" in obj
    required = (("sources", "events") if is_merged
                else ("pid", "role", "reason", "capacity", "recorded",
                      "dropped", "events"))
    for field in required:
        if field not in obj:
            problems.append(f"missing field {field!r}")
    events = obj.get("events")
    if not isinstance(events, list):
        return problems + ["events is not a list"]
    prev_seq: Dict[Any, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        for field in ("seq", "ts", "kind"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
        seq = ev.get("seq")
        if isinstance(seq, int):
            stream = ((ev.get("pid"), ev.get("role")) if is_merged
                      else None)
            prev = prev_seq.get(stream)
            if prev is not None and seq <= prev:
                problems.append(
                    f"event {i} seq {seq} not after {prev}")
            prev_seq[stream] = seq
    n_dropped = obj.get("dropped")
    n_rec, n_ev = obj.get("recorded"), len(events)
    if (not is_merged and isinstance(n_dropped, int)
            and isinstance(n_rec, int)
            and n_dropped != max(0, n_rec - n_ev)):
        problems.append(
            f"dropped={n_dropped} inconsistent with recorded={n_rec}, "
            f"{n_ev} events")
    return problems


def is_flight_dump(obj: Any) -> bool:
    return isinstance(obj, dict) and SCHEMA_KEY in obj


def merge_flight_dumps(paths: Sequence[str],
                       out: Optional[str] = None) -> dict:
    """Fold per-process flight dumps into one time-ordered stream.

    Each event is re-tagged with its process's ``pid``/``role``; the
    merged stream orders by wall-clock ``ts`` (coarse cross-host
    alignment — postmortem ordering, not profiling).  Written
    atomically when ``out`` is given (GLT011).
    """
    if not paths:
        raise ValueError("no flight dumps to merge")
    sources: List[dict] = []
    merged: List[dict] = []
    for path in paths:
        with open(path) as fh:
            obj = json.load(fh)
        problems = validate_flight_dump(obj)
        if problems:
            raise ValueError(f"{path}: {problems[0]}")
        sources.append({
            "path": path, "pid": obj["pid"], "role": obj["role"],
            "reason": obj["reason"], "dropped": obj["dropped"],
        })
        for ev in obj["events"]:
            ev = dict(ev)
            ev["pid"] = obj["pid"]
            ev["role"] = obj["role"]
            merged.append(ev)
    merged.sort(key=lambda ev: (ev.get("ts", 0.0), ev.get("seq", 0)))
    result: Dict[str, Any] = {
        SCHEMA_KEY: SCHEMA_VERSION,
        "merged_from": [s["path"] for s in sources],
        "sources": sources,
        "events": merged,
    }
    # Fold the triggered-profiler capture index into the merged
    # timeline (obs/profiler.py): the postmortem reader sees which
    # trace directory belongs to which incident without scanning the
    # whole event stream.
    captures = [ev for ev in merged if ev.get("kind") == "profiler.capture"]
    if captures:
        result["captures"] = captures
    if out is not None:
        tmp = f"{out}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(result, fh)
        os.replace(tmp, out)
    return result
