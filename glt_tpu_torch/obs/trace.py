"""Tracing core: nested host-side spans -> Chrome-trace / Perfetto JSON.

A :class:`Tracer` collects complete-events (``ph: "X"``) from ``with
span(...)`` blocks; the export loads directly into ``chrome://tracing``
or https://ui.perfetto.dev, and ``python -m glt_tpu_torch.obs summarize``
renders a per-span aggregate table.  The export is ``glt_tpu``'s format:
a trace written by either package validates and merges in the other.

Two rules make spans safe around CUDA work:

  * **Host-side only.**  Never open a span (or touch a metric) inside a
    function that a CUDA graph captures: the call runs once at capture
    time and no replay repeats it, and a fence (a host sync) inside
    ``torch.cuda.graph`` breaks the capture.  Spans wrap the replay
    call on the host; a replay emits no span.
  * **Explicit device fencing.**  CUDA launches are async, so a span
    around them measures *dispatch*, not execution.  Register the
    call's output tensors with ``span.fence(out)`` and the span's close
    waits for them: it records a ``torch.cuda.Event`` on the current
    stream of each CUDA device they live on and waits on it.  The span
    then records both the dispatch slice and the device wait in
    ``args``.

When no tracer is installed, ``span()`` returns a shared no-op object —
one module-global read per call, cheap enough to leave in hot loops.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Any, Dict, List, Optional

def _cuda_devices(tokens: Any, out: set) -> None:
    """Collect the CUDA devices of the tensors in ``tokens`` (a tensor
    or nested tuples, lists and dicts of them)."""
    if isinstance(tokens, dict):
        tokens = list(tokens.values())
    if isinstance(tokens, (list, tuple)):
        for t in tokens:
            _cuda_devices(t, out)
    elif getattr(tokens, "is_cuda", False):
        out.add(tokens.device)


def _device_fence(token_groups: List[Any]) -> None:
    """Wait until the work queued on the streams of the registered CUDA
    tensors has run: an event recorded on each device's current stream,
    then waited on.  CPU tensors are computed already."""
    devices: set = set()
    for tokens in token_groups:
        _cuda_devices(tokens, devices)
    if not devices:
        return
    import torch

    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def _gen_trace_id() -> str:
    """A fresh 64-bit trace id (hex) — unique across processes."""
    return os.urandom(8).hex()


class Span:
    """One timed region; use as a context manager (see :func:`span`)."""

    __slots__ = ("_tracer", "name", "_attrs", "_t0_ns", "_tokens", "_depth",
                 "span_id", "trace_id", "_parent_id")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self._attrs = attrs
        self._tokens: Optional[List[Any]] = None
        self.span_id: Optional[int] = None
        self.trace_id: Optional[str] = None
        self._parent_id: Optional[int] = None

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        self.span_id = self._tracer._next_span_id()
        if stack:
            parent = stack[-1]
            self._parent_id = parent.span_id
            if self.trace_id is None:
                self.trace_id = parent.trace_id
        stack.append(self)
        self._t0_ns = time.perf_counter_ns()
        return self

    def link(self, trace_id: Optional[str],
             parent_span_id: Optional[int]) -> "Span":
        """Adopt a REMOTE parent (cross-process trace propagation).

        The span joins trace ``trace_id`` as a child of the peer's
        ``parent_span_id`` — ``python -m glt_tpu_torch.obs merge`` uses these
        links to stitch per-process trace files into one causally
        connected tree.  Returns ``self`` for chaining.
        """
        if trace_id:
            self.trace_id = str(trace_id)
        if parent_span_id is not None:
            self._parent_id = int(parent_span_id)
        return self

    def context(self) -> Dict[str, Any]:
        """Wire context for propagating this span to another process:
        ``{"tid": trace id, "sid": this span's id, "ts": send time in
        this process's trace clock (us)}``.  Call inside the ``with``
        block; generates a fresh trace id for a root span."""
        if self.trace_id is None:
            self.trace_id = _gen_trace_id()
        return {"tid": self.trace_id, "sid": self.span_id,
                "ts": self._tracer.now_us()}

    def fence(self, tokens):
        """Register tensors to wait for before the span closes.

        Returns ``tokens`` unchanged so it drops into assignments:
        ``loss = sp.fence(loss)``.
        """
        if self._tokens is None:
            self._tokens = []
        self._tokens.append(tokens)
        return tokens

    def set(self, **attrs) -> None:
        """Attach key/value attributes to the span's trace args."""
        self._attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb) -> bool:
        dispatch_ns = time.perf_counter_ns() - self._t0_ns
        if self._tokens is not None and exc_type is None:
            _device_fence(self._tokens)
        end_ns = time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:          # exited out of order; stay consistent
            stack.remove(self)
        args = dict(self._attrs)
        args["depth"] = self._depth
        args["span_id"] = self.span_id
        if self._parent_id is not None:
            args["parent_span_id"] = self._parent_id
        if self.trace_id is not None:
            args["trace_id"] = self.trace_id
        if self._tokens is not None:
            args["dispatch_us"] = round(dispatch_ns / 1e3, 3)
            args["device_wait_us"] = round(
                (end_ns - self._t0_ns - dispatch_ns) / 1e3, 3)
        self._tracer._emit({
            "name": self.name,
            "ph": "X",
            "cat": "glt",
            "ts": round((self._t0_ns - self._tracer._t0_ns) / 1e3, 3),
            "dur": round((end_ns - self._t0_ns) / 1e3, 3),
            "pid": self._tracer.pid,
            "tid": threading.get_ident(),
            "args": args,
        })
        return False


class _NullSpan:
    """Shared no-op span served while no tracer is installed."""

    __slots__ = ()

    span_id = None
    trace_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, tokens):
        return tokens

    def set(self, **attrs):
        pass

    def link(self, trace_id, parent_span_id):
        return self

    def context(self):
        return None


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects span events; thread-safe (one span stack per thread).

    ``process_name`` labels this process's track in merged traces (the
    Chrome-trace ``process_name`` metadata event); ``now_us`` is the
    tracer's clock — microseconds since the tracer started, the same
    scale every event's ``ts`` uses, and the clock the cross-process
    sync samples (``obs.clock_sync``) are taken in.
    """

    def __init__(self, process_name: Optional[str] = None):
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._t0_ns = time.perf_counter_ns()
        self.pid = os.getpid()
        self.process_name = process_name
        # Span ids must not collide across the fleet's processes (merge
        # stitches remote parent links by id): random high bits + a
        # process-local counter.
        self._span_id_base = (
            struct.unpack("<Q", os.urandom(8))[0] & ~0xFFFFF)
        self._span_seq = 0

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _next_span_id(self) -> int:
        with self._lock:
            self._span_seq += 1
            return self._span_id_base + self._span_seq

    def now_us(self) -> float:
        """Current time in this tracer's clock (us since tracer start)."""
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def instant(self, name: str, **args) -> None:
        """Emit a zero-duration instant event (``ph: "i"``) — used for
        point occurrences like clock-sync samples, replays, reconnects."""
        self._emit({
            "name": name,
            "ph": "i",
            "s": "t",
            "cat": "glt",
            "ts": round(self.now_us(), 3),
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": args,
        })

    def _emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def metadata_events(self) -> List[dict]:
        """Chrome ``ph: "M"`` metadata naming this process's track.

        Without these, Perfetto renders a merged multi-process trace as
        anonymous numeric pids; with them each process is one named
        track (``client``, ``server``, ``worker0`` ...)."""
        if not self.process_name:
            return []
        return [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": self.process_name},
        }]

    def chrome_trace(self) -> dict:
        """The trace as a Chrome-trace-format object (JSON-serializable)."""
        events = sorted(self.events, key=lambda e: e.get("ts", 0.0))
        out = {"traceEvents": self.metadata_events() + events,
               "displayTimeUnit": "ms"}
        # Sidecar identity for `obs merge`: which process wrote this
        # file, and that all ts are tracer-relative (arbitrary origin
        # per process — exactly what the clock alignment estimates).
        out["glt"] = {"pid": self.pid,
                      "process_name": self.process_name,
                      "clock": "tracer_relative_us"}
        return out

    def export(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path``; returns ``path``.

        Atomic (tmp + ``os.replace``, the checkpoint-store publish
        discipline): a process killed mid-export — exactly the moment
        the crash-time flush runs — leaves the previous complete export
        or none, never a torn JSON that ``obs merge`` chokes on.
        """
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path


# -- global tracer ---------------------------------------------------------

_current: Optional[Tracer] = None


def install(tracer: Optional[Tracer]) -> None:
    """Install ``tracer`` as the process-global span sink (None = off)."""
    global _current
    _current = tracer


def current() -> Optional[Tracer]:
    return _current


def start_trace(process_name: Optional[str] = None) -> Tracer:
    """Install (and return) a fresh global tracer.

    ``process_name`` labels this process's track in merged traces
    (e.g. ``"client"``, ``"server"``, ``"worker0"``).
    """
    tracer = Tracer(process_name=process_name)
    install(tracer)
    return tracer


#: Env var: when set to a directory, fleet roles (servers, remote
#: loaders, sampling workers) auto-start a process-global tracer and
#: export to ``$GLT_OBS_TRACE_DIR/trace-<role>-<pid>.json`` at shutdown.
TRACE_DIR_ENV = "GLT_OBS_TRACE_DIR"


def auto_trace(role: str) -> Optional[str]:
    """Opt-in per-process tracing for fleet roles.

    If :data:`TRACE_DIR_ENV` names a directory, ensure a global tracer
    is running (naming it ``role`` if it has no name yet) and return the
    path this process should export to at teardown; otherwise return
    ``None`` and touch nothing.  Callers hold the path and call
    :func:`auto_trace_export` when the role shuts down.

    Registration also arms the crash-time flush: the first registered
    path installs ``atexit`` + SIGTERM handlers so a killed/preempted
    process still exports its partial trace (see :func:`flush_exports`).
    """
    trace_dir = os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        return None
    tracer = _current
    if tracer is None:
        tracer = start_trace(process_name=role)
    elif tracer.process_name is None:
        tracer.process_name = role
    path = os.path.join(trace_dir, f"trace-{role}-{os.getpid()}.json")
    with _flush_lock:
        _flush_paths.add(path)
    _install_crash_handlers()
    return path


def auto_trace_export(path: Optional[str]) -> Optional[str]:
    """Export the global tracer to ``path`` (from :func:`auto_trace`);
    no-op when ``path`` is None or tracing stopped in the meantime."""
    tracer = _current
    if path is None or tracer is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return tracer.export(path)


def stop_trace(path: Optional[str] = None) -> Optional[Tracer]:
    """Uninstall the global tracer; export to ``path`` if given."""
    tracer = _current
    install(None)
    if tracer is not None and path is not None:
        tracer.export(path)
    return tracer


# -- crash-time flush -------------------------------------------------------
#
# A preempted/killed fleet process used to lose its spans: the export
# only ran on the role's orderly shutdown path.  Registering a path via
# auto_trace() now arms a one-time atexit + SIGTERM flush, so normal
# interpreter exit AND the polite half of preemption (SIGTERM before the
# SIGKILL grace deadline) both export the partial trace.  SIGKILL itself
# is unflushable by definition — nothing user-space runs — which is why
# the supervisor's PEER-side spans (`supervisor.peer_dead` instants, the
# surviving roles' traces) are the record of a hard-killed process.

_flush_lock = threading.Lock()
_flush_paths: set = set()
_handlers_installed = False


def flush_exports(reason: Optional[str] = None) -> List[str]:
    """Export the global tracer to every auto-trace-registered path NOW.

    Idempotent and crash-ordered: exports are atomic (tmp + replace), so
    repeated flushes (supervisor exit path, then atexit) each publish a
    complete snapshot.  ``reason`` is stamped as a ``trace.flush``
    instant so a flushed-early trace is self-describing.  Returns the
    written paths ([] when tracing is off or nothing registered).
    """
    tracer = _current
    with _flush_lock:
        paths = sorted(_flush_paths)
    if tracer is None or not paths:
        return []
    if reason is not None:
        tracer.instant("trace.flush", reason=str(reason))
    written = []
    for path in paths:
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            written.append(tracer.export(path))
        except OSError:
            continue    # a dead disk must not mask the original exit
    return written


def _install_crash_handlers() -> None:
    """Arm atexit + SIGTERM flush, once per process.

    The SIGTERM handler flushes, restores the previous disposition, and
    re-raises the signal against this process — so exit status, parent
    supervisors, and any chained handler all observe the genuine signal
    death, with the trace already on disk.  Installed lazily from
    :func:`auto_trace` (import must stay side-effect free); non-main
    threads skip the signal half (Python restricts ``signal.signal`` to
    the main thread — the atexit half still covers orderly exits).
    """
    global _handlers_installed
    with _flush_lock:
        if _handlers_installed:
            return
        _handlers_installed = True
    import atexit
    import signal as _signal

    atexit.register(flush_exports)

    def _on_sigterm(signum, frame):
        flush_exports(reason="sigterm")
        _signal.signal(signum, prev if callable(prev) else
                       _signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    try:
        prev = _signal.signal(_signal.SIGTERM, _on_sigterm)
    except ValueError:      # not the main thread: atexit-only coverage
        pass


def span(name: str, **attrs):
    """A span on the global tracer — the shared no-op when tracing is off.

    >>> with span("loader.sample_dispatch") as sp:
    ...     out = sampler.sample_from_nodes(inp)
    ...     sp.fence(out.num_sampled_edges)   # close waits for the device
    """
    tracer = _current
    if tracer is None:
        return _NULL_SPAN
    return Span(tracer, name, attrs)


# -- validation ------------------------------------------------------------

def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural validity problems of a Chrome-trace object ([] = valid).

    Checks the complete-event contract the exporter emits: required keys,
    non-negative durations/device timings, and — per (pid, tid) — that
    spans strictly nest (no partial overlap), which is what makes the
    Perfetto flame view truthful.
    """
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    by_tid: Dict[tuple, List[dict]] = {}
    # Required keys per phase: complete events carry timing; instants
    # carry a timestamp; metadata events only name a track.
    required = {"X": ("name", "ph", "ts", "dur", "pid", "tid"),
                "i": ("name", "ph", "ts", "pid", "tid"),
                "M": ("name", "ph", "pid")}
    for i, ev in enumerate(events):
        keys = required.get(ev.get("ph"), ("name", "ph", "ts", "dur",
                                           "pid", "tid"))
        missing = [k for k in keys if k not in ev]
        if missing:
            problems.append(f"event {i} missing keys {missing}")
            continue
        if ev["ph"] != "X":
            continue
        if ev["dur"] < 0:
            problems.append(f"event {i} ({ev['name']}) has negative dur")
        wait = ev.get("args", {}).get("device_wait_us")
        if wait is not None and wait < 0:
            problems.append(
                f"event {i} ({ev['name']}) has negative device_wait_us")
        by_tid.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    eps = 0.5  # us; tolerates equal-microsecond rounding at span edges
    for (pid, tid), evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[tuple] = []   # (end_ts, name)
        for ev in evs:
            end = ev["ts"] + ev["dur"]
            while stack and stack[-1][0] <= ev["ts"] + eps:
                stack.pop()
            if stack and end > stack[-1][0] + eps:
                problems.append(
                    f"tid {tid}: span {ev['name']!r} overlaps "
                    f"{stack[-1][1]!r} without nesting")
                continue
            stack.append((end, ev["name"]))
    return problems
