"""Runtime recompile telemetry: count and time CUDA-graph captures and
kernel builds (cf. ``glt_tpu/obs/compilewatch.py``).

The port's counterpart of an XLA compilation is a **CUDA-graph capture**
(:class:`~glt_tpu_torch.utils.graphs.CapturedProgram`: a serving bucket,
a batched sample, a scanned training block) and an **nvcc build** of
the kernel library (:func:`glt_tpu_torch.ops.cuda_lib.build`).  Each
one reports itself here with its wall time (:func:`note_compile`) and
is attributed to a **labelled program**, so a steady state that should
capture nothing per epoch is a measurable claim.

* **Label seam.**  A thread-local label stack supplies the identity:
  wrap the *call site* that may capture (the first call at a block
  pattern, a bucket's warm-up) in :func:`label`/``wrap(fn, program)``
  and every capture under it lands in
  ``glt.compile.count{program=...}`` / ``glt.compile.ms{program=...}``.
  Unwrapped captures count under ``program=unlabelled``; builds count
  under ``program=nvcc``.
* **Recompile-storm detector.**  The same program key captured more
  than ``STORM_K`` times inside ``STORM_WINDOW_S`` seconds raises a
  ``compile.storm`` flight event and sets
  ``glt.compile.storm{program=...}``: the runtime signature of a block
  re-captured on every call (a state swap each step, a pattern that
  never settles).  ``glt.compile.recompiles`` (re-captures of an
  already-seen label) over ``glt.compile.first`` (first-time captures)
  is the SLO-able ratio (:func:`storm_ratio_spec`).

Module-level code is stdlib-only.  All window math uses
``time.monotonic()``.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Deque, Dict, Optional

from . import flight as _flight
from . import metrics as _metrics

#: Storm threshold: strictly more than K captures of one program label
#: inside the window is a storm (``glt_tpu``'s K, so the detector fires
#: at the same count in both packages).  A healthy block captures once
#: per pattern, and again after each state restore.
STORM_K = 8
STORM_WINDOW_S = 60.0

_M_FIRST = _metrics.counter(
    "glt.compile.first", "first-time captures and builds (all programs)")
_M_RECOMPILES = _metrics.counter(
    "glt.compile.recompiles",
    "re-compilations of an already-compiled program label")

_tls = threading.local()
_lock = threading.Lock()
#: cumulative compile count per program label (monotonic; read by
#: :func:`counts` for the bench/CI "second epoch compiles zero" check).
_counts: Dict[str, int] = {}
#: recent compile stamps per label (storm window) + whether a storm was
#: already reported for the current burst.
_stamps: Dict[str, Deque[float]] = {}
_storm_reported: Dict[str, bool] = {}


def current_label() -> str:
    """The innermost active program label (``unlabelled`` outside any)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else "unlabelled"


def install() -> bool:
    """Nothing to register: captures and builds report themselves
    (``glt_tpu`` registers a ``jax.monitoring`` listener here).  Kept so
    callers of either package read the same; always True."""
    return True


def note_compile(program: Optional[str], dur_ms: float) -> None:
    """Record one capture or build of ``program`` (the innermost
    :func:`label` when None) that took ``dur_ms``; never raises."""
    try:
        _note_compile(current_label() if program is None else program,
                      float(dur_ms))
    except Exception:  # noqa: BLE001 — telemetry must never raise
        pass


def _note_compile(program: str, dur_ms: float,
                  now: Optional[float] = None) -> None:
    now = time.monotonic() if now is None else now
    _metrics.counter("glt.compile.count",
                     "CUDA-graph captures and builds per labelled program",
                     labels={"program": program}).inc()
    _metrics.histogram("glt.compile.ms",
                       "capture and build wall time per labelled program",
                       labels={"program": program}).observe(dur_ms)
    with _lock:
        seen = _counts.get(program, 0)
        _counts[program] = seen + 1
        dq = _stamps.setdefault(
            program, collections.deque())
        dq.append(now)
        while dq and now - dq[0] > STORM_WINDOW_S:
            dq.popleft()
        storm = len(dq) > STORM_K
        if not storm:
            _storm_reported[program] = False
        report = storm and not _storm_reported.get(program, False)
        if report:
            _storm_reported[program] = True
        burst = len(dq)
    if seen:
        _M_RECOMPILES.inc()
    else:
        _M_FIRST.inc()
    if report:
        _metrics.gauge("glt.compile.storm",
                       "recompile storm in progress (burst size)",
                       labels={"program": program}).set(burst)
        _flight.record("compile.storm", program=program, count=burst,
                       window_s=STORM_WINDOW_S, threshold=STORM_K)


@contextlib.contextmanager
def label(program: str):
    """Attribute captures inside the block to ``program``.

    Wrap the *call site* that may capture (the first calls at a new
    shape or state).  Costs a thread-local append/pop.
    """
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(str(program))
    try:
        yield
    finally:
        stack.pop()


def wrap(fn: Callable, program: str) -> Callable:
    """``fn`` with every call running under ``label(program)``."""
    def wrapper(*args, **kwargs):
        with label(program):
            return fn(*args, **kwargs)
    wrapper.__name__ = getattr(fn, "__name__", "wrapped")
    return wrapper


def counts(program: Optional[str] = None):
    """Cumulative capture counts: ``{label: n}``, or one label's n."""
    with _lock:
        if program is not None:
            return _counts.get(program, 0)
        return dict(_counts)


def total_compiles() -> int:
    with _lock:
        return sum(_counts.values())


def storm_ratio_spec(objective: float = 0.2, **kw):
    """An :class:`~glt_tpu_torch.obs.slo.SloSpec` over the recompile
    fraction.

    Ratio semantics match slo.py: ``metric`` is the bad counter,
    ``denom`` the good one, windowed value = bad / (bad + good).  A
    steady-state process re-captures nothing, so any sustained fraction
    above ``objective`` burns.
    """
    from .slo import SloSpec
    return SloSpec(name=kw.pop("name", "compile_storm"),
                   metric="glt.compile.recompiles",
                   denom="glt.compile.first",
                   objective=objective, kind="ratio",
                   comparison="<=", **kw)


def reset_for_tests() -> None:
    """Clear label-seam state (counts/stamps)."""
    with _lock:
        _counts.clear()
        _stamps.clear()
        _storm_reported.clear()
