"""Deadline-bounded waits for the multi-process plane (cf.
``glt_tpu/distributed/supervisor.py``, its :class:`BarrierTimeoutError`
and :func:`run_with_deadline`).

The characteristic multi-process failure is the forever-hang: one
preempted process leaves every surviving peer blocked inside a
collective with no exception and no timeout.  :func:`run_with_deadline`
turns that into a structured :class:`BarrierTimeoutError` after a
deadline; the caller checkpoints and exits.  The heartbeat supervisor
and its wire integration are not ported yet (ROADMAP queue A item 8).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List

from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.trace import current as _current_tracer

__all__ = ["BarrierTimeoutError", "run_with_deadline"]

_M_BARRIER_TIMEOUTS = _metrics.counter(
    "glt.supervisor.barrier_timeouts",
    "deadline-bounded barriers/collectives that timed out")


class BarrierTimeoutError(RuntimeError):
    """A multi-process barrier or collective exceeded its deadline: a
    dead or straggling peer.  The wrapped call's thread is abandoned (it
    cannot be cancelled); checkpoint and exit."""

    def __init__(self, what: str, timeout_s: float):
        super().__init__(
            f"{what} did not complete within {timeout_s:.2f}s "
            f"(dead or straggling peer); checkpoint and exit")
        self.report = {"reason": "barrier_timeout", "what": what,
                       "deadline_s": timeout_s}


def run_with_deadline(fn: Callable[[], Any], timeout_s: float,
                      what: str = "collective") -> Any:
    """Run ``fn`` with a hard deadline; raises :class:`BarrierTimeoutError`.

    The call runs in a daemon thread; on timeout the thread is abandoned
    (a hung gloo collective cannot be interrupted from Python) and the
    error is raised here, within the deadline.  ``fn``'s own exception
    is re-raised if it finishes by failing; else its result returns.
    """
    box: List[Any] = []
    err: List[BaseException] = []

    def runner():
        try:
            box.append(fn())
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            err.append(e)

    t = threading.Thread(target=runner, daemon=True,
                         name=f"deadline-{what}")
    t.start()
    t.join(timeout=float(timeout_s))
    if t.is_alive():
        _M_BARRIER_TIMEOUTS.inc()
        _flight.record("supervisor.barrier_timeout", what=what,
                       deadline_s=float(timeout_s))
        tracer = _current_tracer()
        if tracer is not None:
            tracer.instant("supervisor.barrier_timeout", what=what,
                           deadline_s=float(timeout_s))
        raise BarrierTimeoutError(what, float(timeout_s))
    if err:
        raise err[0]
    return box[0] if box else None
