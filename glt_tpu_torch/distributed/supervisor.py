"""Fleet supervision: heartbeats, deadline-bounded waits, structured exit
(cf. ``glt_tpu/distributed/supervisor.py``).

The fault-tolerant sampling channel survives failures; this module makes
the *run* notice them.  Three pieces:

* :class:`Supervisor`: a peer-liveness table.  Peers report
  **passively** (``beat(name)`` called on their behalf: the server beats
  a client on every ``heartbeat`` request, a trainer beats its loader on
  every delivered batch) or **actively** (``watch(name, probe)`` runs a
  probe on an interval and beats on success: how a trainer watches a
  server it only receives from).  A monitor thread marks a peer silent
  past its deadline dead, fires ``on_dead`` once and records a
  structured reason; the training loop polls :meth:`Supervisor.
  raise_if_dead` at block boundaries (one lock and a scan).
* **Deadline-bounded collectives**: :func:`run_with_deadline` and
  :func:`timed_barrier` turn a dead or straggling process's forever-hang
  inside a gloo collective (:mod:`glt_tpu_torch.parallel.multihost`)
  into a :class:`BarrierTimeoutError` after a deadline.  The abandoned
  thread cannot be cancelled: the caller checkpoints and exits, as
  :class:`~glt_tpu_torch.ckpt.driver.TrainLoop` does.
* **Wire integration**: :class:`~glt_tpu_torch.distributed.dist_server.
  DistServer` serves ``heartbeat`` / ``fleet_health`` ops on its JSON
  control channel, and :class:`HeartbeatSender` drives them from any
  fleet role over its own :class:`~glt_tpu_torch.distributed.
  dist_client.RemoteServerConnection`.

Failure response is two-tier: **degrade** where a replica exists (the
client fails over across ``fallback_addrs``; the supervisor records the
dead primary), else **checkpoint and exit** with a flushed trace and a
:class:`SupervisedExit` carrying the machine-readable reason.  Every
wait here is deadline-bounded.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.trace import current as _current_tracer

_M_DEATHS = _metrics.counter(
    "glt.supervisor.peer_deaths", "peers declared dead by deadline expiry")
_M_BEATS = _metrics.counter(
    "glt.supervisor.beats", "heartbeats recorded (all peers)")
_M_BARRIER_TIMEOUTS = _metrics.counter(
    "glt.supervisor.barrier_timeouts",
    "deadline-bounded barriers/collectives that timed out")

DEFAULT_DEADLINE_SECS = 10.0


class PeerDeadError(RuntimeError):
    """A supervised peer missed its heartbeat deadline.

    ``report`` is the machine-readable reason the checkpoint manifest and
    :class:`SupervisedExit` carry."""

    def __init__(self, peer: str, age_s: float, deadline_s: float):
        super().__init__(
            f"peer {peer!r} silent for {age_s:.2f}s "
            f"(deadline {deadline_s:.2f}s)")
        self.report = {"reason": "peer_dead", "peer": peer,
                       "silent_s": round(age_s, 3),
                       "deadline_s": deadline_s}


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


class SupervisedExit(RuntimeError):
    """A supervised run ended early — ON PURPOSE, with its state saved.

    Carries the structured ``report`` (why), the global step, and the
    emergency checkpoint path (None when no checkpointer was attached).
    """

    def __init__(self, report: Dict[str, Any], step: int,
                 checkpoint_path: Optional[str]):
        super().__init__(
            f"supervised exit at step {step}: {report.get('reason')} "
            f"({report})")
        self.report = dict(report)
        self.step = int(step)
        self.checkpoint_path = checkpoint_path


@dataclasses.dataclass
class _Peer:
    name: str
    deadline_s: float
    last_seen: float                 # monotonic
    step: Optional[int] = None
    dead: bool = False
    died_after_s: Optional[float] = None
    beats: int = 0


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
        except BaseException as e:  # noqa: BLE001 — relayed to caller
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


def timed_barrier(name: str, timeout_s: float = DEFAULT_DEADLINE_SECS
                  ) -> None:
    """A barrier of every process that cannot hang past ``timeout_s``.

    One process (no ``torch.distributed`` group joined, or a group of
    one) returns at once; a fleet runs
    :func:`glt_tpu_torch.parallel.multihost.barrier` under
    :func:`run_with_deadline`.
    """
    from ..parallel import multihost

    multihost.barrier(name, timeout_s=timeout_s)


class Supervisor:
    """Heartbeat table + deadline monitor over a set of named peers.

    Thread-safe; the monitor thread starts lazily with the first
    registered/beaten peer and polls at ``poll_interval`` (default
    deadline/4, floored at 50 ms — detection latency is at most one poll
    past the deadline).
    """

    def __init__(self, deadline_secs: float = DEFAULT_DEADLINE_SECS,
                 poll_interval: Optional[float] = None,
                 on_dead: Optional[Callable[[str, Dict[str, Any]], None]]
                 = None):
        self.deadline_secs = float(deadline_secs)
        self.poll_interval = (max(0.05, self.deadline_secs / 4.0)
                              if poll_interval is None
                              else float(poll_interval))
        self.on_dead = on_dead
        self._peers: Dict[str, _Peer] = {}
        self._watchers: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._dead_reports: List[Dict[str, Any]] = []

    # -- peer reporting ----------------------------------------------------
    def register(self, name: str,
                 deadline_secs: Optional[float] = None) -> None:
        """Start supervising ``name`` (the clock starts now)."""
        with self._lock:
            self._peers[name] = _Peer(
                name=name,
                deadline_s=(self.deadline_secs if deadline_secs is None
                            else float(deadline_secs)),
                last_seen=time.monotonic())
        self._ensure_monitor()

    def beat(self, name: str, step: Optional[int] = None) -> None:
        """Record a sign of life from ``name`` (auto-registers)."""
        now = time.monotonic()
        with self._lock:
            peer = self._peers.get(name)
            if peer is None:
                peer = self._peers[name] = _Peer(
                    name=name, deadline_s=self.deadline_secs, last_seen=now)
            peer.last_seen = now
            if step is not None:
                peer.step = int(step)
            revived = peer.dead
            # A resurrected peer (restarted process, resumed run) clears
            # its death mark — supervision resumes cleanly.
            peer.dead = False
            peer.beats += 1
            beats = peer.beats
        _M_BEATS.inc()
        # Black-box breadcrumbs, sampled: the first beat, every 32nd
        # (a trainer beating its loader per batch must not flush the
        # ring), and any beat that revives a declared-dead peer.
        if revived or beats == 1 or beats % 32 == 0:
            _flight.record("supervisor.beat", peer=name, beats=beats,
                           step=step, revived=revived)
        self._ensure_monitor()

    def watch(self, name: str, probe: Callable[[], Any],
              interval: Optional[float] = None,
              deadline_secs: Optional[float] = None) -> None:
        """Actively probe a peer: ``probe()`` is called every ``interval``
        seconds on a daemon thread; each SUCCESSFUL call beats ``name``
        (exceptions are swallowed — a failing probe simply lets the
        deadline expire).  How a trainer watches a server it only
        receives from: pass a cheap request on a dedicated connection.
        """
        self.register(name, deadline_secs=deadline_secs)
        ivl = (max(0.05, self.poll_interval)
               if interval is None else float(interval))

        def loop():
            while not self._stop.wait(ivl):
                try:
                    probe()
                except Exception:  # noqa: BLE001 — silence IS the signal
                    continue
                self.beat(name)

        t = threading.Thread(target=loop, daemon=True,
                             name=f"supervisor-watch-{name}")
        t.start()
        self._watchers.append(t)

    # -- monitoring --------------------------------------------------------
    def _ensure_monitor(self) -> None:
        if self._monitor is not None and self._monitor.is_alive():
            return
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="supervisor-monitor")
            self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            now = time.monotonic()
            newly_dead: List[_Peer] = []
            with self._lock:
                for peer in self._peers.values():
                    if peer.dead:
                        continue
                    age = now - peer.last_seen
                    if age > peer.deadline_s:
                        peer.dead = True
                        peer.died_after_s = age
                        newly_dead.append(peer)
            for peer in newly_dead:
                _M_DEATHS.inc()
                report = PeerDeadError(peer.name, peer.died_after_s,
                                       peer.deadline_s).report
                with self._lock:
                    self._dead_reports.append(report)
                _flight.record("supervisor.peer_dead", **report)
                tracer = _current_tracer()
                if tracer is not None:
                    tracer.instant("supervisor.peer_dead", **report)
                if self.on_dead is not None:
                    try:
                        self.on_dead(peer.name, report)
                    except Exception:  # noqa: BLE001 — monitor must live
                        pass

    # -- queries -----------------------------------------------------------
    def status(self) -> Dict[str, Dict[str, Any]]:
        """Structured health table (the ``fleet_health`` op's payload).

        ``stale_after_s`` is the structured staleness verdict: seconds of
        remaining silence before this peer's deadline expires (negative
        once it is already past).  Callers — the fleet router above all —
        read the sign instead of re-implementing ``deadline - age``
        themselves, so the deadline math lives in exactly one place.
        """
        now = time.monotonic()
        with self._lock:
            return {
                p.name: {
                    "alive": not p.dead,
                    "age_s": round(now - p.last_seen, 3),
                    "deadline_s": p.deadline_s,
                    "stale_after_s": round(
                        p.deadline_s - (now - p.last_seen), 3),
                    "step": p.step,
                }
                for p in self._peers.values()
            }

    def dead_peers(self) -> List[str]:
        with self._lock:
            return [p.name for p in self._peers.values() if p.dead]

    def raise_if_dead(self) -> None:
        """Raise :class:`PeerDeadError` for the first dead peer (the
        step-boundary poll the training loop makes)."""
        with self._lock:
            for p in self._peers.values():
                if p.dead:
                    raise PeerDeadError(
                        p.name, p.died_after_s or 0.0, p.deadline_s)

    def stop(self) -> None:
        self._stop.set()


class HeartbeatSender:
    """Periodic ``heartbeat`` requests from a fleet role to the server.

    Rides the existing JSON control channel — reconnect/backoff/failover
    come free from :class:`~glt_tpu_torch.distributed.dist_client.
    RemoteServerConnection`.  ``step_fn`` (optional) supplies the current
    training step for the server's health table.  Failures are counted
    but swallowed: a peer that cannot reach the server simply goes
    silent, which is exactly the signal the server-side supervisor
    converts into a death after the deadline.
    """

    def __init__(self, conn, name: str, interval_secs: float = 1.0,
                 step_fn: Optional[Callable[[], int]] = None):
        self.conn = conn
        self.name = str(name)
        self.interval_secs = float(interval_secs)
        self.step_fn = step_fn
        self.failures = 0
        self.sent = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"heartbeat-{name}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_secs):
            req = {"op": "heartbeat", "peer": self.name}
            if self.step_fn is not None:
                try:
                    req["step"] = int(self.step_fn())
                except Exception:  # noqa: BLE001 — metadata only
                    pass
            try:
                self.conn.request(_stop=self._stop, _retries=0, **req)
                self.sent += 1
            except Exception:  # noqa: BLE001 — silence IS the signal
                self.failures += 1

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join:
            self._thread.join(timeout=2.0 + self.interval_secs)
