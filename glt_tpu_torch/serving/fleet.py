"""FleetController: one SLO evaluation driving a whole serving fleet
(cf. ``glt_tpu/serving/fleet.py``).

A fleet must not shed replica by replica (the burn migrates to whichever
replica still admits): the controller evaluates ONE
:class:`~glt_tpu_torch.obs.slo.SloSpec` set against fleet-aggregated
instruments and broadcasts the firing and resolved transitions to every
replica over the ``fleet_shed`` wire op, so the fleet opens and closes
admission together.

Each :meth:`FleetController.tick` (public and deterministic; tests drive
it with an injected ``now``):

1. pulls every replica's ``serving_stats`` and ``fleet_health``; a
   successful pull beats that replica in the controller's supervisor;
2. mirrors the fleet aggregates into local ``glt.fleet.*`` instruments
   (counters for admitted and rejected, gauges for latency and the
   survivors' cache hit rate);
3. runs ``SloMonitor.tick(now)``: its transitions are broadcast by
   ``fleet_shed`` (legacy replicas tolerate the op failing).

On a replica's death (its supervisor deadline, or the router reporting a
transport-level kill) the controller writes the merged postmortem: every
surviving replica's ``flight_dump`` plus its own ring, merged by
:func:`glt_tpu_torch.obs.flight.merge_flight_dumps` into one file
(``python -m glt_tpu_torch.obs merge`` makes the same file by hand).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..distributed.dist_client import RemoteServerConnection
from ..distributed.supervisor import Supervisor
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs.slo import DEFAULT_WINDOWS, SloMonitor, SloSpec

_M_TICKS = _metrics.counter(
    "glt.fleet.controller_ticks", "fleet controller evaluation passes")
_M_SHED_BCASTS = _metrics.counter(
    "glt.fleet.shed_broadcasts",
    "fleet_shed alert broadcasts (firing + resolved transitions)")
_M_POSTMORTEMS = _metrics.counter(
    "glt.fleet.postmortems", "merged postmortems written")
# The fleet-aggregate instruments the SLO specs evaluate (mirrored from
# the replicas' serving_stats deltas every tick):
_M_FLEET_ADMITTED = _metrics.counter(
    "glt.fleet.requests_total",
    "requests admitted across all replicas (mirrored)")
_M_FLEET_REJECTED = _metrics.counter(
    "glt.fleet.rejected_total",
    "requests rejected across all replicas (mirrored)")
_G_FLEET_EWMA = _metrics.gauge(
    "glt.fleet.ewma_batch_ms",
    "worst replica's EWMA micro-batch service time (mirrored)")
_G_FLEET_HIT_RATE = _metrics.gauge(
    "glt.fleet.seed_cache_hit_rate",
    "mean live-replica seed-affinity cache hit rate (mirrored)")


def default_fleet_specs(reject_budget: float = 0.10,
                        batch_ms: float = 250.0,
                        windows: Tuple[Tuple[float, float], ...]
                        = DEFAULT_WINDOWS) -> List[SloSpec]:
    """The fleet-wide objectives: a bounded structured-rejection
    budget and a bounded service time, over the mirrored aggregates."""
    return [
        SloSpec(name="fleet_rejects",
                metric="glt.fleet.rejected_total", kind="ratio",
                denom="glt.fleet.requests_total",
                objective=reject_budget, comparison="<=",
                windows=windows),
        SloSpec(name="fleet_latency",
                metric="glt.fleet.ewma_batch_ms", kind="gauge",
                objective=batch_ms, comparison="<=",
                windows=windows),
    ]


@dataclasses.dataclass
class FleetSpec:
    """Controller policy: objectives, cadence, postmortem sink.

    Attributes:
      slos: the fleet-wide :class:`SloSpec` set (None = defaults).
      poll_interval_s: tick cadence when :meth:`FleetController.start`
        runs the loop on a thread.
      replica_deadline_s: how long a replica may fail its stats pull
        before the controller declares it dead.
      postmortem_dir: where merged postmortems land; None defers to
        ``GLT_FLIGHT_DIR`` and finally the working directory.
      stats_timeout_s: per-pull wire timeout (bounded, always).
    """

    slos: Optional[Sequence[SloSpec]] = None
    poll_interval_s: float = 1.0
    replica_deadline_s: float = 3.0
    postmortem_dir: Optional[str] = None
    stats_timeout_s: float = 2.0


class FleetController:
    """Watch N replicas, evaluate one SLO set, shed/reopen fleet-wide.

    Args:
      replica_addrs: the fleet's ``(host, port)`` list.
      spec: a :class:`FleetSpec` policy bundle.
      router: optional :class:`~glt_tpu_torch.serving.router.FleetRouter`:
        when given, the controller registers for its death reports (a
        transport-detected kill triggers the same postmortem as a
        heartbeat expiry) and broadcasts shed through it; otherwise it
        uses its own control connections.
    """

    def __init__(self, replica_addrs: Sequence[Tuple[str, int]],
                 spec: Optional[FleetSpec] = None, router=None,
                 name: str = "fleet-controller"):
        # The controller is the fleet's observability opt-in: burn
        # evaluation reads the local instrument registry, so mirroring
        # needs the process-wide metrics switch on.
        _metrics.enable()
        self.spec = spec or FleetSpec()
        self.name = name
        self.router = router
        self._lock = threading.Lock()
        self._dead: set = set()
        self._last: Dict[str, dict] = {}
        self._postmortems: List[str] = []
        self._conns: Dict[str, RemoteServerConnection] = {}
        for i, (host, port) in enumerate(replica_addrs):
            self._conns[f"{host}:{port}"] = RemoteServerConnection(
                (host, port), max_retries=0, seed=2000 + i)
        self.supervisor = Supervisor(
            deadline_secs=self.spec.replica_deadline_s,
            on_dead=self._on_replica_dead)
        for key in self._conns:
            self.supervisor.register(key)
        self.monitor = SloMonitor(
            list(self.spec.slos) if self.spec.slos is not None
            else default_fleet_specs(),
            interval_s=self.spec.poll_interval_s,
            on_alert=self._on_alert)
        if router is not None:
            router.on_dead = self._router_dead
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- per-tick work ------------------------------------------------------
    def _poll_replica(self, key: str) -> Optional[dict]:
        """One replica's ``serving_stats`` + ``fleet_health`` pull;
        None on any failure (the missed beat is the signal)."""
        conn = self._conns[key]
        t = self.spec.stats_timeout_s
        stats = conn.request(op="serving_stats", _retries=0, _timeout=t)
        health = conn.request(op="fleet_health", _retries=0, _timeout=t)
        return {"stats": stats, "health": health}

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """One full evaluation pass; returns the SLO alerts emitted.
        Deterministic given the replicas' responses and ``now``."""
        _M_TICKS.inc()
        admitted_delta = 0
        rejected_delta = 0
        ewma_worst = 0.0
        hit_rates: List[float] = []
        stale_peers: List[str] = []
        for key in list(self._conns):
            with self._lock:
                if key in self._dead:
                    continue
            try:
                pulled = self._poll_replica(key)
            except Exception:  # noqa: BLE001 — silence is the signal
                continue
            if pulled is None:
                continue
            self.supervisor.beat(key)
            stats = pulled.get("stats") or {}
            if stats.get("enabled"):
                prev = self._last.get(key) or {}
                admitted_delta += max(
                    0, int(stats.get("completed", 0))
                    - int(prev.get("completed", 0)))
                rejected = (int(stats.get("rejected_overload", 0))
                            + int(stats.get("rejected_deadline", 0))
                            + int(stats.get("rejected_shed", 0)))
                prev_rejected = (int(prev.get("rejected_overload", 0))
                                 + int(prev.get("rejected_deadline", 0))
                                 + int(prev.get("rejected_shed", 0)))
                rejected_delta += max(0, rejected - prev_rejected)
                ewma_worst = max(ewma_worst,
                                 float(stats.get("ewma_batch_ms", 0.0)))
                hit_rates.append(
                    float(stats.get("seed_cache_hit_rate", 0.0)))
                self._last[key] = stats
            # Consume the staleness verdict each replica publishes
            # about its own peers (stale_after_s).
            for peer, st in (pulled.get("health") or {}).get(
                    "peers", {}).items():
                if float(st.get("stale_after_s", 1.0)) <= 0:
                    stale_peers.append(f"{key}/{peer}")
        _M_FLEET_ADMITTED.inc(admitted_delta)
        _M_FLEET_REJECTED.inc(rejected_delta)
        _G_FLEET_EWMA.set(round(ewma_worst, 3))
        if hit_rates:
            _G_FLEET_HIT_RATE.set(
                round(sum(hit_rates) / len(hit_rates), 6))
        if stale_peers:
            _flight.record("fleet.stale_peers", peers=stale_peers[:16])
        return self.monitor.tick(now)

    # -- alerting -----------------------------------------------------------
    def _on_alert(self, alert: dict) -> None:
        """A fleet SLO transitioned: broadcast shed/reopen everywhere."""
        _M_SHED_BCASTS.inc()
        _flight.record("fleet.shed_broadcast", slo=alert.get("slo"),
                       state=alert.get("state"),
                       shed_frac=alert.get("shed_frac"))
        if self.router is not None:
            self.router.broadcast_shed(alert)
            return
        for key, conn in self._conns.items():
            with self._lock:
                if key in self._dead:
                    continue
            try:
                conn.request(op="fleet_shed", alert=dict(alert),
                             _retries=0,
                             _timeout=self.spec.stats_timeout_s)
            except Exception:  # noqa: BLE001 — legacy/dead tolerated
                continue

    # -- death + postmortem -------------------------------------------------
    def _router_dead(self, key: str, reason: str) -> None:
        """Router seam: a transport-detected death reaches the same
        postmortem path as a heartbeat expiry."""
        self._replica_died(key, {"reason": reason, "source": "router"})

    def _on_replica_dead(self, key: str, report: dict) -> None:
        self._replica_died(key, dict(report, source="supervisor"))

    def _replica_died(self, key: str, report: dict) -> None:
        with self._lock:
            if key in self._dead:
                return
            self._dead.add(key)
        _flight.record("fleet.replica_dead", replica=key, **{
            k: v for k, v in report.items()
            if k in ("reason", "source", "silent_s", "deadline_s")})
        if self.router is not None:
            # Idempotent: no-op when the router already re-homed.
            self.router.mark_dead(key, reason="controller")
        try:
            self.postmortem(reason=f"replica_dead:{key}")
        except Exception:  # noqa: BLE001 — the controller must live
            _flight.record("fleet.postmortem_failed", replica=key)

    def _postmortem_dir(self) -> str:
        return (self.spec.postmortem_dir
                or os.environ.get("GLT_FLIGHT_DIR") or ".")

    def postmortem(self, reason: str) -> Optional[str]:
        """Pull every reachable replica's flight ring, add this
        process's own, and write one merged dump.  Returns the merged
        path (None only if nothing could be collected)."""
        outdir = self._postmortem_dir()
        os.makedirs(outdir, exist_ok=True)
        _flight.record("fleet.postmortem_start", reason=reason)
        paths: List[str] = []
        for key, conn in self._conns.items():
            with self._lock:
                if key in self._dead:
                    continue
            try:
                resp = conn.request(op="flight_dump", _retries=0,
                                    _timeout=self.spec.stats_timeout_s)
                dump = resp.get("flight")
            except Exception:  # noqa: BLE001 — dead replicas skip
                continue
            if not dump:
                continue
            # Attribute the stream: the merged postmortem keys events
            # by (pid, role), and a one-host fleet may share a pid; the
            # replica key in the role keeps N replicas' rings apart.
            dump = dict(dump)
            dump["role"] = f"{dump.get('role') or 'replica'}@{key}"
            p = os.path.join(
                outdir,
                f"glt_fleet_pm-{key.replace(':', '_')}.json")
            tmp = p + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dump, f)
            os.replace(tmp, p)
            paths.append(p)
        own = _flight.dump_now(
            f"fleet_postmortem:{reason}",
            path=os.path.join(outdir, "glt_fleet_pm-controller.json"))
        if own:
            paths.append(own)
        if not paths:
            return None
        merged = os.path.join(outdir, "glt_fleet_postmortem.json")
        _flight.merge_flight_dumps(paths, out=merged)
        _M_POSTMORTEMS.inc()
        _flight.record("fleet.postmortem", reason=reason, out=merged,
                       sources=len(paths))
        with self._lock:
            self._postmortems.append(merged)
        return merged

    # -- introspection / lifecycle ------------------------------------------
    def status(self) -> dict:
        """Controller view: the supervisor table, the SLO states and
        the postmortems written so far."""
        with self._lock:
            dead = sorted(self._dead)
            postmortems = list(self._postmortems)
        return {"replicas": self.supervisor.status(),
                "dead": dead,
                "slo": self.monitor.states(),
                "firing": self.monitor.firing(),
                "postmortems": postmortems}

    def start(self) -> "FleetController":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="glt-fleet-controller")
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.spec.poll_interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must live
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0 + self.spec.poll_interval_s)
        self.supervisor.stop()
        self.monitor.stop()
        for conn in self._conns.values():
            conn.close()
