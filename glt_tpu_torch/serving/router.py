"""Fleet routing: partition-affinity sharding and exactly-once failover
(cf. ``glt_tpu/serving/router.py``).

The routing tier in front of N serving replicas.  Two pieces:

* :class:`ShardTable`, a pure routing table.  Seed ids hash into
  ``num_shards`` shards (a multiplicative hash, stable across runs);
  shards go to replicas by LPT greedy bin-packing over the partition
  frequency scores (:func:`glt_tpu_torch.partition.residency_scores`).
  Each replica owns a stable, load-balanced slice of the id space, so
  its seed-affinity LRU (``seed_cache_hit_rate`` in ``serving_stats``)
  sees the same hot ids request after request.

* :class:`FleetRouter`, the live tier.  Health is active probing
  through a :class:`~glt_tpu_torch.distributed.supervisor.Supervisor`
  (``fleet_health`` probes beat the table; its ``stale_after_s``
  verdict is read in :meth:`FleetRouter.fleet_status`).  A replica that
  dies, by a missed deadline or a transport error on the data path, has
  its shards re-homed to the survivors, and the in-flight request fails
  over exactly once to the new owner after one jittered backoff.
  Structured serving errors are never failed over: the replica spoke
  clearly, and a re-send could duplicate a response.  When the failover
  target also fails at transport level the caller gets a structured
  :class:`~glt_tpu_torch.serving.errors.NoHealthyReplica`.

A pre-fleet replica answers the ``fleet_hello`` handshake with its
unknown-op error; the router marks it *legacy* and routes to it
directly: it still serves ``subgraph_request`` and ``fleet_health``,
it never receives fleet control ops (``fleet_shed``).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed.dist_client import RemoteServerConnection
from ..distributed.supervisor import Supervisor
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..utils.device import DeviceLike, resolve_device
from .client import InferenceClient, retryable_transport
from .errors import NoHealthyReplica, ServingError

_M_REQUESTS = _metrics.counter(
    "glt.fleet.requests", "requests routed through the fleet tier")
_M_FAILOVERS = _metrics.counter(
    "glt.fleet.failovers",
    "in-flight requests failed over after a transport error")
_M_REHOMED = _metrics.counter(
    "glt.fleet.rehomed_shards",
    "shards re-homed off dead replicas")
_M_LEGACY = _metrics.counter(
    "glt.fleet.legacy_replicas",
    "replicas degraded to direct routing (pre-fleet protocol)")
_M_EXHAUSTED = _metrics.counter(
    "glt.fleet.no_healthy_replica",
    "requests that exhausted the bounded failover budget")
_G_HEALTHY = _metrics.gauge(
    "glt.fleet.healthy_replicas", "replicas currently routable")

# Knuth's multiplicative constant (2^32 / phi): consecutive ids (a hot
# block after frequency reordering) land in different shards, so one
# replica never inherits a whole hot block.
_HASH_MULT = np.uint64(2654435761)
_HASH_MASK = np.uint64(0xFFFFFFFF)


def shard_of(ids, num_shards: int) -> np.ndarray:
    """Vectorized stable shard assignment for int64 node ids."""
    a = np.asarray(ids, dtype=np.int64).ravel()
    h = (a.astype(np.uint64) * _HASH_MULT) & _HASH_MASK
    return (h % np.uint64(int(num_shards))).astype(np.int64)


class ShardTable:
    """Shard -> replica assignment balanced over residency scores.

    Pure data structure (no I/O, no threads: the router serializes
    access under its own lock).  ``scores`` is the per-node access
    score vector from the frequency partitioner
    (:func:`glt_tpu_torch.partition.residency_scores`); ``None`` means
    uniform load, which degrades LPT to round-robin-by-size.
    """

    def __init__(self, replicas: Sequence[str], num_shards: int = 64,
                 scores=None):
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("ShardTable needs at least one replica")
        if len(set(self.replicas)) != len(self.replicas):
            raise ValueError(f"duplicate replica keys: {self.replicas!r}")
        self.num_shards = int(num_shards)
        if self.num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.scores = (None if scores is None
                       else np.asarray(scores, np.float64).ravel())
        if self.scores is not None and self.scores.size:
            # Expected load per shard: the summed score mass of the ids
            # hashing into it, which LPT balances across replicas.
            self.shard_load = np.bincount(
                shard_of(np.arange(self.scores.size), self.num_shards),
                weights=self.scores, minlength=self.num_shards)
        else:
            self.shard_load = np.ones(self.num_shards, np.float64)
        self._dead: set = set()
        self._assign: Dict[int, str] = {}
        self._assign_lpt(range(self.num_shards), self.replicas)

    def _assign_lpt(self, shards, replicas: Sequence[str]) -> None:
        """Greedy LPT: hottest unassigned shard to least-loaded replica
        (deterministic: ties break toward earlier shards/replicas)."""
        loads = {r: 0.0 for r in replicas}
        for s, r in self._assign.items():
            if r in loads:
                loads[r] += float(self.shard_load[s])
        for s in sorted(shards,
                        key=lambda s: (-float(self.shard_load[s]), s)):
            target = min(replicas, key=lambda r: loads[r])
            self._assign[int(s)] = target
            loads[target] += float(self.shard_load[s])

    # -- routing ------------------------------------------------------------
    def owner(self, shard: int) -> str:
        return self._assign[int(shard)]

    def route(self, seeds) -> str:
        """Replica key owning this request: the shard of its hottest
        seed (by residency score; first seed when scores are uniform),
        so a multi-seed request lands where most of its reuse is."""
        a = np.asarray(seeds, dtype=np.int64).ravel()
        if a.size == 0:
            raise ValueError("cannot route an empty seed set")
        pick = int(a[0])
        if self.scores is not None and self.scores.size and a.size > 1:
            s = np.where((a >= 0) & (a < self.scores.size),
                         self.scores[np.clip(a, 0,
                                             self.scores.size - 1)], 0.0)
            pick = int(a[int(np.argmax(s))])
        return self.owner(int(shard_of([pick], self.num_shards)[0]))

    def rehome(self, replica: str) -> List[int]:
        """Mark ``replica`` dead and reassign its shards to survivors
        (LPT against their CURRENT loads, so re-homing stays balanced).
        Idempotent; returns the re-homed shard ids (empty when there is
        no survivor to take them: the caller's NoHealthyReplica case).
        """
        if replica in self._dead:
            return []
        self._dead.add(replica)
        survivors = [r for r in self.replicas if r not in self._dead]
        moved = sorted(s for s, r in self._assign.items() if r == replica)
        if not survivors:
            return []
        for s in moved:
            del self._assign[s]
        self._assign_lpt(moved, survivors)
        return moved

    def live_replicas(self) -> List[str]:
        return [r for r in self.replicas if r not in self._dead]

    def assignment(self) -> Dict[int, str]:
        return dict(self._assign)

    def shards_of(self, replica: str) -> List[int]:
        return sorted(s for s, r in self._assign.items() if r == replica)


class FleetRouter:
    """Route subgraph requests across N serving replicas.

    Args:
      replica_addrs: ``(host, port)`` per replica, order = identity.
      scores: per-node residency scores (the partition oracle) steering
        both shard load balancing and hottest-seed routing; None =
        uniform.
      num_shards: routing granularity (shards per fleet, not per
        replica); more shards = smoother re-homing at a little more
        table.
      policy: ``"affinity"`` (the shard table) or ``"random"``:
        uniform-random over live replicas, the baseline whose cache
        churn affinity is measured against.
      health_deadline_s / probe_interval_s: supervisor deadline and
        active-probe cadence for replica health.
      backoff_base / backoff_cap: the jittered-backoff parameters for
        the failover hand-off.
      start_probes: tests drive health transitions deterministically by
        passing False and calling :meth:`mark_dead` themselves.
      device: where each answer's tensors go (default ``"cuda"``; without
        a card pass ``"cpu"``).
    """

    def __init__(self, replica_addrs: Sequence[Tuple[str, int]],
                 scores=None, num_shards: int = 64,
                 policy: str = "affinity", name: str = "router",
                 request_timeout: float = 1.0,
                 op_timeout_margin: float = 30.0,
                 health_deadline_s: float = 2.0,
                 probe_interval_s: Optional[float] = None,
                 backoff_base: float = 0.05, backoff_cap: float = 0.5,
                 seed: int = 0, start_probes: bool = True,
                 device: DeviceLike = None):
        if policy not in ("affinity", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        device = resolve_device(device)
        self.name = name
        self.policy = policy
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._dead: set = set()
        self._legacy: set = set()
        #: controller seam: called as ``on_dead(replica_key, reason)``
        #: AFTER re-homing, from whichever thread detected the death.
        self.on_dead = None

        keys: List[str] = []
        self._clients: Dict[str, InferenceClient] = {}
        self._control: Dict[str, RemoteServerConnection] = {}
        for i, (host, port) in enumerate(replica_addrs):
            key = f"{host}:{port}"
            keys.append(key)
            # Data path: max_retries=0.  The router owns retry policy,
            # and a connection-level resend would break the
            # exactly-once-failover accounting.
            self._clients[key] = InferenceClient(
                (host, port), timeout=request_timeout,
                op_timeout_margin=op_timeout_margin,
                max_retries=0, seed=seed + i, device=device)
            # Control path: its own connection, so a probe can never
            # desync a data stream mid-subgraph-frame.
            self._control[key] = RemoteServerConnection(
                (host, port), max_retries=0,
                backoff_base=backoff_base, backoff_cap=backoff_cap,
                seed=seed + 1000 + i)
        self.table = ShardTable(keys, num_shards=num_shards,
                                scores=scores)
        _G_HEALTHY.set(len(keys))
        self.supervisor = Supervisor(deadline_secs=health_deadline_s,
                                     on_dead=self._supervisor_dead)
        for key in keys:
            self._hello(key)
        if start_probes:
            for key in keys:
                self.supervisor.watch(
                    key, probe=self._make_probe(key),
                    interval=probe_interval_s)

    # -- protocol negotiation ----------------------------------------------
    def _hello(self, key: str) -> None:
        """One ``fleet_hello`` handshake; a fatal unknown-op answer (or
        an unreachable replica) degrades the replica to legacy direct
        routing: it keeps serving subgraphs, it never gets fleet control
        ops."""
        try:
            resp = self._control[key].request(
                op="fleet_hello", peer=self.name, _retries=0,
                _timeout=5.0)
            protocol = int(resp.get("protocol", 0))
        except (RuntimeError, OSError):
            protocol = 0
        if protocol < 1:
            with self._lock:
                self._legacy.add(key)
            _M_LEGACY.inc()
            _flight.record("fleet.legacy_replica", replica=key)

    # -- health -------------------------------------------------------------
    def _make_probe(self, key: str):
        conn = self._control[key]

        def probe():
            # fleet_health predates the fleet tier, so the same probe
            # covers legacy replicas; an exception here is swallowed by
            # Supervisor.watch and the missed beat IS the signal.
            conn.request(op="fleet_health", _retries=0, _timeout=2.0)

        return probe

    def _supervisor_dead(self, replica: str, report: dict) -> None:
        self.mark_dead(replica, reason="heartbeat_deadline")

    def mark_dead(self, replica: str, reason: str = "manual") -> List[int]:
        """Declare a replica dead and re-home its shards (idempotent).
        Fired by the supervisor deadline, by a data-path transport
        error, or directly by tests/operators."""
        with self._lock:
            if replica in self._dead:
                return []
            self._dead.add(replica)
            moved = self.table.rehome(replica)
            healthy = len(self.table.live_replicas())
            successors = sorted({self.table.owner(s) for s in moved})
        _G_HEALTHY.set(healthy)
        _M_REHOMED.inc(len(moved))
        _flight.record("fleet.replica_dead", replica=replica,
                       reason=reason, healthy_replicas=healthy)
        _flight.record("fleet.rehome", replica=replica,
                       shards=len(moved), successors=successors)
        if self.on_dead is not None:
            try:
                self.on_dead(replica, reason)
            except Exception:  # noqa: BLE001 — routing must survive it
                pass
        return moved

    # -- routing ------------------------------------------------------------
    def _pick(self, seeds, exclude: Tuple[str, ...] = ()) -> str:
        with self._lock:
            live = [k for k in self.table.live_replicas()
                    if k not in exclude]
            if not live:
                _M_EXHAUSTED.inc()
                raise NoHealthyReplica(
                    f"no healthy replica left for this request "
                    f"(fleet of {len(self.table.replicas)}, "
                    f"dead={sorted(self._dead)})")
            if self.policy == "random":
                return self._rng.choice(live)
            key = self.table.route(seeds)
            # After a re-home the table maps only to live replicas, but
            # an excluded (just failed, not yet declared) owner falls
            # back to its successor by hash, deterministically.
            if key in exclude:
                key = live[int(shard_of([int(np.asarray(seeds).ravel()
                                             [0])],
                                        len(live))[0])]
            return key

    def _jitter(self, attempt: int) -> float:
        base = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        return base * (0.5 + 0.5 * self._rng.random())

    def subgraph(self, seeds, timeout: Optional[float] = None):
        """Route one ego-subgraph request; fail over at most once.

        Outcomes, exhaustively: a correct batch from the shard owner; a
        correct batch from its successor after ONE transport-error
        failover; a structured :class:`ServingError` relayed from
        whichever replica answered; or :class:`NoHealthyReplica` when
        the bounded failover budget is exhausted.  Structured errors
        are never failed over: the replica answered, and a re-send
        could produce a duplicate response.
        """
        _M_REQUESTS.inc()
        primary = self._pick(seeds)
        try:
            return self._clients[primary].subgraph(seeds,
                                                   timeout=timeout)
        except ServingError:
            raise
        except Exception as exc:  # noqa: BLE001 — classified below
            if not retryable_transport(exc):
                raise
            first = exc
        # Transport failure: the replica is gone as far as this request
        # is concerned.  Declare it (re-homes its shards for everyone),
        # one jittered backoff, then exactly one hand-off.
        self.mark_dead(primary, reason="transport_error")
        _M_FAILOVERS.inc()
        time.sleep(self._jitter(0))
        successor = self._pick(seeds, exclude=(primary,))
        _flight.record("fleet.failover", dead=primary,
                       successor=successor,
                       seeds=int(np.asarray(seeds).size))
        try:
            return self._clients[successor].subgraph(seeds,
                                                     timeout=timeout)
        except ServingError:
            raise
        except Exception as exc:  # noqa: BLE001 — classified below
            if not retryable_transport(exc):
                raise
            self.mark_dead(successor, reason="transport_error")
            _M_EXHAUSTED.inc()
            raise NoHealthyReplica(
                f"failover exhausted: shard owner {primary} and "
                f"successor {successor} both failed at transport level "
                f"({type(first).__name__}, then "
                f"{type(exc).__name__})") from exc

    # -- fleet control ------------------------------------------------------
    def broadcast_shed(self, alert: dict) -> Dict[str, Optional[dict]]:
        """Deliver one SLO alert dict (``slo_alert`` schema) to every
        live fleet-protocol replica; legacy/dead replicas are skipped
        or tolerated (None in the result)."""
        out: Dict[str, Optional[dict]] = {}
        with self._lock:
            targets = [k for k in self.table.live_replicas()
                       if k not in self._legacy]
        for key in targets:
            try:
                out[key] = self._control[key].request(
                    op="fleet_shed", alert=dict(alert), _retries=0,
                    _timeout=2.0)
            except Exception:  # noqa: BLE001 — best-effort broadcast
                out[key] = None
        return out

    # -- introspection ------------------------------------------------------
    def fleet_status(self) -> Dict[str, dict]:
        """Per-replica health table.  ``suspect`` consumes the
        supervisor's structured ``stale_after_s`` verdict (negative =
        past its heartbeat deadline) instead of re-deriving the
        deadline math here."""
        sup = self.supervisor.status()
        with self._lock:
            return {
                key: {
                    "alive": key not in self._dead,
                    "legacy": key in self._legacy,
                    "shards": len(self.table.shards_of(key)),
                    "suspect": float(
                        sup.get(key, {}).get("stale_after_s", 1.0)) <= 0,
                    "supervisor": sup.get(key),
                }
                for key in self.table.replicas
            }

    def replica_stats(self) -> Dict[str, Optional[dict]]:
        """Each live replica's ``serving_stats`` table (None where the
        pull failed): the controller's raw material."""
        with self._lock:
            targets = list(self.table.live_replicas())
        out: Dict[str, Optional[dict]] = {}
        for key in targets:
            try:
                out[key] = self._control[key].request(
                    op="serving_stats", _retries=0, _timeout=2.0)
            except Exception:  # noqa: BLE001 — a dead replica reads None
                out[key] = None
        return out

    def legacy_replicas(self) -> List[str]:
        with self._lock:
            return sorted(self._legacy)

    def close(self) -> None:
        self.supervisor.stop()
        for client in self._clients.values():
            client.close()
        for conn in self._control.values():
            conn.close()
