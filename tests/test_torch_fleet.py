"""The port's fleet tier against ``glt_tpu``'s (cf. ``tests/test_fleet.py``,
whose 18 tests each have a twin here), on the CPU.

``shard_of`` and every ``ShardTable`` (assignment, routes, ``rehome``)
are held ``==`` to ``glt_tpu``'s on the same inputs.  The router and
controller tests run against the port's serving replicas (ring graphs
on ``device="cpu"``), health transitions driven deterministically; the
kill-a-replica-under-load chaos test is marked slow, as
``glt_tpu``'s is.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from glt_tpu.serving import ShardTable as JaxShardTable
from glt_tpu.serving.router import shard_of as jax_shard_of
from glt_tpu_torch.distributed import init_server
from glt_tpu_torch.obs import flight as _flight
from glt_tpu_torch.obs import metrics as _metrics
from glt_tpu_torch.obs.slo import SloSpec
from glt_tpu_torch.serving import (
    BadRequest,
    FleetController,
    FleetRouter,
    FleetSpec,
    InferenceClient,
    NoHealthyReplica,
    ServingError,
    ShardTable,
)
from glt_tpu_torch.serving.router import shard_of
from glt_tpu_torch.testing.faults import FaultPlan
from test_serving import check_serving_batch
from test_torch_serving_front import opts as serving_opts
from test_torch_serving_front import ring as build_ring_dataset

torch.set_num_threads(1)


def same_table(t, j):
    """The port's table and glt_tpu's on the same inputs: assignment,
    live replicas, loads and every shard's owner."""
    assert t.assignment() == j.assignment()
    assert t.live_replicas() == j.live_replicas()
    np.testing.assert_array_equal(t.shard_load, j.shard_load)
    for r in j.replicas:
        assert t.shards_of(r) == j.shards_of(r)


# ---------------------------------------------------------------------------
# ShardTable: pure routing-table properties
# ---------------------------------------------------------------------------

class TestShardTable:
    def test_deterministic_and_complete(self):
        scores = np.random.default_rng(7).random(500)
        a = ShardTable(["r0", "r1", "r2"], num_shards=32, scores=scores)
        b = ShardTable(["r0", "r1", "r2"], num_shards=32, scores=scores)
        assert a.assignment() == b.assignment()
        same_table(a, JaxShardTable(["r0", "r1", "r2"], num_shards=32,
                                    scores=scores))
        assert sorted(a.assignment()) == list(range(32))
        # every replica owns shards when shards >> replicas
        assert {a.owner(s) for s in range(32)} == {"r0", "r1", "r2"}

    def test_hash_spreads_consecutive_ids(self):
        # hot blocks (consecutive after frequency reordering) must not
        # land on one shard
        shards = shard_of(np.arange(64), 8)
        assert len(set(shards.tolist())) == 8
        ids = np.random.default_rng(3).integers(0, 1 << 40, 100_000)
        for k in (1, 7, 8, 48, 64):
            np.testing.assert_array_equal(shard_of(ids, k),
                                          jax_shard_of(ids, k))

    def test_load_balanced_over_scores(self):
        # heavily skewed scores: LPT still balances replica loads
        scores = 1.0 / (np.arange(1, 2001) ** 1.1)
        t = ShardTable(["r0", "r1", "r2"], num_shards=64, scores=scores)
        same_table(t, JaxShardTable(["r0", "r1", "r2"], num_shards=64,
                                    scores=scores))
        loads = {r: 0.0 for r in t.replicas}
        for s, r in t.assignment().items():
            loads[r] += float(t.shard_load[s])
        top, bottom = max(loads.values()), min(loads.values())
        assert top <= 1.5 * bottom, loads

    def test_route_is_stable_and_score_aware(self):
        scores = np.full(100, 0.1)
        scores[42] = 1.0
        t = ShardTable(["r0", "r1"], num_shards=16, scores=scores)
        j = JaxShardTable(["r0", "r1"], num_shards=16, scores=scores)
        rng = np.random.default_rng(5)
        for _ in range(200):
            seeds = rng.integers(-2, 110, rng.integers(1, 6))
            assert t.route(seeds) == j.route(seeds)
        # hottest seed decides the request's home
        expected = t.owner(int(shard_of([42], 16)[0]))
        assert t.route([3, 42]) == expected
        assert t.route([42, 3]) == expected
        # and routing is a pure function of the seeds
        assert t.route([7]) == t.route([7])
        with pytest.raises(ValueError, match="empty"):
            t.route([])

    def test_rehome_moves_only_dead_shards(self):
        t = ShardTable(["r0", "r1", "r2"], num_shards=24)
        j = JaxShardTable(["r0", "r1", "r2"], num_shards=24)
        before = t.assignment()
        dead_shards = t.shards_of("r1")
        moved = t.rehome("r1")
        assert moved == dead_shards == j.rehome("r1")
        same_table(t, j)
        after = t.assignment()
        for s in range(24):
            if s in moved:
                assert after[s] in ("r0", "r2")
            else:
                assert after[s] == before[s]          # survivors keep theirs
        assert t.live_replicas() == ["r0", "r2"]
        assert t.rehome("r1") == []                   # idempotent
        # last survivor takes everything; then nobody is left
        assert t.rehome("r0") == j.rehome("r0")
        same_table(t, j)
        assert {t.owner(s) for s in range(24)} == {"r2"}
        assert t.rehome("r2") == []
        assert t.live_replicas() == []


# ---------------------------------------------------------------------------
# Router wire tests: real replicas, fast path
# ---------------------------------------------------------------------------

@pytest.fixture()
def fleet():
    """Three serving replicas + an affinity router (probes off: the
    tests drive health transitions deterministically)."""
    _metrics.enable()
    servers = [init_server(build_ring_dataset(),
                           serving=serving_opts(seed_cache_entries=64))
               for _ in range(3)]
    router = FleetRouter([s.addr for s in servers], num_shards=24,
                         request_timeout=30.0, start_probes=False,
                         health_deadline_s=60.0, device="cpu")
    try:
        yield servers, router
    finally:
        router.close()
        for s in servers:
            s.shutdown()


class TestFleetRouter:
    def test_affinity_routing_serves_and_sticks(self, fleet):
        servers, router = fleet
        homes = {}
        for seed in range(0, 48, 3):
            batch = router.subgraph([seed])
            check_serving_batch(batch, [seed])
            homes[seed] = router.table.route([seed])
        # same seed, same replica — affinity is deterministic
        for seed, home in homes.items():
            assert router.table.route([seed]) == home
        # the work actually spread over the fleet
        stats = router.replica_stats()
        active = [k for k, st in stats.items()
                  if st and st.get("completed", 0) > 0]
        assert len(active) >= 2, stats
        # replica-side seed-affinity cache is counting
        assert sum(st["seed_cache_lookups"] for st in stats.values()
                   if st) >= 16

    def test_structured_errors_pass_through_without_failover(self, fleet):
        servers, router = fleet
        dumps_before = len([e for e in
                            _flight.recorder().snapshot()["events"]
                            if e["kind"] == "fleet.failover"])
        with pytest.raises(BadRequest):
            router.subgraph([4999])          # out of range: bad_request
        events = [e for e in _flight.recorder().snapshot()["events"]
                  if e["kind"] == "fleet.failover"]
        assert len(events) == dumps_before   # structured != failover
        assert router.fleet_status()[router.table.replicas[0]]["alive"]

    def test_kill_fails_over_exactly_once(self, fleet):
        servers, router = fleet
        # find a seed homed on replica 0 and warm its path
        key0 = router.table.replicas[0]
        seed = next(s for s in range(48)
                    if router.table.route([s]) == key0)
        check_serving_batch(router.subgraph([seed]), [seed])
        servers[0].kill()
        batch = router.subgraph([seed])      # transport error -> failover
        check_serving_batch(batch, [seed])
        status = router.fleet_status()
        assert not status[key0]["alive"]
        assert status[key0]["shards"] == 0   # fully re-homed
        successor = router.table.route([seed])
        assert successor != key0
        events = [e["kind"] for e in
                  _flight.recorder().snapshot()["events"]]
        assert "fleet.replica_dead" in events
        assert "fleet.rehome" in events
        assert "fleet.failover" in events
        # exactly-once: the failed-over request was served by exactly
        # one survivor, and later traffic flows without failover
        n_failovers = sum(1 for k in events if k == "fleet.failover")
        check_serving_batch(router.subgraph([seed]), [seed])
        events2 = [e["kind"] for e in
                   _flight.recorder().snapshot()["events"]]
        assert sum(1 for k in events2
                   if k == "fleet.failover") == n_failovers

    def test_all_dead_is_structured(self, fleet):
        servers, router = fleet
        for s in servers:
            s.kill()
        with pytest.raises(NoHealthyReplica):
            router.subgraph([1])
        # and it stays structured (bounded, not hanging) on repeat
        with pytest.raises(NoHealthyReplica):
            router.subgraph([2])

    def test_fleet_hello_and_shed_ops(self, fleet):
        servers, router = fleet
        assert router.legacy_replicas() == []
        resp = router._control[router.table.replicas[0]].request(
            op="fleet_hello", peer="probe")
        assert resp["protocol"] == 1 and resp["serving"] is True
        out = router.broadcast_shed(
            {"slo": "t", "state": "firing", "shed_frac": 0.5})
        assert all(r and r["ok"] for r in out.values())
        assert servers[0].serving.stats()["shed_frac"] == 0.5
        router.broadcast_shed({"slo": "t", "state": "resolved"})
        assert servers[0].serving.stats()["shed_frac"] == 0.0

    def test_random_policy_spreads_per_request(self, fleet):
        servers, router = fleet
        rrouter = FleetRouter([s.addr for s in servers],
                              policy="random", request_timeout=30.0,
                              start_probes=False, seed=3, device="cpu")
        try:
            seen = {rrouter._pick([5]) for _ in range(32)}
            assert len(seen) == 3            # same seed, many homes
        finally:
            rrouter.close()


def test_stale_after_s_wire_verdict():
    """fleet_health returns the structured staleness verdict
    so callers read a sign instead of re-deriving deadline math."""
    from glt_tpu_torch.distributed import RemoteServerConnection

    srv = init_server(build_ring_dataset(), heartbeat_deadline=0.4)
    conn = RemoteServerConnection(srv.addr, timeout=10.0)
    try:
        conn.request(op="heartbeat", peer="w1", step=3)
        peers = conn.request(op="fleet_health")["peers"]
        assert peers["w1"]["stale_after_s"] > 0
        assert peers["w1"]["stale_after_s"] <= 0.4
        time.sleep(0.6)
        peers = conn.request(op="fleet_health")["peers"]
        assert peers["w1"]["stale_after_s"] <= 0
        assert not peers["w1"]["alive"]
    finally:
        conn.close()
        srv.shutdown()


# ---------------------------------------------------------------------------
# Mixed-version fleet: both directions
# ---------------------------------------------------------------------------

def _make_pre_fleet(srv):
    """Regress a live server to the pre-fleet protocol: fleet ops hit
    the unknown-op path (ValueError -> fatal error + connection close),
    exactly how a pre-fleet server answers them."""
    orig = srv._handle

    def old_handle(req, trace_ctx=None):
        if req.get("op") in ("fleet_hello", "fleet_shed"):
            raise ValueError(f"unknown op {req['op']!r}")
        return orig(req, trace_ctx=trace_ctx)

    srv._handle = old_handle


class TestMixedVersionFleet:
    def test_pre_fleet_replica_degrades_to_direct_routing(self):
        """Old replica behind a new router: marked legacy at handshake,
        still serves subgraphs, never receives fleet control ops."""
        servers = [init_server(build_ring_dataset(),
                               serving=serving_opts())
                   for _ in range(2)]
        _make_pre_fleet(servers[0])
        router = FleetRouter([s.addr for s in servers], num_shards=8,
                             request_timeout=30.0, start_probes=False,
                             health_deadline_s=60.0, device="cpu")
        try:
            key_old = router.table.replicas[0]
            assert router.legacy_replicas() == [key_old]
            # direct routing still works against the legacy replica
            seed = next(s for s in range(48)
                        if router.table.route([s]) == key_old)
            check_serving_batch(router.subgraph([seed]), [seed])
            # shed broadcast skips it (and reaches the new replica)
            out = router.broadcast_shed(
                {"slo": "t", "state": "firing", "shed_frac": 0.25})
            assert key_old not in out
            assert servers[1].serving.stats()["shed_frac"] == 0.25
            assert servers[0].serving.stats()["shed_frac"] == 0.0
        finally:
            router.close()
            for s in servers:
                s.shutdown()

    def test_new_replica_serves_pre_fleet_client(self):
        """Other direction: a pre-fleet client (plain InferenceClient,
        no handshake, no fleet ops) against a fleet-aware replica sees
        the unchanged serving protocol."""
        srv = init_server(build_ring_dataset(), serving=serving_opts())
        cli = InferenceClient(srv.addr, timeout=30.0, device="cpu")
        try:
            check_serving_batch(cli.subgraph([5, 9]), [5, 9])
            stats = cli.stats()
            assert stats["enabled"] and stats["completed"] >= 1
        finally:
            cli.close()
            srv.shutdown()


# ---------------------------------------------------------------------------
# FleetController: deterministic SLO-driven shed/reopen + postmortem
# ---------------------------------------------------------------------------

class TestFleetController:
    def _controller(self, srv, **spec_kw):
        spec = FleetSpec(
            slos=[SloSpec(name="fleet_rejects",
                          metric="glt.fleet.rejected_total",
                          kind="ratio",
                          denom="glt.fleet.requests_total",
                          objective=0.05, comparison="<=",
                          windows=((1.0, 1.0),), shed_frac=0.4)],
            replica_deadline_s=600.0, **spec_kw)
        return FleetController([srv.addr], spec=spec)

    def test_burn_fires_fleet_wide_shed_and_reopens(self, monkeypatch):
        srv = init_server(build_ring_dataset(), serving=serving_opts())
        ctrl = self._controller(srv)
        state = {"completed": 100, "rejected_overload": 0}

        def fake_poll(key):
            return {"stats": {"enabled": True, "ewma_batch_ms": 5.0,
                              "seed_cache_hit_rate": 0.9, **state},
                    "health": {"peers": {}}}

        monkeypatch.setattr(ctrl, "_poll_replica", fake_poll)
        try:
            t0 = time.monotonic()
            assert ctrl.tick(now=t0) == []            # baseline
            # a burst of rejections: 50% of new traffic rejected
            state = dict(state, completed=150, rejected_overload=50)
            alerts = ctrl.tick(now=t0 + 1.0)
            assert [a["state"] for a in alerts] == ["firing"]
            assert srv.serving.stats()["shed_frac"] == 0.4
            assert "fleet_rejects" in ctrl.status()["firing"]
            # traffic heals: only successes in the next window
            state = dict(state, completed=400)
            alerts = ctrl.tick(now=t0 + 2.0)
            assert [a["state"] for a in alerts] == ["resolved"]
            assert srv.serving.stats()["shed_frac"] == 0.0
        finally:
            ctrl.stop()
            srv.shutdown()

    def test_stale_peer_verdicts_are_consumed(self, monkeypatch):
        srv = init_server(build_ring_dataset(), serving=serving_opts())
        ctrl = self._controller(srv)

        def fake_poll(key):
            return {"stats": {"enabled": False},
                    "health": {"peers": {
                        "w1": {"alive": False, "stale_after_s": -1.2}}}}

        monkeypatch.setattr(ctrl, "_poll_replica", fake_poll)
        try:
            ctrl.tick(now=time.monotonic())
            kinds = [e for e in _flight.recorder().snapshot()["events"]
                     if e["kind"] == "fleet.stale_peers"]
            assert kinds and any("w1" in p for p in kinds[-1]["peers"])
        finally:
            ctrl.stop()
            srv.shutdown()

    def test_replica_death_writes_merged_postmortem(self, tmp_path):
        servers = [init_server(build_ring_dataset(),
                               serving=serving_opts())
                   for _ in range(2)]
        router = FleetRouter([s.addr for s in servers],
                             request_timeout=30.0, start_probes=False,
                             health_deadline_s=600.0, device="cpu")
        spec = FleetSpec(replica_deadline_s=600.0,
                         postmortem_dir=str(tmp_path))
        ctrl = FleetController([s.addr for s in servers], spec=spec,
                               router=router)
        try:
            check_serving_batch(router.subgraph([1]), [1])
            servers[0].kill()
            # drive a request homed on the corpse: its failover marks
            # the replica dead and reports to the controller
            key0 = router.table.replicas[0]
            seed = next(s for s in range(48)
                        if router.table.route([s]) == key0)
            check_serving_batch(router.subgraph([seed]), [seed])
            assert not router.fleet_status()[key0]["alive"]
            # router -> controller death report -> merged postmortem
            pms = ctrl.status()["postmortems"]
            assert len(pms) == 1
            merged = json.load(open(pms[0]))
            assert _flight.is_flight_dump(merged)
            kinds = {e["kind"] for e in merged["events"]}
            assert "fleet.replica_dead" in kinds
            assert "fleet.rehome" in kinds
            assert "server.killed" in kinds
        finally:
            ctrl.stop()
            router.close()
            for s in servers:
                s.shutdown()


# ---------------------------------------------------------------------------
# Chaos (slow): kill a replica under open-loop Poisson zipf load
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_chaos_kill_replica_under_poisson_load(tmp_path):
    """The acceptance scenario: 3 replicas, zipf workload, replica 0
    killed counter-exactly under load.  Every request resolves to a
    correct batch or a structured ServingError (zero unstructured
    errors, zero duplicates), survivors' affinity-cache hit rate
    re-converges after re-homing, and the postmortem merges from
    flight dumps via ``python -m glt_tpu_torch.obs merge``."""
    from glt_tpu_torch.obs.__main__ import main as obs_main

    _metrics.enable()
    n = 512
    rng = np.random.default_rng(11)
    # zipf over the id space: the hot head is what affinity protects
    probs = 1.0 / (np.arange(1, n + 1) ** 1.2)
    probs /= probs.sum()

    plans = [FaultPlan() for _ in range(3)]
    servers = [init_server(
        build_ring_dataset(n=n),
        serving=serving_opts(seed_cache_entries=96, max_inflight=128),
        fault_plan=plans[i]) for i in range(3)]
    router = FleetRouter([s.addr for s in servers], scores=probs,
                         num_shards=48, request_timeout=30.0,
                         start_probes=False, health_deadline_s=600.0,
                         backoff_base=0.01, backoff_cap=0.05, device="cpu")
    ctrl = FleetController([s.addr for s in servers],
                           spec=FleetSpec(replica_deadline_s=600.0,
                                          postmortem_dir=str(tmp_path)),
                           router=router)

    outcomes = []
    outcomes_lock = threading.Lock()

    def run_phase(num_requests, rate_hz, workers=4, phase=""):
        """Open-loop Poisson load: arrival times pre-drawn, split over
        worker threads; a slow server does NOT slow arrivals down."""
        arrivals = np.cumsum(rng.exponential(1.0 / rate_hz,
                                             size=num_requests))
        seeds = rng.choice(n, size=num_requests, p=probs)
        t0 = time.monotonic()

        def worker(w):
            for i in range(w, num_requests, workers):
                delay = t0 + arrivals[i] - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                seed = int(seeds[i])
                try:
                    batch = router.subgraph([seed])
                    check_serving_batch(batch, [seed], n=n)
                    res = ("ok", seed)
                except ServingError as e:
                    res = ("structured", type(e).__name__)
                except BaseException as e:  # noqa: BLE001 — the bug class
                    res = ("UNSTRUCTURED", repr(e))
                with outcomes_lock:
                    outcomes.append((phase, res))

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()

    def survivor_rates(stats):
        return {k: (st["seed_cache_hits"], st["seed_cache_lookups"])
                for k, st in stats.items() if st and st.get("enabled")}

    try:
        # Phase 1: warm the affinity caches, measure the baseline.
        run_phase(260, rate_hz=120.0, phase="warm")
        pre = survivor_rates(router.replica_stats())
        key0 = router.table.replicas[0]
        survivors = [k for k in router.table.replicas if k != key0]
        pre_rate = {k: pre[k][0] / max(1, pre[k][1]) for k in survivors}

        # Phase 2: kill replica 0 counter-exactly under load — after 5
        # more micro-batches its kill hook severs everything mid-flight.
        plans[0].replica_kill_hook = lambda: threading.Thread(
            target=servers[0].kill, daemon=True).start()
        plans[0].kill_replica_after_serving_batches = 5
        run_phase(200, rate_hz=120.0, phase="kill")
        assert plans[0].injected_replica_kills == 1
        status = router.fleet_status()
        assert not status[key0]["alive"]
        assert status[key0]["shards"] == 0

        # Phase 3a: let the survivors' LRUs re-warm over the re-homed
        # shards (the cold window re-convergence must climb out of).
        run_phase(200, rate_hz=120.0, phase="rewarm")
        # Phase 3b: measure steady-state hit rate over THIS window only.
        mid = survivor_rates(router.replica_stats())
        run_phase(320, rate_hz=120.0, phase="recover")
        end = survivor_rates(router.replica_stats())
        for k in survivors:
            d_hits = end[k][0] - mid[k][0]
            d_lookups = end[k][1] - mid[k][1]
            assert d_lookups > 0, (k, mid, end)
            post_rate = d_hits / d_lookups
            # acceptance: re-converges to within 10% of pre-kill
            assert post_rate >= pre_rate[k] - 0.10, (
                k, pre_rate[k], post_rate)

        # Outcome audit: every request resolved, structurally.
        assert len(outcomes) == 260 + 200 + 200 + 320
        unstructured = [o for o in outcomes if o[1][0] == "UNSTRUCTURED"]
        assert unstructured == [], unstructured[:5]
        ok = sum(1 for o in outcomes if o[1][0] == "ok")
        # the kill window may shed/fail a bounded handful structurally;
        # the steady phases must be essentially clean
        assert ok >= len(outcomes) - 40, (ok, len(outcomes))
        for phase in ("warm", "recover"):
            bad = [o for o in outcomes
                   if o[0] == phase and o[1][0] != "ok"]
            assert len(bad) <= 8, bad[:5]

        # Postmortem: written on death by the controller, and the same
        # story reconstructs through the CLI merge path.
        pms = ctrl.status()["postmortems"]
        assert pms, "controller wrote no postmortem"
        merged = json.load(open(pms[0]))
        kinds = {e["kind"] for e in merged["events"]}
        assert {"fleet.replica_dead", "fleet.rehome",
                "server.killed"} <= kinds
        sources = [str(p) for p in sorted(tmp_path.glob(
            "glt_fleet_pm-*.json"))]
        cli_out = str(tmp_path / "cli_merged.json")
        assert obs_main(["merge", "-o", cli_out, *sources]) == 0
        cli_merged = json.load(open(cli_out))
        cli_kinds = {e["kind"] for e in cli_merged["events"]}
        assert {"fleet.replica_dead", "fleet.rehome"} <= cli_kinds
    finally:
        ctrl.stop()
        router.close()
        for s in servers:
            s.shutdown()
