"""Chaos tests for the port's sampling service and fleet supervision
(cf. ``tests/test_fault_tolerance.py`` and the supervisor cases of
``tests/test_checkpoint.py``).

Each test injects one deterministic ``FaultPlan`` into a socket endpoint
or the producer thread and asserts the contract: every batch of an epoch
delivered exactly once (the seq accounting), or a structured error in
bounded time.  No assertion races the wall clock: leases are expired by
moving a producer's last-activity stamp, deaths are awaited on events or
on counters with a generous bound that only a broken implementation
reaches.
"""
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from glt_tpu_torch import random as trandom
from glt_tpu_torch.ckpt import Checkpointer, TrainLoop
from glt_tpu_torch.data import CSRTopo, Graph
from glt_tpu_torch.distributed import (
    RemoteNeighborLoader,
    RemoteSamplingWorkerOptions,
    RemoteServerConnection,
    UnknownProducerError,
    init_server,
)
from glt_tpu_torch.distributed.dist_server import (_KIND_JSON,
                                                   ProtocolError,
                                                   recv_frame, send_frame)
from glt_tpu_torch.distributed.supervisor import (
    BarrierTimeoutError, HeartbeatSender, PeerDeadError, SupervisedExit,
    Supervisor, run_with_deadline, timed_barrier)
from glt_tpu_torch.testing import FaultPlan
from test_torch_dist_loader import N, build_ring, check_batch, seeds_of

torch.set_num_threads(1)

FAST = dict(rpc_timeout=30.0, max_retries=8, backoff_base=0.01,
            backoff_cap=0.1)
BOUND_S = 60.0      # reached only by a broken implementation


def run_epoch(loader):
    seen = []
    for b in loader:
        check_batch(b)
        seen += seeds_of(b)
    return seen


def assert_exactly_once(loader, seen, n=N):
    assert sorted(seen) == list(range(n))
    st = loader.epoch_stats
    assert st["received"] == len(loader)
    assert st["seqs"] == set(range(len(loader)))


def wait_for(cond, what):
    deadline = time.monotonic() + BOUND_S
    while not cond():
        assert time.monotonic() < deadline, f"{what} never happened"
        time.sleep(0.01)


def loader_on(srv, batch_size=2, fault_plan=None, **opts):
    return RemoteNeighborLoader(
        srv.addr, [2, 2], np.arange(N), batch_size=batch_size,
        device="cpu", fault_plan=fault_plan,
        worker_options=RemoteSamplingWorkerOptions(**{**FAST, **opts}))


# -- frame bounds -------------------------------------------------------------
def test_recv_frame_rejects_oversize_length():
    a, b = socket.socketpair()
    try:
        a.sendall(np.array([0], "<u4").tobytes()
                  + np.array([1 << 40], "<u8").tobytes())
        with pytest.raises(ProtocolError, match="exceeds"):
            recv_frame(b, max_len=1 << 20)
    finally:
        a.close()
        b.close()


def test_server_rejects_oversize_frame_and_keeps_serving():
    srv = init_server(build_ring(), max_frame_bytes=1 << 10)
    try:
        raw = socket.create_connection(srv.addr, timeout=30)
        send_frame(raw, _KIND_JSON, b"x" * (1 << 11))
        kind, data = recv_frame(raw)
        assert kind == _KIND_JSON and b'"protocol"' in data
        raw.close()
        conn = RemoteServerConnection(srv.addr, timeout=30)
        assert conn.request(op="get_dataset_meta")["num_nodes"] == N
        conn.close()
    finally:
        srv.shutdown()


# -- dropped sockets: reconnect + ack replay ----------------------------------
@pytest.mark.parametrize("side", ["client", "server"])
def test_dropped_socket_exactly_once(side):
    """The socket dies after K frames (client side: the request is lost;
    server side: the sequenced batch is lost in flight and replayed from
    the window); every batch still arrives exactly once."""
    plan = FaultPlan(drop_after_frames=2 if side == "client" else 3)
    srv = init_server(build_ring(),
                      fault_plan=plan if side == "server" else None)
    loader = loader_on(srv, fault_plan=plan if side == "client" else None)
    try:
        assert_exactly_once(loader, run_epoch(loader))
        assert loader.epoch_stats["reconnects"] >= 1
        assert plan.injected_drops >= 1
    finally:
        loader.shutdown()
        srv.shutdown()


def test_fail_nth_frame():
    srv = init_server(build_ring())
    plan = FaultPlan(fail_nth_frame=4, fail_exc=ConnectionResetError)
    loader = loader_on(srv, fault_plan=plan)
    try:
        assert_exactly_once(loader, run_epoch(loader))
        assert plan.injected_failures == 1
    finally:
        loader.shutdown()
        srv.shutdown()


def test_corrupt_frame_length_recovers():
    srv = init_server(build_ring())
    plan = FaultPlan(corrupt_length_frame=5)
    loader = loader_on(srv, fault_plan=plan)
    try:
        assert_exactly_once(loader, run_epoch(loader))
        assert plan.injected_corruptions == 1
    finally:
        loader.shutdown()
        srv.shutdown()


def test_killed_producer_thread_bounded_error_and_restart():
    plan = FaultPlan(kill_producer_after_puts=2)
    srv = init_server(build_ring(), fault_plan=plan)
    loader = loader_on(srv)
    try:
        with pytest.raises(RuntimeError, match="thread died"):
            run_epoch(loader)
        assert_exactly_once(loader, run_epoch(loader))
    finally:
        loader.shutdown()
        srv.shutdown()


# -- leases ------------------------------------------------------------------
def test_lease_expiry_gc_and_unknown_producer_signal():
    """A client that vanishes without a destroy: once its lease runs out
    the reaper collects the producer, and the zombie's next epoch gets
    the structured unknown_producer error."""
    srv = init_server(build_ring(), reap_interval=0.02)
    loader = loader_on(srv, batch_size=6, lease_secs=30.0)
    try:
        assert_exactly_once(loader, run_epoch(loader))
        assert srv.live_producers() == 1
        loader.conn.close()
        [prod] = list(srv._producers.values())
        prod.last_active -= 3600.0          # the lease ran out
        wait_for(lambda: srv.live_producers() == 0, "lease reaping")
        with pytest.raises(RuntimeError, match="unknown or expired"):
            run_epoch(loader)
        with pytest.raises(UnknownProducerError):
            loader.conn.fetch_message(loader.producer_id, epoch=9)
    finally:
        loader.conn.close()
        srv.shutdown()


def test_lease_renewed_by_activity():
    """Every request naming a producer renews its lease: a lease moved
    to one second from expiry is fresh again after an epoch, and the
    heartbeat op renews it too."""
    srv = init_server(build_ring(), reap_interval=0.02)
    loader = loader_on(srv, lease_secs=30.0)
    try:
        [prod] = list(srv._producers.values())
        for _ in range(2):
            prod.last_active = time.monotonic() - 29.0
            before = prod.last_active
            assert_exactly_once(loader, run_epoch(loader))
            assert prod.last_active > before + 28.0
            assert not prod.lease_expired(time.monotonic())
            assert srv.live_producers() == 1
        prod.last_active = time.monotonic() - 29.0
        before = prod.last_active
        loader.conn.request(op="heartbeat", peer="trainer-0",
                            producer_id=loader.producer_id)
        assert prod.last_active > before + 28.0
    finally:
        loader.shutdown()
        srv.shutdown()


@pytest.mark.slow
def test_lease_gc_mp_fleet_and_shm():
    """A reaped mp producer takes its worker processes and its shm ring
    with it."""
    srv = init_server(build_ring(), dataset_builder=build_ring,
                      reap_interval=0.05)
    loader = loader_on(srv, batch_size=6, num_workers=2,
                       channel_capacity_bytes=1 << 20, lease_secs=30.0)
    try:
        assert_exactly_once(loader, run_epoch(loader))
        [prod] = list(srv._producers.values())
        workers = list(prod._mp_producer._workers)
        shm_name = prod._channel.name.lstrip("/")
        assert workers and all(p.is_alive() for p in workers)
        assert shm_name in os.listdir("/dev/shm")
        loader.conn.close()
        prod.last_active -= 3600.0
        wait_for(lambda: srv.live_producers() == 0, "lease reaping")
        # The reaper's stop joins the workers; joining them here as well
        # would race it for their exit status.
        wait_for(lambda: not prod._mp_producer._workers, "the fleet's stop")
        wait_for(lambda: not any(p.is_alive() for p in workers),
                 "the workers' exit")
        wait_for(lambda: shm_name not in os.listdir("/dev/shm"),
                 "the ring's unlink")
    finally:
        loader.conn.close()
        srv.shutdown()


# -- structured errors, failover ---------------------------------------------
def test_unknown_producer_keeps_connection_alive():
    srv = init_server(build_ring())
    conn = RemoteServerConnection(srv.addr, timeout=30)
    try:
        with pytest.raises(UnknownProducerError):
            conn.fetch_message(producer_id=12345, epoch=1)
        assert conn.request(op="get_dataset_meta")["num_nodes"] == N
        assert conn.reconnects == 0
    finally:
        conn.close()
        srv.shutdown()


def test_stale_epoch_structured_error():
    srv = init_server(build_ring())
    conn = RemoteServerConnection(srv.addr, timeout=30)
    try:
        pid = conn.request(op="create_sampling_producer", num_neighbors=[2],
                           input_nodes=list(range(N)),
                           batch_size=6)["producer_id"]
        conn.request(op="start_new_epoch_sampling", producer_id=pid,
                     epoch=2)
        with pytest.raises(RuntimeError, match="stale_epoch"):
            conn.fetch_message(producer_id=pid, epoch=1)
    finally:
        conn.close()
        srv.shutdown()


def _closed_addr():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    addr = probe.getsockname()
    probe.close()
    return addr


def test_failover_to_fallback_addr_exactly_once():
    """The primary is down: the loader creates its producer on the
    replica from fallback_addrs and every epoch arrives exactly once."""
    srv = init_server(build_ring())
    loader = RemoteNeighborLoader(
        _closed_addr(), [2, 2], np.arange(N), batch_size=2, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(
            fallback_addrs=(srv.addr,), **FAST))
    try:
        for _ in range(2):
            assert_exactly_once(loader, run_epoch(loader))
        assert srv.live_producers() == 1
    finally:
        loader.shutdown()
        srv.shutdown()


def test_failover_mid_epoch_is_a_structured_error():
    """A producer cannot migrate: when the primary dies mid-epoch the
    failed-over fetch meets a replica that never owned it and surfaces
    UnknownProducerError, not a hang or a duplicate."""
    primary, replica = init_server(build_ring()), init_server(build_ring())
    loader = RemoteNeighborLoader(
        primary.addr, [2, 2], np.arange(N), batch_size=2, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(
            fallback_addrs=(replica.addr,), prefetch_size=1,
            buffer_capacity=1, **FAST))
    try:
        it = iter(loader)
        check_batch(next(it))
        primary.kill()
        with pytest.raises(RuntimeError, match="unknown or expired"):
            for _ in it:
                pass
    finally:
        loader.conn.close()
        primary.shutdown()
        replica.shutdown()


def test_abandoned_epoch_prompt_shutdown():
    srv = init_server(build_ring())
    loader = loader_on(srv, prefetch_size=1, buffer_capacity=1,
                       rpc_timeout=600.0)
    try:
        it = iter(loader)
        check_batch(next(it))
        it.close()
        assert sorted(run_epoch(loader)) == list(range(N))
        t1 = time.monotonic()
        loader.shutdown()
        assert time.monotonic() - t1 < BOUND_S
    finally:
        srv.shutdown()


@pytest.mark.slow
def test_multi_epoch_chaos():
    server_plan = FaultPlan(drop_after_frames=5)
    client_plan = FaultPlan(drop_after_frames=4)
    srv = init_server(build_ring(), fault_plan=server_plan,
                      reap_interval=0.1)
    loader = loader_on(srv, fault_plan=client_plan, lease_secs=30.0)
    try:
        for _ in range(2):
            assert_exactly_once(loader, run_epoch(loader))
        assert srv.live_producers() == 1
    finally:
        loader.shutdown()
        srv.shutdown()


def test_replay_and_reconnect_events_carry_trace_id():
    from glt_tpu_torch import obs

    plan = FaultPlan(drop_after_frames=3)
    srv = init_server(build_ring(), fault_plan=plan)
    tracer = obs.start_trace(process_name="chaos")
    try:
        loader = loader_on(srv)
        try:
            assert_exactly_once(loader, run_epoch(loader))
            assert loader.epoch_stats["reconnects"] >= 1
        finally:
            loader.shutdown()
        events = tracer.events
        tid = next(e for e in events
                   if e["name"] == "remote.epoch")["args"]["trace_id"]
        replays = [e for e in events if e["name"] == "server.replay"]
        reconnects = [e for e in events if e["name"] == "remote.reconnect"]
        assert replays and reconnects
        assert all(e["args"]["trace_id"] == tid for e in replays)
        assert all(e["args"]["trace_id"] == tid for e in reconnects)
        assert any(e["args"].get("replayed") for e in events
                   if e["name"] == "server.fetch")
        assert obs.validate_chrome_trace(tracer.chrome_trace()) == []
    finally:
        obs.install(None)
        srv.shutdown()


# -- the supervisor ------------------------------------------------------------
def _dead_supervisor(name="server-0"):
    """A supervisor whose peer ``name`` has been declared dead (awaited
    on the on_dead callback, not on the clock)."""
    died = threading.Event()
    sup = Supervisor(deadline_secs=0.05, poll_interval=0.01,
                     on_dead=lambda peer, rep: died.set())
    sup.register(name)
    assert died.wait(BOUND_S)
    return sup


def test_supervisor_detects_dead_peer():
    fired = []
    died = threading.Event()

    def on_dead(peer, report):
        fired.append((peer, report))
        died.set()

    sup = Supervisor(deadline_secs=0.05, poll_interval=0.01,
                     on_dead=on_dead)
    sup.beat("trainer-1", step=3)
    assert died.wait(BOUND_S)
    with pytest.raises(PeerDeadError) as err:
        sup.raise_if_dead()
    assert err.value.report["reason"] == "peer_dead"
    assert err.value.report["peer"] == "trainer-1"
    assert sup.dead_peers() == ["trainer-1"]
    st = sup.status()["trainer-1"]
    assert st["alive"] is False and st["step"] == 3
    assert st["stale_after_s"] < 0
    # fires once per death; a beat revives the peer
    time.sleep(0.05)
    assert len(fired) == 1
    sup.beat("trainer-1")
    sup.raise_if_dead()
    sup.stop()


def test_supervisor_watch_probe_keeps_peer_alive():
    calls = []
    sup = Supervisor(deadline_secs=30.0, poll_interval=0.01)
    sup.watch("server-0", lambda: calls.append(1), interval=0.01)
    wait_for(lambda: len(calls) >= 5, "five probes")
    sup.raise_if_dead()
    assert sup.status()["server-0"]["alive"]
    sup.stop()


def test_run_with_deadline():
    never = threading.Event()
    with pytest.raises(BarrierTimeoutError) as err:
        run_with_deadline(never.wait, 0.05, what="stuck")
    assert err.value.report == {"reason": "barrier_timeout",
                                "what": "stuck", "deadline_s": 0.05}
    assert run_with_deadline(lambda: 7, 30.0) == 7
    with pytest.raises(KeyError):
        run_with_deadline(lambda: {}["x"], 30.0)
    never.set()


def test_timed_barrier_single_process():
    timed_barrier("alone", timeout_s=0.5)          # no group: returns


def test_heartbeat_sender_over_the_wire():
    """A trainer's heartbeats reach the server's fleet_health table with
    its step; silent past the deadline, it is declared dead there."""
    srv = init_server(build_ring(), heartbeat_deadline=0.5)
    conn = RemoteServerConnection(srv.addr, timeout=30)
    probe = RemoteServerConnection(srv.addr, timeout=30)
    sender = HeartbeatSender(conn, "trainer-9", interval_secs=0.02,
                             step_fn=lambda: 42)
    try:
        wait_for(lambda: sender.sent >= 2, "two heartbeats")
        peers = probe.request(op="fleet_health")["peers"]
        assert peers["trainer-9"]["step"] == 42
        assert peers["trainer-9"]["alive"] is True
        sender.stop()
        wait_for(lambda: not probe.request(op="fleet_health")["peers"][
            "trainer-9"]["alive"], "the server declaring the trainer dead")
    finally:
        sender.stop()
        conn.close()
        probe.close()
        srv.shutdown()


def _node_loop(tmp_path, supervisor=None):
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, 60, 240), rng.integers(0, 60, 240)])
    feat = rng.standard_normal((60, 8)).astype("float32")
    from glt_tpu_torch.models import (GraphSAGE, adam, create_train_state,
                                      make_scanned_node_train_step)
    from glt_tpu_torch.sampler import NeighborSampler

    s = NeighborSampler(Graph(CSRTopo(ei, num_nodes=60), device="cpu"),
                        [4, 4], batch_size=16, with_edge=False)
    step = make_scanned_node_train_step(s, feat, np.arange(60) % 3, 16)
    torch.manual_seed(0)
    st = create_train_state(GraphSAGE(8, 16, 3, num_layers=2), adam(1e-2))
    return TrainLoop(step, st, np.arange(40), 16, 2, 2,
                     np.random.default_rng(7),
                     trandom.PRNGKey(3, device="cpu"),
                     checkpointer=Checkpointer(str(tmp_path / "ck")),
                     supervisor=supervisor)


def test_trainloop_supervisor_checkpoints_and_exits(tmp_path):
    """A dead peer seen at the first block boundary: an emergency
    checkpoint of the next cursor, then SupervisedExit with the reason
    and the path; a fresh loop resumes from it."""
    loop = _node_loop(tmp_path, supervisor=_dead_supervisor())
    with pytest.raises(SupervisedExit) as err:
        loop.run()
    e = err.value
    assert e.report["reason"] == "peer_dead"
    assert e.report["peer"] == "server-0"
    assert e.step == 1 and e.checkpoint_path
    assert os.path.isdir(e.checkpoint_path)
    fresh = _node_loop(tmp_path)
    snap = fresh.resume()
    assert snap.step == 1
    assert fresh.next_block == 1 and fresh.epoch == 0
    fresh.run()
    assert fresh.global_step == 4 and np.isfinite(fresh.losses).all()


def test_trainloop_with_a_live_supervisor_runs_through(tmp_path):
    sup = Supervisor(deadline_secs=30.0)
    sup.beat("server-0")
    loop = _node_loop(tmp_path, supervisor=sup)
    loop.run()
    assert loop.global_step == 4
    sup.stop()
