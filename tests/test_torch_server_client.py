"""The port's sampling service against ``glt_tpu``'s (cf.
``tests/test_server_client.py``): real sockets, real producer threads,
``device="cpu"``.  A port server's batches through the port's
``RemoteNeighborLoader`` are ``==`` to a ``glt_tpu`` server's through
``glt_tpu``'s client on the same ring, seeds, batch size and seed,
array by array, and the two packages speak one wire (each client reads
the other's server)."""
import glob
import json
import multiprocessing
import os
import queue
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from glt_tpu_torch.distributed import (
    DistNeighborLoader,
    RemoteNeighborLoader,
    RemoteSamplingWorkerOptions,
    RemoteServerConnection,
    init_server,
)
from glt_tpu_torch.distributed.dist_server import (_KIND_JSON, _KIND_MSG,
                                                   recv_frame, send_frame)
from test_torch_dist_loader import (BATCH_FIELDS, N, build_ring,
                                    check_batch, seeds_of)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    srv = init_server(build_ring())
    yield srv
    srv.shutdown()


def _arrays(b):
    return {f: np.asarray(getattr(b, f)) for f in BATCH_FIELDS}


def test_meta(server):
    conn = RemoteServerConnection(server.addr)
    meta = conn.request(op="get_dataset_meta")
    assert meta["num_nodes"] == N
    assert meta["server_rank"] == 0 and meta["num_servers"] == 1
    conn.close()


def test_dist_context_roles():
    from glt_tpu_torch.distributed import (DistRole, get_context,
                                           init_client_context,
                                           init_worker_group)

    ctx = init_worker_group(world_size=4, rank=2)
    assert get_context() is ctx
    assert ctx.is_worker() and not ctx.is_server()
    assert ctx.worker_name == "_default_worker-2"
    ctx = init_client_context(num_clients=2, client_rank=1, num_servers=2)
    assert ctx.role == DistRole.CLIENT
    assert ctx.num_servers() == 2 and ctx.num_clients() == 2
    assert ctx.global_world_size == 4 and ctx.global_rank == 3
    with pytest.raises(ValueError, match="rank"):
        init_worker_group(world_size=2, rank=2)


def test_remote_loader_epochs(server):
    loader = RemoteNeighborLoader(server.addr, [2, 2], np.arange(N),
                                  batch_size=6, prefetch=2, device="cpu")
    try:
        assert len(loader) == 4
        for _ in range(2):
            seen = []
            for b in loader:
                assert b.node.device.type == "cpu"
                check_batch(b)
                seen += seeds_of(b)
            assert sorted(seen) == list(range(N))
            st = loader.epoch_stats
            assert st["received"] == 4 and st["duplicates"] == 0
        assert loader.state_dict()["epoch"] == 2
    finally:
        loader.shutdown()


def _jax_batches(addr, **kw):
    from glt_tpu.distributed.dist_client import (
        RemoteNeighborLoader as JaxLoader)

    ld = JaxLoader(addr, [2, 2], np.arange(N), batch_size=5, **kw)
    try:
        return [[_arrays(b) for b in ld] for _ in range(2)]
    finally:
        ld.shutdown()


def _port_batches(addr, **kw):
    ld = RemoteNeighborLoader(addr, [2, 2], np.arange(N), batch_size=5,
                              device="cpu", **kw)
    try:
        return [[_arrays(b) for b in ld] for _ in range(2)]
    finally:
        ld.shutdown()


def _same_epochs(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb) == 5
        for ba, bb in zip(ea, eb):
            for f in BATCH_FIELDS:
                np.testing.assert_array_equal(ba[f], bb[f], err_msg=f)


@pytest.fixture(scope="module")
def jax_server():
    from glt_tpu.distributed.dist_server import init_server as jax_init
    from tests.test_dist_loader import build_ring_dataset

    srv = jax_init(build_ring_dataset())
    yield srv
    srv.shutdown()


def test_batches_equal_glt_tpu_server(server, jax_server):
    """Port server + port client == glt_tpu server + glt_tpu client:
    two shuffled epochs, every array of every batch, in order."""
    _same_epochs(_port_batches(server.addr, seed=4),
                 _jax_batches(jax_server.addr, seed=4))


@pytest.mark.parametrize("pair", ["port_client_jax_server",
                                  "jax_client_port_server"])
def test_one_wire_across_packages(server, jax_server, pair):
    if pair == "port_client_jax_server":
        got = _port_batches(jax_server.addr, seed=9)
    else:
        got = _jax_batches(server.addr, seed=9)
    _same_epochs(got, _port_batches(server.addr, seed=9))


def test_two_clients_at_once_equal_each_alone(server):
    """Two producers sampling concurrently on one server give the
    batches each gives alone."""
    alone = {s: _port_batches(server.addr, seed=s) for s in (1, 2)}
    got, errs = {}, []

    def run(s):
        try:
            got[s] = _port_batches(server.addr, seed=s)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=run, args=(s,)) for s in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs
    for s in (1, 2):
        _same_epochs(got[s], alone[s])


def test_get_metrics_and_stage_histograms(server):
    from glt_tpu_torch.obs import metrics

    metrics.enable()
    try:
        conn = RemoteServerConnection(server.addr)
        loader = RemoteNeighborLoader(server.addr, [2, 2], np.arange(N),
                                      batch_size=6, device="cpu")
        try:
            for b in loader:
                check_batch(b)
            resp = conn.request(op="get_metrics")
            assert resp["enabled"] is True
            text = resp["text"]
            assert 'glt_server_requests_total{op="get_metrics"}' in text
            assert "# TYPE glt_server_live_producers gauge" in text
            snap = metrics.snapshot()
            for stage in ("queue_wait", "sample", "serialize", "send"):
                name = f"glt.server.{stage}_ms"
                assert snap[f"{name}.count"] >= len(loader), name
                assert snap[f"{name}.p50"] <= snap[f"{name}.p99"]
                assert f"# TYPE glt_server_{stage}_ms histogram" in text
        finally:
            loader.shutdown()
            conn.close()
    finally:
        metrics.disable()


def test_serving_is_not_mounted(server):
    """Serving off: the ops answer as glt_tpu's server does; asking for
    serving mounts the front, which serving_stats reports."""
    from glt_tpu_torch.serving import ServingDisabled, ServingOptions

    conn = RemoteServerConnection(server.addr)
    try:
        assert conn.request(op="serving_stats") == {"enabled": False}
        assert conn.request(op="fleet_shed", alert={}) == {
            "ok": False, "enabled": False}
        assert conn.request(op="fleet_hello")["serving"] is False
        send_frame(conn.sock, _KIND_JSON, json.dumps(
            {"op": "subgraph_request", "seeds": [1]}).encode())
        kind, data = recv_frame(conn.sock)
        resp = json.loads(data)
        assert kind == _KIND_JSON and resp["code"] == "serving_disabled"
        with pytest.raises(ServingDisabled):
            conn._raise_structured(resp)
        # the connection still serves after the structured error
        assert conn.request(op="get_dataset_meta")["num_nodes"] == N
    finally:
        conn.close()
    srv = init_server(build_ring(), serving=ServingOptions())
    conn = RemoteServerConnection(srv.addr)
    try:
        st = conn.request(op="serving_stats")
        assert st["enabled"] is True and st["completed"] == 0
        assert conn.request(op="fleet_hello")["serving"] is True
    finally:
        conn.close()
        srv.shutdown()


def test_serving_error_codes_round_trip_as_glt_tpus():
    from glt_tpu.serving import errors as jerr
    from glt_tpu_torch.serving import errors as perr

    assert perr.SERVING_CODES == jerr.SERVING_CODES
    for code in sorted(perr.SERVING_CODES):
        resp = {"error": "x", "code": code, "retry_after_ms": 5.0}
        a, b = perr.error_from_response(resp), jerr.error_from_response(resp)
        assert type(a).__name__ == type(b).__name__
        assert a.code == b.code == code and a.retry_after_ms == 5.0


def test_server_mp_producer_pool():
    """num_workers > 0: the server spawns a worker fleet on its
    dataset's device, streaming over one shm ring."""
    srv = init_server(build_ring(), dataset_builder=build_ring)
    loader = RemoteNeighborLoader(
        srv.addr, [2, 2], np.arange(N), batch_size=6, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(
            num_workers=2, buffer_capacity=4,
            channel_capacity_bytes=1 << 20))
    try:
        prod = next(iter(srv._producers.values()))
        assert prod._mp_producer.options.device == "cpu"
        for _ in range(2):
            seen = []
            for b in loader:
                check_batch(b)
                seen += seeds_of(b)
            assert sorted(seen) == list(range(N))
    finally:
        loader.shutdown()
        srv.shutdown()


def test_server_mp_producer_needs_builder(server):
    with pytest.raises(RuntimeError, match="dataset_builder"):
        RemoteNeighborLoader(
            server.addr, [2], np.arange(N), batch_size=6, device="cpu",
            worker_options=RemoteSamplingWorkerOptions(num_workers=2))


def test_client_prefetch_bounded(server, monkeypatch):
    """A slow trainer holds at most prefetch_size unconsumed messages."""
    from glt_tpu_torch.distributed import dist_client as dc

    made = []
    real_queue = queue.Queue

    def capturing_queue(*a, **kw):
        q = real_queue(*a, **kw)
        made.append(q)
        return q

    monkeypatch.setattr(dc.queue, "Queue", capturing_queue)
    loader = RemoteNeighborLoader(
        server.addr, [2], np.arange(N), batch_size=2, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(prefetch_size=2))
    try:
        it = iter(loader)
        check_batch(next(it))
        buf = made[-1]
        assert buf.maxsize == 2
        deadline = time.monotonic() + 30.0
        while not buf.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert buf.qsize() <= 2
        for b in it:
            check_batch(b)
    finally:
        loader.shutdown()


def test_abandoned_epoch_restarts(server):
    loader = RemoteNeighborLoader(
        server.addr, [2], np.arange(N), batch_size=2, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(prefetch_size=1,
                                                   buffer_capacity=1))
    try:
        it = iter(loader)
        check_batch(next(it))
        it.close()
        seen = []
        for b in loader:
            check_batch(b)
            seen += seeds_of(b)
        assert sorted(seen) == list(range(N))
    finally:
        loader.shutdown()


def test_two_servers_two_clients():
    servers = [init_server(build_ring(), num_servers=2, server_rank=r,
                           num_clients=2) for r in range(2)]
    assert servers[1].context.is_server()
    assert servers[1].context.num_clients() == 2
    assert servers[1].context.worker_name == "_default_server-1"
    halves = [np.arange(0, N // 2), np.arange(N // 2, N)]
    loaders = [RemoteNeighborLoader(s.addr, [2, 2], h, batch_size=4,
                                    device="cpu")
               for s, h in zip(servers, halves)]
    try:
        seen = [[], []]
        iters = [iter(ld) for ld in loaders]
        for _ in range(len(loaders[0])):
            for c, it in enumerate(iters):
                b = next(it)
                check_batch(b)
                seen[c] += seeds_of(b)
        assert sorted(seen[0]) == halves[0].tolist()
        assert sorted(seen[1]) == halves[1].tolist()
    finally:
        for ld in loaders:
            ld.shutdown()
        for s in servers:
            s.shutdown()


def test_remote_mode_through_dist_neighbor_loader(server):
    loader = DistNeighborLoader(
        [2, 2], np.arange(N), batch_size=6, device="cpu",
        worker_options=RemoteSamplingWorkerOptions(server_addr=server.addr))
    try:
        seen = []
        for b in loader:
            check_batch(b)
            seen += seeds_of(b)
        assert sorted(seen) == list(range(N)) and len(loader) == 4
    finally:
        loader.shutdown()
    with pytest.raises(ValueError, match="server_addr"):
        DistNeighborLoader([2], np.arange(N), device="cpu",
                           worker_options=RemoteSamplingWorkerOptions())


def test_old_client_against_traced_server():
    """A client sending no #trace key gets byte-compatible frames: no
    trailer, the payload parses with the plain code path."""
    from glt_tpu_torch import obs
    from glt_tpu_torch.channel import deserialize

    srv = init_server(build_ring())
    obs.start_trace(process_name="server")
    try:
        raw = socket.create_connection(srv.addr, timeout=30)
        raw.settimeout(30)
        try:
            def old_request(**req):
                send_frame(raw, _KIND_JSON, json.dumps(req).encode())
                return recv_frame(raw)

            kind, data = old_request(op="create_sampling_producer",
                                     num_neighbors=[2],
                                     input_nodes=list(range(N)),
                                     batch_size=6)
            pid = json.loads(data)["producer_id"]
            kind, data = old_request(op="start_new_epoch_sampling",
                                     producer_id=pid, epoch=1)
            assert "#trace" not in json.loads(data)
            kind, data = old_request(op="fetch_one_sampled_message",
                                     producer_id=pid, epoch=1, ack=-1)
            assert kind == _KIND_MSG and not data.endswith(b"GLTT")
            assert struct.unpack_from("<Q", data, 0)[0] == 0
            assert "node" in deserialize(memoryview(data)[8:])
            old_request(op="destroy_sampling_producer", producer_id=pid)
        finally:
            raw.close()
    finally:
        obs.install(None)
        srv.shutdown()


def test_flight_dump_and_profile_capture_ops(server, tmp_path):
    from glt_tpu_torch.obs.flight import is_flight_dump, validate_flight_dump

    conn = RemoteServerConnection(server.addr)
    try:
        snap = conn.flight_dump()
        assert is_flight_dump(snap) and validate_flight_dump(snap) == []
        assert snap["reason"] == "wire_op"
        assert "server.flight_dump_served" in [e["kind"]
                                               for e in snap["events"]]
        cap = conn.profile_capture(dir=str(tmp_path / "prof"), millis=5.0)
        assert cap is not None and cap["dir"] == str(tmp_path / "prof")
        assert os.path.exists(os.path.join(cap["dir"], "trace.json"))
    finally:
        conn.close()


def _traced_server_proc(trace_dir, q):
    os.environ["GLT_OBS_TRACE_DIR"] = trace_dir
    from glt_tpu_torch.distributed import init_server as _init

    srv = _init(build_ring())
    q.put(tuple(srv.addr))
    srv.wait_for_exit(timeout=120)
    srv.shutdown()          # exports trace-server-<pid>.json


def test_distributed_trace_merge_end_to_end(tmp_path, monkeypatch):
    """A traced server in its own process: per-process traces that
    ``obs merge`` stitches into one valid trace, the server's spans
    under the client epoch's trace id, every clock aligned."""
    from glt_tpu_torch import obs

    trace_dir = str(tmp_path)
    monkeypatch.setenv("GLT_OBS_TRACE_DIR", trace_dir)
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=_traced_server_proc, args=(trace_dir, q))
    proc.start()
    try:
        addr = q.get(timeout=120)
        loader = RemoteNeighborLoader(addr, [2, 2], np.arange(N),
                                      batch_size=6, device="cpu")
        seen = []
        for b in loader:
            check_batch(b)
            seen += seeds_of(b)
        assert sorted(seen) == list(range(N))
        tracer = obs.current()
        assert tracer is not None
        epoch_tid = next(e for e in tracer.events
                         if e["name"] == "remote.epoch")["args"]["trace_id"]
        loader.shutdown(exit_server=True)
        proc.join(timeout=60)
        assert proc.exitcode == 0
    finally:
        obs.install(None)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
    files = sorted(glob.glob(os.path.join(trace_dir, "trace-*.json")))
    roles = {os.path.basename(f).split("-")[1] for f in files}
    assert {"client", "server"} <= roles
    merged = obs.merge_traces(files)
    assert obs.validate_chrome_trace(merged) == []
    assert merged["glt"]["unaligned_pids"] == []
    names = {}
    for ev in merged["traceEvents"]:
        names.setdefault(ev.get("name"), []).append(ev)
    for span in ("server.fetch", "producer.sample_batch"):
        assert any(e["args"].get("trace_id") == epoch_tid
                   for e in names.get(span, [])), span


def test_with_server_twin_trains_against_a_server():
    """The twin's server build and client loop, in one process: the
    trainer's seeds arrive once an epoch and the losses are finite."""
    from glt_tpu_torch.examples import dist_train_sage_with_server as twin
    from glt_tpu_torch.examples.datasets import synthetic_products

    _, train_idx = synthetic_products(scale=0.0005, device="cpu")
    srv = init_server(twin.build_dataset(0.0005, "cpu"))
    seeds = twin.trainer_seeds(train_idx, 1, 2, 16, max_batches=2)
    assert seeds.tolist() == train_idx[1::2][:32].tolist()
    seen = []
    try:
        hist = twin.train(1, 2, srv.addr, seeds, 2, 16, device="cpu",
                          on_batch=lambda e, b, loss: seen.append(
                              (e, sorted(seeds_of(b)))))
    finally:
        srv.shutdown()
    assert hist["batches"] == 4 and len(hist["losses"]) == 2
    assert np.isfinite(np.concatenate(hist["losses"])).all()
    for epoch in (0, 1):
        got = sorted(s for e, b in seen if e == epoch for s in b)
        assert got == sorted(seeds.tolist())
