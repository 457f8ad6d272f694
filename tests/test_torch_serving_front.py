"""The port's serving front, client and wire ops against ``glt_tpu``'s
(cf. ``tests/test_serving.py``), on the CPU.

* ``ServingOptions`` refuses and accepts what ``glt_tpu``'s does.
* Both packages' ``ServingFront`` serve one serial request list on the
  same ring graph (each micro-batch one request): messages ``==``.
* The front's behaviors run against a gated fake engine in both
  packages: the engine blocks inside ``sample`` until the test releases
  it, so "the dispatcher is busy" is an event the test waits for, never
  a sleep measured against the coalescing window.
* The wire: ``InferenceClient`` end to end against a serving
  ``DistServer``, serving off, concurrent serving and training clients,
  faults and admission over the wire, and one request's kind-2 payload
  read by ``glt_tpu``'s ``deserialize``, equal to ``glt_tpu``'s server's.
"""
import json
import queue
import socket
import threading
import time

import numpy as np
import pytest
import torch

import glt_tpu.serving as jserving
import glt_tpu.testing.faults as jfaults
import glt_tpu_torch.serving as tserving
import glt_tpu_torch.testing.faults as tfaults
from glt_tpu.channel.serialization import deserialize as jax_deserialize
from glt_tpu_torch.distributed import (RemoteNeighborLoader,
                                       RemoteSamplingWorkerOptions,
                                       RemoteServerConnection, init_server)
from glt_tpu_torch.distributed.dist_server import (_KIND_JSON, _KIND_SUB,
                                                   recv_frame, send_frame)
from glt_tpu_torch.serving import (BadRequest, DeadlineExceeded,
                                   InferenceClient, Overloaded,
                                   ServingDisabled, ServingDown, ServingError,
                                   ServingFront, ServingOptions)
from test_serving import build_ring_dataset as jax_ring
from test_serving import check_serving_batch
from test_torch_dist_loader import build_ring

torch.set_num_threads(1)

N = 48
OPTS = dict(num_neighbors=[2, 2], seed_buckets=(4, 8),
            max_seeds_per_request=4, max_batch_requests=8, max_wait_ms=2.0,
            max_inflight=32, default_deadline_ms=60_000.0)
PACKAGES = {"glt_tpu": (jserving, jfaults), "glt_tpu_torch": (tserving,
                                                              tfaults)}


def ring(n=N):
    return build_ring(n, dim=4)


def opts(serving=tserving, **kw):
    return serving.ServingOptions(**dict(OPTS, **kw))


# ---------------------------------------------------------------------------
# ServingOptions
# ---------------------------------------------------------------------------

BAD_OPTIONS = [
    dict(seed_buckets=()), dict(seed_buckets=(0, 8)),
    dict(seed_buckets=(4,), max_seeds_per_request=5),
    dict(max_batch_requests=0), dict(max_inflight=0),
    dict(seed_cache_entries=-1)]


@pytest.mark.parametrize("kw", BAD_OPTIONS, ids=lambda kw: ",".join(kw))
def test_options_refuse_as_glt_tpu(kw):
    with pytest.raises(ValueError) as je:
        jserving.ServingOptions(**kw)
    with pytest.raises(ValueError) as te:
        ServingOptions(**kw)
    assert str(te.value) == str(je.value)


def test_options_defaults_equal_glt_tpus():
    import dataclasses

    j = dataclasses.asdict(jserving.ServingOptions(seed_buckets=(32, 8,
                                                                 128)))
    t = dataclasses.asdict(ServingOptions(seed_buckets=(32, 8, 128)))
    assert t == j and t["seed_buckets"] == (8, 32, 128)


def test_serving_exports_cover_glt_tpus():
    assert set(jserving.__all__) <= set(tserving.__all__)
    assert set(tserving.__all__) - set(jserving.__all__) == {"SERVING_CODES"}
    for name in tserving.__all__:
        assert hasattr(tserving, name), name


# ---------------------------------------------------------------------------
# Both fronts over real engines: one serial request list
# ---------------------------------------------------------------------------

SERIAL = [[5, 7], [30], [1, 2, 3, 4], [47, 0, 47], [9], [40, 41, 42],
          [5, 7], [11, 13, 17, 19]]


def _serve_serially(front, lists):
    out = []
    for seeds in lists:
        p = front.submit(seeds)
        assert p.done.wait(60.0) and p.error is None, p.error
        out.append(p.message)
    return out


def test_fronts_serve_serial_lists_equal():
    jf = jserving.ServingFront(jax_ring(), opts(jserving))
    tf = ServingFront(ring(), opts())
    try:
        jm, tm = _serve_serially(jf, SERIAL), _serve_serially(tf, SERIAL)
        assert tf.stats()["dispatched_batches"] == len(SERIAL)
        # One request a micro-batch: at most 4 seeds, bucket 4 only.
        assert tf.stats()["compiled_buckets"] == jf.stats()[
            "compiled_buckets"] == [4]
    finally:
        jf.stop()
        tf.stop()
    for a, b in zip(jm, tm):
        assert sorted(a) == sorted(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# The front's behaviors against a gated fake engine, in both packages
# ---------------------------------------------------------------------------

class GatedEngine:
    """Duck-typed ``SubgraphEngine`` with no device.  ``sample`` reports
    each micro-batch on ``entered`` and, while the gate is closed, waits
    for one :meth:`release` per call."""

    def __init__(self, buckets=(8,), gated=True):
        self.buckets = tuple(buckets)
        self.batches = []
        self.entered = queue.Queue()
        self._go = threading.Semaphore(0)
        self._open = threading.Event()
        if not gated:
            self._open.set()

    def release(self, n=1):
        for _ in range(n):
            self._go.release()

    def open(self):
        self._open.set()
        self.release(64)

    def wait_entered(self):
        return self.entered.get(timeout=10.0)

    def validate_seeds(self, seeds):
        arr = np.asarray(seeds, np.int64).ravel()
        if arr.size == 0:
            raise BadRequest("empty")
        return arr.astype(np.int32)

    def compiled_buckets(self):
        return []

    def sample(self, seed_lists, bucket=None):
        self.batches.append([s.copy() for s in seed_lists])
        self.entered.put(len(self.batches))
        if not self._open.is_set():
            assert self._go.acquire(timeout=10.0), "the test never released"
        return seed_lists

    def scatter(self, coal):
        return [{
            "node": s.astype(np.int32),
            "row": np.zeros((0,), np.int32),
            "col": np.zeros((0,), np.int32),
            "node_mask": np.ones((s.size,), bool),
            "edge_mask": np.zeros((0,), bool),
            "batch": s.astype(np.int32),
            "#META.batch_size": np.array(s.size, np.int64),
        } for s in coal]


def gated_front(pkg, engine, fault_plan=None, **kw):
    serving, _ = PACKAGES[pkg]
    return serving.ServingFront(None, opts(serving, **kw), engine=engine,
                                fault_plan=fault_plan)


def _wait_all(pendings):
    for p in pendings:
        assert p.done.wait(10.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_coalesces_queued_burst(pkg):
    eng = GatedEngine()
    front = gated_front(pkg, eng, max_wait_ms=5.0, max_batch_requests=8)
    try:
        first = front.submit([0])
        assert eng.wait_entered() == 1      # the dispatcher holds batch 1
        rest = [front.submit([i]) for i in range(1, 5)]
        eng.open()
        _wait_all([first] + rest)
        assert all(p.error is None for p in [first] + rest)
        st = front.stats()
        assert st["completed"] == 5 and st["dispatched_batches"] == 2
        assert [len(b) for b in eng.batches] == [1, 4]
    finally:
        eng.open()
        front.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_bucket_overflow_leads_next_batch(pkg):
    """6 + 4 seeds exceed the one bucket of 8: the second request is
    carried over and leads the next micro-batch.  Both are queued before
    the dispatcher collects, so no wait races the window."""
    eng = GatedEngine(buckets=(8,))
    front = gated_front(pkg, eng, max_wait_ms=20.0)
    try:
        front.submit([0])
        assert eng.wait_entered() == 1
        a = front.submit(list(range(1, 7)))       # 6 seeds
        b = front.submit(list(range(10, 14)))     # 4 more: 10 > 8
        eng.open()
        _wait_all([a, b])
        assert [len(x) for x in eng.batches] == [1, 1, 1]
        assert [x[0].tolist() for x in eng.batches[1:]] == [
            list(range(1, 7)), list(range(10, 14))]
    finally:
        eng.open()
        front.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_overload_rejects_structurally(pkg):
    eng = GatedEngine()
    front = gated_front(pkg, eng, max_inflight=2)
    try:
        front.submit([0])
        assert eng.wait_entered() == 1
        front.submit([1])
        front.submit([2])                  # the queue (maxsize 2) is full
        with pytest.raises(Exception) as ei:
            front.submit([3])
        assert type(ei.value).__name__ == "Overloaded"
        assert ei.value.code == "overloaded"
        assert ei.value.retry_after_ms is not None
        assert ei.value.retry_after_ms > 0
        assert front.stats()["rejected_overload"] == 1
    finally:
        eng.open()
        front.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_deadline_aware_drop(pkg):
    eng = GatedEngine()
    front = gated_front(pkg, eng)
    try:
        a = front.submit([0])
        assert eng.wait_entered() == 1
        b = front.submit([1], deadline_ms=10.0)
        time.sleep(0.05)                   # b's deadline passes in queue
        eng.open()
        _wait_all([a, b])
        assert a.error is None
        assert type(b.error).__name__ == "DeadlineExceeded"
        assert front.stats()["rejected_deadline"] == 1
        assert all(1 not in [s[0] for s in batch] for batch in eng.batches)
    finally:
        eng.open()
        front.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_engine_failure_contained_to_batch(pkg):
    _, faults = PACKAGES[pkg]
    plan = faults.FaultPlan(fail_serving_batch=2)
    eng = GatedEngine(gated=False)
    front = gated_front(pkg, eng, fault_plan=plan)
    try:
        ok1 = front.submit([0])
        assert ok1.done.wait(10.0) and ok1.error is None
        bad = front.submit([1])
        assert bad.done.wait(10.0)
        assert type(bad.error).__name__ == "ServingError"
        assert bad.error.code == "serving_failed"
        ok2 = front.submit([2])
        assert ok2.done.wait(10.0) and ok2.error is None
        assert plan.injected_serving_failures == 1
        assert front.stats()["failed"] == 1
    finally:
        front.stop()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stop_fails_queued_requests(pkg):
    serving, _ = PACKAGES[pkg]
    eng = GatedEngine()
    front = gated_front(pkg, eng)
    front.submit([0])
    assert eng.wait_entered() == 1
    queued = front.submit([1])
    stopper = threading.Thread(target=front.stop)
    stopper.start()
    deadline = time.monotonic() + 10.0
    while not front._stop.is_set():
        assert time.monotonic() < deadline
        time.sleep(0.001)
    eng.open()                         # batch 1 ends; the loop sees stop
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert queued.done.wait(10.0)
    assert isinstance(queued.error, serving.ServingDown)
    with pytest.raises(serving.ServingDown):
        front.submit([2])


def test_shed_admits_only_the_unshed_fraction():
    """A firing alert shrinks admission to (1 - shed_frac) of the queue;
    the resolve reopens it (both packages)."""
    got = {}
    for pkg in sorted(PACKAGES):
        eng = GatedEngine()
        front = gated_front(pkg, eng, max_inflight=4)
        try:
            front.submit([0])
            assert eng.wait_entered() == 1
            front.slo_alert({"slo": "t", "state": "firing",
                             "shed_frac": 0.5})
            ok = [front.submit([1]), front.submit([2])]     # 2 of 4 slots
            with pytest.raises(Exception) as ei:
                front.submit([3])
            assert ei.value.code == "overloaded"
            front.slo_alert({"slo": "t", "state": "resolved"})
            ok.append(front.submit([3]))
            eng.open()
            _wait_all(ok)
            got[pkg] = {k: v for k, v in front.stats().items()
                        if k not in ("ewma_batch_ms",)}
        finally:
            eng.open()
            front.stop()
    assert got["glt_tpu_torch"] == got["glt_tpu"]
    assert got["glt_tpu"]["rejected_shed"] == 1


def test_stats_keys_equal_glt_tpus():
    fronts = [gated_front(pkg, GatedEngine(gated=False))
              for pkg in sorted(PACKAGES)]
    try:
        for f in fronts:
            p = f.submit([3, 4])
            assert p.done.wait(10.0)
        a, b = (f.stats() for f in fronts)
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k != "ewma_batch_ms"} == {
            k: v for k, v in b.items() if k != "ewma_batch_ms"}
    finally:
        for f in fronts:
            f.stop()


# ---------------------------------------------------------------------------
# The wire: InferenceClient against a serving DistServer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_server():
    srv = init_server(ring(), serving=opts())
    srv.serving.engine.warmup()
    yield srv
    srv.shutdown()


def client(addr, timeout=30.0):
    return InferenceClient(addr, timeout=timeout, device="cpu")


def test_subgraph_end_to_end(serving_server):
    cli = client(serving_server.addr)
    try:
        b = cli.subgraph([5, 7])
        assert b.node.device.type == "cpu"
        check_serving_batch(b, [5, 7])
        check_serving_batch(cli.subgraph([30]), [30])
        st = cli.stats()
        assert st["enabled"] is True and st["completed"] >= 2
        assert st["compiled_buckets"] == [4, 8]
    finally:
        cli.close()


def test_client_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceClient(("127.0.0.1", 1))


def test_serving_disabled_is_structured():
    srv = init_server(ring())
    cli = client(srv.addr, timeout=5.0)
    try:
        with pytest.raises(ServingDisabled):
            cli.subgraph([1])
        assert cli.stats() == {"enabled": False}
    finally:
        cli.close()
        srv.shutdown()


def test_concurrent_serving_and_training_clients(serving_server):
    """Serving and training clients drive one server at once; each gets
    exactly its own seeds back, and a vanished client's producer is
    lease-reaped."""
    srv = serving_server
    errors, served, trained = [], {}, {}

    def serve_worker(idx, seeds_pool):
        try:
            cli = client(srv.addr)
            got = []
            for s in seeds_pool:
                b = cli.subgraph([s])
                check_serving_batch(b, [s])
                got.append(int(b.batch[0]))
            served[idx] = got
            cli.close()
        except Exception as e:  # noqa: BLE001 — surfaced by the join
            errors.append(e)

    def train_worker(idx, lo, hi):
        try:
            loader = RemoteNeighborLoader(
                srv.addr, [2, 2], np.arange(lo, hi), batch_size=6,
                worker_options=RemoteSamplingWorkerOptions(
                    rpc_timeout=60.0), device="cpu")
            seen = []
            for _ in range(2):
                for batch in loader:
                    seen.append(sorted(
                        batch.batch[:batch.batch_size].tolist()))
            trained[idx] = seen
            loader.shutdown()
        except Exception as e:  # noqa: BLE001 — surfaced by the join
            errors.append(e)

    threads = [
        threading.Thread(target=serve_worker, args=(0, range(0, 10))),
        threading.Thread(target=serve_worker, args=(1, range(20, 30))),
        threading.Thread(target=serve_worker, args=(2, range(40, 48))),
        threading.Thread(target=train_worker, args=(0, 0, 24)),
        threading.Thread(target=train_worker, args=(1, 24, 48)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert errors == []
    assert served == {0: list(range(0, 10)), 1: list(range(20, 30)),
                      2: list(range(40, 48))}
    for idx, (lo, hi) in ((0, (0, 24)), (1, (24, 48))):
        flat = sorted(s for ep in trained[idx] for s in ep)
        assert flat == sorted(list(range(lo, hi)) * 2)

    conn = RemoteServerConnection(srv.addr, timeout=10.0)
    before = srv.live_producers()
    conn.request(op="create_sampling_producer", num_neighbors=[2],
                 input_nodes=list(range(12)), batch_size=6,
                 lease_secs=0.4, client_key="doomed-client")
    assert srv.live_producers() == before + 1
    conn.close()
    deadline = time.monotonic() + 10.0
    while srv.live_producers() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert srv.live_producers() == before


def _sub_payload(addr, seeds):
    """One raw ``subgraph_request``: the kind-2 frame's payload."""
    sock = socket.create_connection(tuple(addr), timeout=60)
    try:
        send_frame(sock, _KIND_JSON, json.dumps(
            {"op": "subgraph_request", "seeds": seeds,
             "deadline_ms": 60_000}).encode())
        kind, data = recv_frame(sock)
    finally:
        sock.close()
    assert kind == _KIND_SUB, bytes(data[:200])
    return bytes(data)


def test_sub_payload_reads_as_glt_tpus():
    """The same first request on a fresh server of each package: the
    port's kind-2 payload is ``glt_tpu``'s bytes, and ``glt_tpu``'s
    ``deserialize`` reads it as ``glt_tpu``'s arrays."""
    from glt_tpu.distributed import init_server as jax_init_server

    jsrv = jax_init_server(jax_ring(), serving=opts(jserving))
    tsrv = init_server(ring(), serving=opts())
    try:
        for seeds in ([5, 7, 9], [44]):
            jp, tp = _sub_payload(jsrv.addr, seeds), _sub_payload(
                tsrv.addr, seeds)
            jm, tm = jax_deserialize(jp), jax_deserialize(tp)
            assert sorted(jm) == sorted(tm)
            for k in jm:
                a, b = np.asarray(jm[k]), np.asarray(tm[k])
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            assert tp == jp
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_chaos_mid_coalesce_disconnect(serving_server):
    """A client that vanishes after submitting costs its co-rider
    nothing: one micro-batch serves both, the live client's answer is
    right, and the server keeps serving."""
    srv = serving_server
    front = srv.serving
    old_wait = front.options.max_wait_ms
    front.options.max_wait_ms = 1000.0     # hold the batch for the rider
    try:
        before = front.stats()
        raw = socket.create_connection(srv.addr, timeout=10)
        send_frame(raw, _KIND_JSON, json.dumps(
            {"op": "subgraph_request", "seeds": [3],
             "deadline_ms": 60_000}).encode())
        raw.close()
        cli = client(srv.addr)
        try:
            check_serving_batch(cli.subgraph([20]), [20])
            deadline = time.monotonic() + 5.0
            while (front.stats()["completed"] < before["completed"] + 2
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            after = front.stats()
            assert after["completed"] == before["completed"] + 2
            assert (after["dispatched_batches"]
                    == before["dispatched_batches"] + 1)
            check_serving_batch(cli.subgraph([10]), [10])
        finally:
            cli.close()
    finally:
        front.options.max_wait_ms = old_wait


def test_chaos_engine_failure_under_load():
    """A fault in one micro-batch under concurrent load fails exactly
    that batch's requests, structurally; the rest are served."""
    plan = tfaults.FaultPlan(fail_serving_batch=2)
    srv = init_server(ring(), fault_plan=plan,
                      serving=opts(max_wait_ms=150.0))
    try:
        warm = client(srv.addr, timeout=60.0)
        check_serving_batch(warm.subgraph([0]), [0])
        results, failures = [], []

        def worker(seed):
            cli = client(srv.addr, timeout=60.0)
            try:
                check_serving_batch(cli.subgraph([seed]), [seed])
                results.append(seed)
            except ServingError as e:
                failures.append((seed, e.code))
            finally:
                cli.close()

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in (8, 16, 24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert plan.injected_serving_failures == 1
        assert len(failures) >= 1
        assert all(code == "serving_failed" for _, code in failures)
        assert len(results) + len(failures) == 3
        assert srv.serving.stats()["failed"] == len(failures)
        check_serving_batch(warm.subgraph([30]), [30])
        warm.close()
    finally:
        srv.shutdown()


def test_overload_and_deadline_over_wire():
    """Overloaded (with its hint) and a deadline drop cross the wire as
    typed errors; the retry loop lands once the engine frees up."""
    srv = init_server(ring(), serving=opts(max_inflight=1, max_wait_ms=1.0))
    eng = GatedEngine()
    srv.serving.engine = eng
    outcomes = queue.Queue()

    def fire(seed, timeout=30.0):
        cli = client(srv.addr, timeout=timeout)
        try:
            cli.subgraph([seed], timeout=timeout)
            outcomes.put((seed, "ok"))
        except ServingError as e:
            outcomes.put((seed, e.code, e.retry_after_ms))
        finally:
            cli.close()

    try:
        t1 = threading.Thread(target=fire, args=(0,))
        t1.start()
        assert eng.wait_entered() == 1         # the engine holds seed 0
        t2 = threading.Thread(target=fire, args=(1,))
        t2.start()
        deadline = time.monotonic() + 10.0
        while srv.serving.stats()["inflight"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        fire(2)                                 # the queue (1) is full
        assert outcomes.get(timeout=10)[:2] == (2, "overloaded")
        # A deadline that passes while the queue waits on the engine.
        cli = client(srv.addr)
        t3 = threading.Thread(target=lambda: outcomes.put(
            ("late", type(_catch(lambda: cli.subgraph([4], timeout=0.05)))
             .__name__)))
        eng.release()                           # seed 0 done; 1 enters
        assert eng.wait_entered() == 2
        t3.start()
        while srv.serving.stats()["inflight"] < 1:
            assert time.monotonic() < deadline + 10.0
            time.sleep(0.005)
        time.sleep(0.08)                        # seed 4's 50 ms pass
        eng.open()
        for t in (t1, t2, t3):
            t.join(timeout=30)
            assert not t.is_alive()
        got = {}
        while not outcomes.empty():
            item = outcomes.get_nowait()
            got[item[0]] = item[1:]
        assert got[0] == ("ok",) and got[1] == ("ok",)
        assert got["late"] == ("DeadlineExceeded",)
        b = cli.subgraph_with_retry([5], timeout=30.0, attempts=10)
        assert b.batch.tolist() == [5]
        cli.close()
        st = srv.serving.stats()
        assert st["rejected_overload"] >= 1 and st["rejected_deadline"] >= 1
    finally:
        eng.open()
        srv.shutdown()


def _catch(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — returned to the caller
        return e
    return None


def test_per_op_timeout_restores_default(serving_server):
    conn = RemoteServerConnection(serving_server.addr, timeout=60.0)
    try:
        assert conn.request(op="serving_stats",
                            _timeout=5.0)["enabled"] is True
        assert conn.sock.gettimeout() == 60.0
        assert conn.request(op="get_dataset_meta")["num_nodes"] == N
    finally:
        conn.close()


def test_serving_metrics_namespace(serving_server):
    from glt_tpu_torch.obs import metrics

    metrics.enable()
    try:
        before = metrics.snapshot()
        cli = client(serving_server.addr)
        for s in (2, 12, 22):
            cli.subgraph([s])
        cli.close()
        snap = metrics.snapshot()

        def delta(name):
            return snap.get(name, 0.0) - before.get(name, 0.0)

        for stage in ("queue_wait_ms", "batch_ms", "scatter_ms",
                      "e2e_ms", "client_ms"):
            assert delta(f"glt.serving.{stage}.count") >= 3, stage
        assert delta("glt.serving.coalesce_width.count") >= 1
        assert delta("glt.serving.requests") >= 3
        assert snap["glt.serving.e2e_ms.p50"] <= snap[
            "glt.serving.e2e_ms.p99"]
        text = serving_server.metrics_text()
        assert "glt_serving_e2e_ms_bucket" in text
        assert "glt_serving_requests_total" in text
    finally:
        metrics.disable()


def test_subgraph_with_retry_budget():
    """A retry budget smaller than the server's hint ends in a
    ``DeadlineExceeded`` chained from the last ``Overloaded``."""
    srv = init_server(ring(), serving=opts(max_inflight=1))
    eng = GatedEngine()
    srv.serving.engine = eng
    def hold(seed):
        cli = client(srv.addr)
        _catch(lambda: cli.subgraph([seed]))
        cli.close()

    holders = [threading.Thread(target=hold, args=(s,)) for s in (0, 1)]
    try:
        holders[0].start()
        assert eng.wait_entered() == 1
        holders[1].start()
        deadline = time.monotonic() + 10.0
        while srv.serving.stats()["inflight"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        cli = client(srv.addr)
        with pytest.raises(DeadlineExceeded) as ei:
            cli.subgraph_with_retry([2], attempts=50, deadline_ms=150.0)
        assert isinstance(ei.value.__cause__, Overloaded)
        cli.close()
    finally:
        eng.open()
        for t in holders:
            t.join(timeout=30)
        srv.shutdown()
