"""Sampling server: owns the dataset, produces batches for remote
clients (cf. ``glt_tpu/distributed/dist_server.py``; the same protocol,
ops and codes, so a port client reads a ``glt_tpu`` server and back).

Clients ``create_sampling_producer``, ``start_new_epoch_sampling``,
``fetch_one_sampled_message`` and ``destroy_sampling_producer`` over a
small length-prefixed TCP protocol: JSON control frames and serialized
sample frames (:mod:`glt_tpu_torch.channel.serialization`).

Protocol (all frames ``u32 kind | u64 len | payload``):
  kind 0: JSON control request/response
  kind 1: ``u64 seq`` + serialized SampleMessage
  kind 2: one serialized per-request serving SampleMessage

Each producer samples on the server dataset's device: an in-server
thread over a :class:`~glt_tpu_torch.loader.NeighborLoader`
(``num_workers=0``), or a fleet of spawned workers on that device
feeding a shm ring (``num_workers > 0``).  On the card that is the
port's kernels (B1 and the hash kernel in the sampler, B2 for the
feature gather), one CUDA context a process.

Fault tolerance:

* **ack-based resume**: every sampled message carries a per-producer,
  per-epoch monotonic sequence number; the server keeps sent-but-unacked
  messages in a small replay window, so a client that reconnects after a
  dropped socket re-fetches exactly the batches it never received
  (``fetch_one_sampled_message`` carries ``ack``, the highest seq the
  client has contiguously received).
* **producer leases**: any request naming a producer renews its lease;
  a reaper thread collects producers whose lease expired (mp fleet and
  shm ring included), so a client that crashes without a destroy leaks
  nothing.
* **structured errors**: recoverable request failures are JSON
  ``{"error": ..., "code": ...}`` responses on a still-usable
  connection; only a desynced stream closes the session.

``init_server(serving=ServingOptions(...))`` mounts the inference
serving front (:mod:`glt_tpu_torch.serving`) on the same protocol: the
``subgraph_request`` op answers with a kind-2 frame, ``serving_stats``
and the fleet ops with JSON.  Without it, ``subgraph_request`` answers
``serving_disabled`` and ``fleet_shed`` / ``serving_stats`` answer
``enabled: False``.
"""
from __future__ import annotations

import collections
import json
import queue
import socket
import struct
import threading
import time
from typing import Deque, Dict, Optional, Tuple

import numpy as np

from ..channel.base import QueueSourceDied, bounded_get, bounded_put
from ..channel.serialization import serialize
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs import propagate as _prop
from ..obs.trace import auto_trace, auto_trace_export
from ..obs.trace import current as _current_tracer
from ..obs.trace import span as _span
from ..testing.faults import FaultPlan, ProducerKilled

# Server metrics (glt.server.*): the window into the fault-tolerance
# machinery (seqs, replays, leases).  Counters move only while
# ``obs.metrics`` is enabled; the ``get_metrics`` op serves the
# Prometheus text exposition either way.
_M_MESSAGES = _metrics.counter(
    "glt.server.messages_sent", "sampled message frames sent")
_M_REPLAYS = _metrics.counter(
    "glt.server.replays", "unacked messages resent from the replay window")
_M_REAPED = _metrics.counter(
    "glt.server.producers_reaped", "producers GC'd by lease expiry")
_M_CREATED = _metrics.counter(
    "glt.server.producers_created", "sampling producers created")
_M_ERRORS = _metrics.counter(
    "glt.server.request_errors", "structured per-request failures")

# Per-request latency decomposition: where a fetch's wall time goes,
# server-side.  snapshot() derives p50/p95/p99 per stage.
_H_QUEUE_WAIT = _metrics.histogram(
    "glt.server.queue_wait_ms",
    "fetch blocked waiting for the producer buffer (queue wait)")
_H_SAMPLE = _metrics.histogram(
    "glt.server.sample_ms", "producer-side sampling wall per batch")
_H_SERIALIZE = _metrics.histogram(
    "glt.server.serialize_ms",
    "batch flatten+serialize wall per message")
_H_SEND = _metrics.histogram(
    "glt.server.send_ms", "sampled-frame socket send wall")
_H_REPLAY = _metrics.histogram(
    "glt.server.replay_ms",
    "replay-served fetches: window lookup + resend wall")

_KIND_JSON = 0
_KIND_MSG = 1
# Serving responses: one serialized per-request SampleMessage, no
# sequence number (subgraph requests are stateless).
_KIND_SUB = 2

# Reject frames above this many payload bytes unless configured otherwise:
# a corrupt (or hostile) u64 length must fail the frame, not drive an
# unbounded allocation.
DEFAULT_MAX_FRAME_BYTES = 1 << 30

DEFAULT_LEASE_SECS = 300.0
DEFAULT_REPLAY_WINDOW = 8

# Ops that only a current-protocol server understands: an older server
# answers each of them with its unknown-op fatal error, so every client
# call site must degrade (return None, or pin the peer to legacy
# routing) instead of surfacing a new failure mode.  ``fleet_hello`` is
# the negotiation itself; the observability pulls shipped after the
# protocol froze ride the same contract.  gltlint reads this set to
# assign per-op minimum protocol versions (GLT026, ``--format=optable``).
POST_HELLO_OPS = frozenset({
    "fleet_hello",
    "fleet_shed",
    "flight_dump",
    "profile_capture",
})


class ProtocolError(RuntimeError):
    """The framed byte stream is invalid (bad length, truncated header)."""


class RequestError(RuntimeError):
    """A structured, per-request failure: reported to the client as
    ``{"error": ..., "code": ...}`` without closing the connection, so the
    client can distinguish e.g. a GC'd producer lease (``unknown_producer``)
    from a crashed server.  ``extra`` keys ride alongside in the error
    response (the serving path's ``retry_after_ms`` backoff hint)."""

    def __init__(self, message: str, code: str, **extra):
        super().__init__(message)
        self.code = code
        self.extra = dict(extra)


def send_frame(sock, kind: int, payload: bytes) -> None:
    sock.sendall(struct.pack("<IQ", kind, len(payload)) + payload)


def recv_frame(sock, max_len: int = DEFAULT_MAX_FRAME_BYTES):
    hdr = _recv_exact(sock, 12)
    if hdr is None:
        return None, None
    kind, length = struct.unpack("<IQ", hdr)
    if length > max_len:
        raise ProtocolError(
            f"frame length {length} exceeds the {max_len}-byte bound "
            f"(corrupt stream or hostile peer)")
    data = _recv_exact(sock, length)
    return kind, data


def _recv_exact(sock, n: int) -> Optional[bytearray]:
    """``n`` bytes from ``sock`` (None at EOF), received into one
    preallocated buffer: a products-scale sample frame is ~99 MB, and
    growing a bytes object chunk by chunk copies it quadratically."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class _Producer:
    """Server-side sampling producer filling a bounded buffer
    (the reference's producer and shm buffer pair).

    Two backends, chosen by ``num_workers``:
      * 0 — one in-server thread driving a collocated NeighborLoader;
      * >0 — an :class:`MpSamplingProducer` worker fleet feeding a shm
        ring (the reference's mp producer pool on the server), drained
        into the bounded buffer by a
        forwarder thread.  Requires the server's picklable
        ``dataset_builder``.

    Delivery bookkeeping: buffer items are ``(epoch, payload)`` pairs;
    ``fetch_next`` assigns each fresh payload a monotonic per-epoch seq,
    retains the last ``replay_window`` sent-but-unacked payloads for
    resume-after-reconnect, and re-homes items popped by a stale (dead-
    connection) reader thread so no batch is ever lost to a race.
    """

    def __init__(self, dataset, num_neighbors, input_nodes, batch_size,
                 buffer_capacity: int = 8, seed: int = 0,
                 num_workers: int = 0, dataset_builder=None,
                 builder_args: tuple = (),
                 channel_capacity_bytes: int = 64 * 1024 * 1024,
                 lease_secs: float = DEFAULT_LEASE_SECS,
                 replay_window: int = DEFAULT_REPLAY_WINDOW,
                 fault_plan: Optional[FaultPlan] = None):
        self.buffer: "queue.Queue" = queue.Queue(maxsize=buffer_capacity)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._mp_producer = None
        self._channel = None
        self._fault_plan = fault_plan
        # -- lease -----------------------------------------------------
        self.lease_secs = float(lease_secs)
        self.last_active = time.monotonic()
        # -- sequencing / replay --------------------------------------
        self.replay_window = max(1, int(replay_window))
        self._seq_lock = threading.Lock()
        self._epoch = 0
        self._next_seq = 0
        self._retained: Deque[Tuple[int, bytes]] = collections.deque()
        self._orphans: list = []
        self._error: Optional[Exception] = None
        # Wire context of the epoch's start request: producer spans (and
        # the mp workers, via the task payload) join this trace.
        self._trace_ctx: Optional[dict] = None
        if num_workers > 0:
            if dataset_builder is None:
                raise ValueError(
                    "num_workers > 0 needs the server started with a "
                    "picklable dataset_builder (init_server(..., "
                    "dataset_builder=...))")
            from ..channel import ShmChannel
            from .dist_options import MpSamplingWorkerOptions
            from .dist_sampling_producer import MpSamplingProducer

            self._channel = ShmChannel(
                capacity_bytes=channel_capacity_bytes)
            # The workers sample where the server's dataset lives.
            self._mp_producer = MpSamplingProducer(
                dataset_builder, builder_args, list(num_neighbors),
                np.asarray(input_nodes, np.int64), int(batch_size),
                MpSamplingWorkerOptions(
                    num_workers=num_workers,
                    device=str(getattr(dataset, "device", "cuda"))),
                self._channel, shuffle=True, seed=seed)
            self._mp_producer.init()
            nbatches = self._mp_producer.num_expected()
        else:
            from ..loader.node_loader import NeighborLoader

            self.loader = NeighborLoader(dataset, num_neighbors,
                                         input_nodes, batch_size=batch_size,
                                         shuffle=True, seed=seed)
            nbatches = len(self.loader)
        self._num_expected = nbatches

    def num_expected(self) -> int:
        return self._num_expected

    # -- lease --------------------------------------------------------
    def touch(self) -> None:
        self.last_active = time.monotonic()

    def lease_expired(self, now: float) -> bool:
        return (self.lease_secs > 0
                and now - self.last_active > self.lease_secs)

    def start_epoch(self, epoch: int = 0,
                    trace_ctx: Optional[dict] = None) -> None:
        if self._thread is not None:
            # Tell the previous epoch's thread to stop before joining: a
            # client that abandoned its epoch mid-way (early stopping)
            # leaves the thread wedged on the bounded buffer, and without
            # the stop signal this join would block 60s and then poison
            # the producer.
            self._stop.set()
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RequestError("previous epoch still producing",
                                   code="epoch_busy")
        self._stop.clear()
        # Drop anything a previous epoch left behind (in particular a
        # relayed error the client never fetched) so it cannot poison
        # this epoch's first fetch.
        while True:
            try:
                self.buffer.get_nowait()
            except queue.Empty:
                break
        with self._seq_lock:
            self._epoch = int(epoch)
            self._next_seq = 0
            self._retained.clear()
            self._orphans.clear()
            self._error = None
            self._trace_ctx = trace_ctx
        if self._mp_producer is not None:
            self._mp_producer.produce_all(trace_ctx=trace_ctx)
            self._thread = threading.Thread(target=self._forward_mp,
                                            args=(int(epoch),), daemon=True)
        else:
            self._thread = threading.Thread(target=self._run,
                                            args=(int(epoch),), daemon=True)
        self._thread.start()

    def _run(self, epoch: int) -> None:
        from .sample_message import batch_to_message

        ctx = self._trace_ctx or {}
        # Loader failures are relayed to the fetching client (same
        # contract as _forward_mp) instead of dying silently here.
        try:
            batches = iter(self.loader)
            for i in range(self._num_expected):
                with _span("producer.sample_batch", epoch=epoch,
                           index=i) as sp:
                    sp.link(ctx.get("tid"), ctx.get("sid"))
                    t0 = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                    _H_SAMPLE.observe((time.perf_counter() - t0) * 1e3)
                    with _H_SERIALIZE.time():
                        payload = serialize(batch_to_message(batch))
                # stop-aware put so a producer whose client vanished
                # mid-epoch exits instead of wedging on the bounded buffer
                # (and permanently poisoning this producer id).
                if not bounded_put(self.buffer, (epoch, payload),
                                   self._stop):
                    return
                if self._fault_plan is not None:
                    self._fault_plan.on_producer_put()
        except ProducerKilled:
            # Simulated crash (testing.faults): die exactly like an
            # unexpected thread death — no relay, no cleanup; the fetch
            # path's liveness recheck is what must surface this.
            return
        except Exception as e:  # noqa: BLE001 — relayed to client
            bounded_put(self.buffer, (epoch, e), self._stop)

    def _forward_mp(self, epoch: int) -> None:
        # iter_messages raises after max_respawns of fruitless worker
        # deaths; relay that to the fetching client instead of discarding
        # it in this daemon thread (which would hang the client forever).
        try:
            for msg in self._mp_producer.iter_messages():
                with _H_SERIALIZE.time():
                    payload = serialize(msg)
                if not bounded_put(self.buffer, (epoch, payload),
                                   self._stop):
                    return
        except Exception as e:  # noqa: BLE001 — relayed to client
            bounded_put(self.buffer, (epoch, e), self._stop)

    # -- sequenced fetch ----------------------------------------------
    def _epoch_alive(self) -> bool:
        t = self._thread
        return (t is not None and t.is_alive()
                and not self._stop.is_set())

    def _check_epoch(self, epoch: int) -> None:
        if epoch != self._epoch:
            raise RequestError(
                f"fetch for epoch {epoch} but producer is on epoch "
                f"{self._epoch}", code="stale_epoch")

    def _pop_current(self, epoch: int):
        """Pop the next item produced *for this epoch*: orphans first
        (items a dead connection's reader popped but could not deliver),
        then the buffer; items left over from an older epoch are dropped."""
        t_wait0 = time.perf_counter()
        while True:
            with self._seq_lock:
                self._check_epoch(epoch)
                if self._orphans:
                    _H_QUEUE_WAIT.observe(
                        (time.perf_counter() - t_wait0) * 1e3)
                    return self._orphans.pop(0)
            # Bounded wait with a liveness recheck:
            # if the epoch thread died between its last put and our get,
            # the client gets an error, not a blocked connection thread.
            # Each poll also renews the lease — a client waiting on a slow
            # batch is an active client.
            item_epoch, item = bounded_get(
                self.buffer, alive=self._epoch_alive, poll=0.25,
                on_wait=self.touch)
            with self._seq_lock:
                if item_epoch != self._epoch:
                    continue       # stale leftover from an older epoch
                if epoch != self._epoch:
                    # We are the stale reader: the epoch rolled while we
                    # were blocked.  Re-home the item for the live epoch.
                    self._orphans.append(item)
                    self._check_epoch(epoch)
            _H_QUEUE_WAIT.observe((time.perf_counter() - t_wait0) * 1e3)
            return item

    def fetch_next(self, ack: int, epoch: int) -> Tuple[int, bytes, bool]:
        """Return ``(seq, payload, replayed)`` — the resumable fetch.

        ``ack`` is the highest seq the client has contiguously received:
        everything at or below it is released from the replay window; the
        oldest retained seq above it (a message lost in flight on a dead
        connection) is re-sent before anything fresh is produced
        (``replayed=True``), so every batch of an epoch is delivered
        exactly once across arbitrarily many reconnects.
        """
        self.touch()
        with self._seq_lock:
            self._check_epoch(epoch)
            if self._error is not None:
                # Sticky: a sampling failure survives response loss and
                # reconnects until the next epoch resets it.
                raise RequestError(
                    f"server-side sampling failed: {self._error}",
                    code="sampling_failed")
            while self._retained and self._retained[0][0] <= ack:
                self._retained.popleft()
            resend = self._retained[0] if self._retained else None
        if resend is not None:
            # Sent but never received: resume from the oldest gap.
            _M_REPLAYS.inc()
            _flight.record("server.replay", msg_seq=resend[0],
                           epoch=epoch)
            tracer = _current_tracer()
            if tracer is not None:
                ctx = self._trace_ctx or {}
                tracer.instant("server.replay", seq=resend[0],
                               epoch=epoch, trace_id=ctx.get("tid"))
            return resend[0], resend[1], True
        try:
            item = self._pop_current(epoch)
        except QueueSourceDied:
            raise RequestError(
                "producer sampling thread died mid-epoch (or was stopped) "
                "before delivering every batch; restart the epoch",
                code="producer_dead") from None
        if isinstance(item, Exception):
            with self._seq_lock:
                self._error = item
            raise RequestError(f"server-side sampling failed: {item}",
                               code="sampling_failed")
        with self._seq_lock:
            if epoch != self._epoch:
                self._orphans.append(item)
                self._check_epoch(epoch)
            seq = self._next_seq
            self._next_seq += 1
            self._retained.append((seq, item))
            while len(self._retained) > self.replay_window:
                self._retained.popleft()
        return seq, item, False

    def stop(self) -> None:
        self._stop.set()
        if self._mp_producer is not None:
            # Order matters: shutdown() first sets the producer's stopping
            # flag so a forwarder blocked in channel.recv exits at its next
            # timeout, THEN the thread is joined, and the shm segment is
            # only unlinked once the forwarder is provably out of recv —
            # closing under its feet would be a native use-after-free.
            self._mp_producer.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._mp_producer is not None:
            if self._thread is None or not self._thread.is_alive():
                self._channel.close()
            # else: leak the segment rather than unmap it under a live
            # reader; the process exiting reclaims it.


class DistServer:
    """Args mirror :func:`init_server`."""

    def __init__(self, dataset, host: str = "127.0.0.1", port: int = 0,
                 dataset_builder=None, builder_args: tuple = (),
                 num_servers: int = 1, server_rank: int = 0,
                 num_clients: int = 0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 reap_interval: float = 0.25,
                 fault_plan: Optional[FaultPlan] = None,
                 enable_metrics: bool = False,
                 heartbeat_deadline: float = 10.0,
                 serving=None):
        from .dist_context import _set_default, make_server_context
        from .supervisor import Supervisor

        if enable_metrics:
            # Serving deployments opt in: flips the PROCESS-wide metrics
            # switch so the get_metrics exposition carries live counters.
            _metrics.enable()
        # GLT_OBS_TRACE_DIR: this process exports its own trace file at
        # shutdown; `python -m glt_tpu_torch.obs merge` stitches it with
        # the client's and the workers' into one fleet trace.
        self._trace_export_path = auto_trace("server")

        self.dataset = dataset
        self._dataset_builder = dataset_builder
        self._builder_args = builder_args
        self.max_frame_bytes = int(max_frame_bytes)
        self._reap_interval = float(reap_interval)
        self._fault_plan = fault_plan
        # The server's own topology record; installed as the process
        # context only when none exists (several roles can share one
        # process in the single-host test topology — call
        # init_server_context explicitly to claim the global).
        self.context = make_server_context(num_servers, server_rank,
                                           num_clients)
        _set_default(self.context)
        # Fleet supervision: clients and trainers report liveness via the
        # `heartbeat` op on this same control channel; `fleet_health`
        # serves the structured table.  Monitoring starts lazily with
        # the first beat.
        self.supervisor = Supervisor(deadline_secs=heartbeat_deadline)
        # The inference serving front, opt-in: its dispatcher thread
        # drives the engine on the dataset's device.
        self.serving = None
        if serving is not None:
            from ..serving.front import ServingFront

            self.serving = ServingFront(dataset, serving,
                                        fault_plan=fault_plan)
        self._producers: Dict[int, _Producer] = {}
        # Live accepted sockets, tracked so kill() can sever them
        # abruptly (chaos testing: clients must see a raw transport
        # error, never a polite structured goodbye).
        self._live_conns: set = set()
        self._conns_lock = threading.Lock()
        # client_key -> producer id: a client that reconnects and
        # re-creates (its lease expired, or it restarted) first tears
        # down its previous producer instead of leaking it.
        self._client_keys: Dict[str, int] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.addr = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        # Lease reaper: GCs producers whose client vanished without a
        # destroy (crash, network partition) — mp fleet + shm included.
        self._reaper_thread = threading.Thread(target=self._reap_loop,
                                               daemon=True)
        self._reaper_thread.start()

    # -- producer bookkeeping ---------------------------------------------
    def _get_producer(self, req: dict) -> _Producer:
        pid = req.get("producer_id")
        with self._lock:
            prod = self._producers.get(pid)
        if prod is None:
            raise RequestError(
                f"unknown or expired producer id {pid!r} (lease GC'd, "
                f"destroyed, or never created on this server)",
                code="unknown_producer")
        prod.touch()
        return prod

    def _reap_loop(self) -> None:
        while not self._stop.wait(self._reap_interval):
            now = time.monotonic()
            expired = []
            with self._lock:
                for pid in [p for p, prod in self._producers.items()
                            if prod.lease_expired(now)]:
                    expired.append((pid, self._producers.pop(pid)))
                for pid, _ in expired:
                    for ck in [k for k, v in self._client_keys.items()
                               if v == pid]:
                        del self._client_keys[ck]
            for _, prod in expired:
                prod.stop()
            if expired:
                _M_REAPED.inc(len(expired))
                _flight.record("server.producers_reaped",
                               producer_ids=[pid for pid, _ in expired])

    def live_producers(self) -> int:
        with self._lock:
            return len(self._producers)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole ``glt.*`` namespace.

        Point-in-time gauges (live producer count) are refreshed here so
        a scrape always sees current occupancy; served to clients by the
        ``get_metrics`` op.
        """
        _metrics.gauge("glt.server.live_producers",
                       "producers currently registered"
                       ).set(self.live_producers())
        return _metrics.render_prometheus()

    # -- request handlers ------------------------------------------------
    def _handle(self, req: dict, trace_ctx: Optional[dict] = None):
        op = req["op"]
        # Sent by operator tooling and the tests, not by any client of
        # the package.
        # gltlint: disable-next=unmatched-wire-op
        if op == "get_dataset_meta":
            g = self.dataset.get_graph()
            return {"num_nodes": g.num_nodes, "num_edges": g.num_edges,
                    "server_rank": self.context.rank,
                    "num_servers": self.context.world_size}
        if op == "create_sampling_producer":
            # Construct outside the lock: mp-producer setup (process spawn
            # + dataset rebuild) can take seconds and must not stall other
            # clients' create/destroy requests.
            prod = _Producer(
                self.dataset, req["num_neighbors"],
                np.asarray(req["input_nodes"], np.int64),
                req["batch_size"],
                buffer_capacity=req.get("buffer_capacity", 8),
                seed=req.get("seed", 0),
                num_workers=req.get("num_workers", 0),
                dataset_builder=self._dataset_builder,
                builder_args=self._builder_args,
                channel_capacity_bytes=req.get(
                    "channel_capacity_bytes", 64 * 1024 * 1024),
                lease_secs=req.get("lease_secs", DEFAULT_LEASE_SECS),
                replay_window=req.get("replay_window",
                                      DEFAULT_REPLAY_WINDOW),
                fault_plan=self._fault_plan)
            client_key = req.get("client_key")
            stale = None
            with self._lock:
                pid = self._next_id
                self._next_id += 1
                self._producers[pid] = prod
                if client_key:
                    old = self._client_keys.get(client_key)
                    if old is not None:
                        stale = self._producers.pop(old, None)
                    self._client_keys[client_key] = pid
            if stale is not None:
                # Same client re-created (reconnect after lease GC raced,
                # or a restart): its previous fleet must not leak.
                stale.stop()
            _M_CREATED.inc()
            _flight.record("server.producer_created", producer_id=pid,
                           num_workers=req.get("num_workers", 0))
            return {"producer_id": pid,
                    "num_expected": prod.num_expected()}
        if op == "heartbeat":
            # A fleet role reporting liveness (supervisor.HeartbeatSender).
            # Also renews the peer's producer lease when it names one: a
            # heartbeating client is an active client even between
            # fetches (long eval pauses, slow trainers).
            self.supervisor.beat(str(req.get("peer", "client")),
                                 step=req.get("step"))
            pid = req.get("producer_id")
            if pid is not None:
                with self._lock:
                    prod = self._producers.get(pid)
                if prod is not None:
                    prod.touch()
            return {"ok": True}
        if op == "fleet_health":
            return {"peers": self.supervisor.status(),
                    "live_producers": self.live_producers()}
        if op == "fleet_hello":
            # Router/controller handshake: the replica's protocol number
            # and whether serving is mounted; the caller is beaten into
            # the supervisor, so fleet_health shows it as a peer.
            peer = str(req.get("peer", "router"))
            self.supervisor.beat(peer)
            return {"ok": True, "protocol": 1,
                    "serving": self.serving is not None,
                    "stale_after_s": self.supervisor.deadline_secs}
        if op == "fleet_shed":
            # A fleet-wide shed/reopen broadcast: the alert dict a local
            # SloMonitor would deliver.
            if self.serving is None:
                return {"ok": False, "enabled": False}
            self.serving.slo_alert(dict(req.get("alert") or {}))
            return {"ok": True, "enabled": True,
                    "shed_frac": self.serving.stats()["shed_frac"]}
        if op == "serving_stats":
            # enabled=False when serving is off, so a probe never needs
            # to catch an error.
            if self.serving is None:
                return {"enabled": False}
            return {"enabled": True, **self.serving.stats()}
        # Read by a scrape sidecar over the framed protocol (and the
        # smoke), never by a client of the package.
        # gltlint: disable-next=unmatched-wire-op
        if op == "get_metrics":
            # Prometheus-style text exposition of the whole glt.*
            # namespace (producer, lease and replay counters, the
            # per-stage histograms) without touching producer state.
            return {"text": self.metrics_text(),
                    "enabled": _metrics.enabled()}
        if op == "flight_dump":
            # On-demand black-box read: the server's ring of structured
            # events, as the same JSON object the crash-time dump writes,
            # so an operator can pull a postmortem from a live server.
            _flight.record("server.flight_dump_served")
            snap = _flight.recorder().snapshot(reason="wire_op")
            if req.get("path"):
                # Optional server-side file dump beside the wire reply
                # (operator pulling artifacts off the server host).
                snap["path"] = _flight.dump_now("wire_op",
                                                path=str(req["path"]))
            return {"flight": snap}
        if op == "profile_capture":
            # Triggered capture on the server host: a bounded
            # torch.profiler trace (obs.profiler.capture) into `dir` (a
            # fresh temp dir when unset), indexed in the flight ring.
            import tempfile

            from ..obs import profiler as _obs_profiler
            millis = min(float(req.get("millis", 50.0)),
                         _obs_profiler.MAX_CAPTURE_MILLIS)
            pdir = (str(req["dir"]) if req.get("dir")
                    else tempfile.mkdtemp(prefix="glt_profile_"))
            _flight.record("server.profile_capture_served",
                           dir=pdir, millis=millis)
            try:
                with _obs_profiler.capture(pdir, millis=millis,
                                           reason="wire_op"):
                    pass
            except Exception as e:  # noqa: BLE001 — structured reply,
                return {"ok": False, "error": repr(e)}  # not a close
            return {"ok": True, "dir": pdir, "millis": millis}
        if op == "start_new_epoch_sampling":
            self._get_producer(req).start_epoch(
                int(req.get("epoch", 0)), trace_ctx=trace_ctx)
            return {"ok": True}
        if op == "destroy_sampling_producer":
            with self._lock:
                prod = self._producers.pop(req["producer_id"], None)
                for ck in [k for k, v in self._client_keys.items()
                           if v == req["producer_id"]]:
                    del self._client_keys[ck]
            if prod is not None:
                prod.stop()
            return {"ok": True}
        if op == "exit":
            self._stop.set()
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")

    def _handle_subgraph(self, req: dict) -> bytes:
        """Admit one serving request, wait for its coalesced result and
        return the serialized per-request message.

        Every failure is a :class:`RequestError` (the connection stays
        usable): serving disabled, an admission rejection (``overloaded``
        with ``retry_after_ms``), a deadline miss, an engine fault, or
        the server-side wait budget running out."""
        from ..serving.errors import ServingError

        if self.serving is None:
            raise RequestError(
                "serving not enabled on this server; start it with "
                "init_server(..., serving=ServingOptions(...))",
                code="serving_disabled")
        deadline_ms = req.get("deadline_ms")
        try:
            pending = self.serving.submit(req.get("seeds", ()),
                                          deadline_ms=deadline_ms)
        except ServingError as e:
            raise RequestError(
                str(e), code=e.code,
                **({} if e.retry_after_ms is None
                   else {"retry_after_ms": e.retry_after_ms})) from None
        # Bounded wait: a dispatcher wedged past the request's deadline
        # plus a full queue's service time is a structured timeout.
        if not pending.done.wait(
                timeout=self.serving.wait_budget_s(deadline_ms)):
            raise RequestError(
                "serving request timed out server-side (dispatcher "
                "overwhelmed or wedged)", code="serving_timeout")
        if pending.error is not None:
            e = pending.error
            raise RequestError(
                str(e), code=getattr(e, "code", "serving_failed"),
                **({} if e.retry_after_ms is None
                   else {"retry_after_ms": e.retry_after_ms}))
        return serialize(pending.message)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.2)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        if self._fault_plan is not None:
            conn = self._fault_plan.wrap(conn)
        with self._conns_lock:
            self._live_conns.add(conn)
        try:
            while True:
                kind, data = recv_frame(conn, max_len=self.max_frame_bytes)
                if kind is None:
                    return
                tracer = _current_tracer()
                t_recv_us = tracer.now_us() if tracer is not None else None
                req = json.loads(data)
                # Trace context rides a reserved JSON key (a server that
                # does not trace reads only the keys it knows); popped
                # here so request handlers never see it.
                ctx = _prop.extract(req)
                _metrics.counter(
                    "glt.server.requests", "requests handled, by op",
                    labels={"op": str(req.get("op"))}).inc()
                try:
                    if req["op"] == "fetch_one_sampled_message":
                        t_req0 = time.perf_counter()
                        with _span("server.fetch") as sp:
                            if ctx:
                                sp.link(ctx.get("tid"), ctx.get("sid"))
                            prod = self._get_producer(req)
                            seq, payload, replayed = prod.fetch_next(
                                int(req.get("ack", -1)),
                                int(req.get("epoch", 0)))
                            sp.set(seq=seq, replayed=replayed)
                            frame = struct.pack("<Q", seq) + payload
                            if ctx and tracer is not None:
                                # Clock echo as an append-only trailer —
                                # only on negotiated (context-carrying)
                                # requests, so an old client never sees
                                # trailer bytes.
                                frame = _prop.pack_trailer(
                                    frame, _prop.server_echo(
                                        tracer, t_recv_us))
                            with _H_SEND.time():
                                send_frame(conn, _KIND_MSG, frame)
                        if replayed:
                            _H_REPLAY.observe(
                                (time.perf_counter() - t_req0) * 1e3)
                        _M_MESSAGES.inc()
                    elif req["op"] == "subgraph_request":
                        # The latency path: this connection thread waits
                        # on its own request only; the coalescer batches
                        # across every waiting connection thread.
                        with _span("server.subgraph") as sp:
                            if ctx:
                                sp.link(ctx.get("tid"), ctx.get("sid"))
                            frame = self._handle_subgraph(req)
                            sp.set(bytes=len(frame))
                            if ctx and tracer is not None:
                                frame = _prop.pack_trailer(
                                    frame, _prop.server_echo(
                                        tracer, t_recv_us))
                            send_frame(conn, _KIND_SUB, frame)
                    else:
                        with _span("server." + str(req["op"])) as sp:
                            if ctx:
                                sp.link(ctx.get("tid"), ctx.get("sid"))
                            resp = self._handle(req, trace_ctx=ctx)
                            if ctx and tracer is not None:
                                resp[_prop.WIRE_KEY] = _prop.server_echo(
                                    tracer, t_recv_us)
                            send_frame(conn, _KIND_JSON,
                                       json.dumps(resp).encode())
                except RequestError as e:
                    # Structured per-request failure: report it and keep
                    # the connection serving — the framed stream is still
                    # in sync.
                    _M_ERRORS.inc()
                    _flight.record("server.request_error",
                                   op=str(req.get("op")), code=e.code,
                                   msg=str(e)[:200])
                    send_frame(conn, _KIND_JSON, json.dumps(
                        {"error": str(e), "code": e.code,
                         **e.extra}).encode())
        except Exception as e:  # desync/socket errors end the session
            # "protocol" marks a desynced stream: the client treats it as
            # retryable (reconnect resyncs framing, the replay window
            # resumes delivery); anything else is a terminal server error.
            code = "protocol" if isinstance(e, ProtocolError) else "fatal"
            _flight.record("server.conn_error", code=code,
                           exc=type(e).__name__, msg=str(e)[:200])
            try:
                send_frame(conn, _KIND_JSON, json.dumps(
                    {"error": str(e), "code": code}).encode())
            except OSError:
                pass
        finally:
            with self._conns_lock:
                self._live_conns.discard(conn)
            conn.close()

    def wait_for_exit(self, timeout: Optional[float] = None) -> None:
        self._stop.wait(timeout)

    def kill(self) -> None:
        """Die like a crashed process (chaos testing): stop accepting and
        sever every live connection mid-stream.  No structured goodbyes:
        in-flight clients see a raw transport error (ECONNRESET/EOF),
        the failure their failover path must absorb.  Producer teardown
        is left to the lease reaper, as a real crash would."""
        self._stop.set()
        _flight.record("server.killed", addr=list(self.addr))
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._live_conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self.serving is not None:
            self.serving.stop()

    def shutdown(self) -> None:
        self._stop.set()
        if self.serving is not None:
            # Fail queued serving requests structurally before tearing
            # down the producers: their connection threads are waiting.
            self.serving.stop()
        # Stop every live producer: with the mp backend each one owns a
        # worker-process fleet and a shm ring that would otherwise outlive
        # the client that forgot to destroy it.
        with self._lock:
            producers = list(self._producers.values())
            self._producers.clear()
            self._client_keys.clear()
        for prod in producers:
            prod.stop()
        try:
            self._sock.close()
        except OSError:
            pass
        auto_trace_export(self._trace_export_path)


def init_server(dataset, host: str = "127.0.0.1", port: int = 0,
                dataset_builder=None, builder_args: tuple = (),
                num_servers: int = 1, server_rank: int = 0,
                num_clients: int = 0,
                max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                reap_interval: float = 0.25,
                fault_plan: Optional[FaultPlan] = None,
                enable_metrics: bool = False,
                heartbeat_deadline: float = 10.0,
                serving=None) -> DistServer:
    """Start a sampling server on ``dataset`` (its producers sample on
    the dataset's device).

    Pass a picklable ``dataset_builder`` (+``builder_args``) to enable
    mp producer fleets for clients requesting
    ``RemoteSamplingWorkerOptions(num_workers > 0)``; it must build the
    dataset on the same device.  ``num_servers``/``server_rank``/
    ``num_clients`` record the fleet topology in this process's
    :class:`~.dist_context.DistContext`.  ``max_frame_bytes`` bounds
    inbound frame payloads (protocol error beyond it); ``fault_plan``
    wires a deterministic :class:`~glt_tpu_torch.testing.faults.
    FaultPlan` into every accepted connection and producer thread (chaos
    testing only).  ``enable_metrics=True`` flips the process-wide
    :mod:`glt_tpu_torch.obs.metrics` switch so the ``get_metrics`` op
    carries live ``glt.server.*`` counters.  ``serving=ServingOptions(
    ...)`` mounts the inference serving front
    (:class:`~glt_tpu_torch.serving.ServingFront`): the
    ``subgraph_request`` op with cross-request micro-batching, admission
    control and deadline-aware drop, on the dataset's device.
    """
    return DistServer(dataset, host=host, port=port,
                      dataset_builder=dataset_builder,
                      builder_args=builder_args,
                      num_servers=num_servers, server_rank=server_rank,
                      num_clients=num_clients,
                      max_frame_bytes=max_frame_bytes,
                      reap_interval=reap_interval,
                      fault_plan=fault_plan,
                      enable_metrics=enable_metrics,
                      heartbeat_deadline=heartbeat_deadline,
                      serving=serving)
