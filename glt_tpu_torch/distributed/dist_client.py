"""Client side of the server-client deployment (cf.
``glt_tpu/distributed/dist_client.py``).

The client asks a sampling server (:mod:`.dist_server`) to create a
producer, starts epochs, and prefetches sampled messages over the socket
with a bounded depth (default 4, the reference's
``RemoteDistSamplingWorkerOptions``); each message becomes a batch of
tensors on the loader's ``device`` (default ``"cuda"``).

Fault tolerance: a :class:`RemoteServerConnection` is never terminally
poisoned.  Retryable failures (timeout, ECONNRESET, EOF, a desynced
frame) reconnect with exponential backoff and jitter, optionally failing
over across replica addresses, and the sequenced fetch protocol
(``seq``/``ack``) re-delivers exactly the batches lost in flight, with
duplicate suppression here: every batch of an epoch is delivered exactly
once across any number of reconnects.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import random
import socket
import struct
import threading
import time
import uuid
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..channel.base import QueueSourceDied, bounded_get, bounded_put
from ..channel.serialization import deserialize
from ..loader.transform import Batch
from ..utils.device import DeviceLike, resolve_device
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs import propagate as _prop
from ..obs.trace import auto_trace, auto_trace_export
from ..obs.trace import current as _current_tracer
from ..obs.trace import span as _span
from .dist_server import (
    _KIND_JSON,
    _KIND_MSG,
    DEFAULT_MAX_FRAME_BYTES,
    ProtocolError,
    recv_frame,
    send_frame,
)
from .sample_message import message_to_batch


# Remote-loader metrics (glt.remote.*): the cross-epoch view of the
# sequence-number accounting that ``epoch_stats`` snapshots per epoch.
_M_RECEIVED = _metrics.counter(
    "glt.remote.batches_received", "unique sampled messages received")
_M_DUPLICATES = _metrics.counter(
    "glt.remote.duplicates", "replayed messages suppressed client-side")
_M_RECONNECTS = _metrics.counter(
    "glt.remote.reconnects", "socket reconnects (backoff/failover)")
_M_EPOCHS = _metrics.counter(
    "glt.remote.epochs", "remote sampling epochs completed")


def publish_epoch_stats(stats: dict) -> dict:
    """Fold one epoch's seq accounting into the ``glt.remote.*`` counters.

    The unified read of what ``RemoteNeighborLoader.epoch_stats``
    exposes per epoch (the chaos tests assert exactly-once delivery from
    it).  Returns ``stats`` unchanged.
    """
    _M_RECEIVED.inc(stats.get("received", 0))
    _M_DUPLICATES.inc(stats.get("duplicates", 0))
    _M_RECONNECTS.inc(stats.get("reconnects", 0))
    _M_EPOCHS.inc()
    return stats


class UnknownProducerError(RuntimeError):
    """The server does not know this producer id: its lease expired and
    the reaper GC'd it, it was destroyed, or the connection failed over
    to a replica that never owned it.  The epoch cannot resume — recreate
    the producer (or the loader) to continue."""


# Server codes with no typed client-side exception that the client
# classifies as FATAL for the request at hand: the server spoke clearly
# (wrong epoch, a dead producer's sampling, a wedged pipeline), so
# retrying or failing over the same request cannot help.
FATAL_CODES = frozenset({
    "epoch_busy",        # previous epoch still producing (caller bug)
    "stale_epoch",       # request from a superseded epoch
    "sampling_failed",   # server-side sampling raised
    "producer_dead",     # producer thread/process died mid-epoch
    "fatal",             # conn-level terminal server error
})


class RemoteServerConnection:
    """One logical connection to a sampling server (with failover).

    Retryable transport failures trigger reconnect with exponential
    backoff + deterministic jitter, capped by ``max_retries`` /
    ``backoff_base`` / ``backoff_cap``; ``fallback_addrs`` extends the
    connect rotation across replicas.  Structured server errors
    (``{"error":..., "code":...}``) are NOT retried — they are the
    server speaking clearly, e.g. :class:`UnknownProducerError` for a
    GC'd lease.
    """

    RETRYABLE = (OSError, EOFError, ProtocolError)

    def __init__(self, addr: Tuple[str, int],
                 timeout: Optional[float] = 600.0,
                 max_retries: int = 3,
                 backoff_base: float = 0.05,
                 backoff_cap: float = 2.0,
                 fallback_addrs: Sequence[Tuple[str, int]] = (),
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 fault_plan=None,
                 seed: int = 0):
        # Bounded waits so a dead server surfaces as an error instead of a
        # hang (the reference's RPC timeouts).
        self.timeout = timeout
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.max_frame_bytes = int(max_frame_bytes)
        self._addrs = [tuple(addr)] + [tuple(a) for a in fallback_addrs]
        self._addr_i = 0
        self._fault_plan = fault_plan
        # Seeded jitter: reconnect storms decorrelate across clients
        # (seed with the client rank) while staying reproducible in tests.
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.sock = None
        self._broken = True          # no socket yet
        self.reconnects = 0          # successful re-connections (stats)
        # Wire context of the epoch in flight (set by the loader): links
        # request/fetch spans and reconnect/replay events to one trace.
        self.epoch_ctx: Optional[dict] = None
        self._connect()

    # -- connection management --------------------------------------------
    def _connect(self) -> None:
        """Connect to the first reachable address, starting at the one
        that last worked (failover rotates only past dead hosts)."""
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
            self._replacing = True
        last_exc = None
        for k in range(len(self._addrs)):
            i = (self._addr_i + k) % len(self._addrs)
            try:
                sock = socket.create_connection(self._addrs[i],
                                                timeout=self.timeout)
            except OSError as e:
                last_exc = e
                continue
            sock.settimeout(self.timeout)
            if self._fault_plan is not None:
                sock = self._fault_plan.wrap(sock)
            if getattr(self, "_replacing", False):
                self.reconnects += 1
                self._replacing = False
                _flight.record("remote.reconnect",
                               addr=list(self._addrs[i]),
                               reconnects=self.reconnects)
                tracer = _current_tracer()
                if tracer is not None:
                    # Tagged with the originating epoch's trace id so a
                    # merged trace attributes reconnect storms to the
                    # batch stream that suffered them.
                    ctx = self.epoch_ctx or {}
                    tracer.instant("remote.reconnect",
                                   trace_id=ctx.get("tid"),
                                   addr=list(self._addrs[i]))
            self.sock = sock
            self._addr_i = i
            self._broken = False
            return
        raise ConnectionError(
            f"could not connect to any of {self._addrs}: {last_exc}")

    def _sleep_backoff(self, attempt: int,
                       stop: Optional[threading.Event]) -> None:
        delay = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        delay *= 0.5 + 0.5 * self._rng.random()     # jitter
        if stop is not None:
            stop.wait(delay)
        else:
            time.sleep(delay)

    def _exchange(self, payload: bytes,
                  stop: Optional[threading.Event] = None,
                  retries: Optional[int] = None,
                  timeout: Optional[float] = None):
        """One framed round trip; ``timeout`` is the PER-OP socket
        timeout — latency-sensitive ops (serving ``subgraph_request``)
        bound their wait tighter than the connection's ``rpc_timeout``
        default without touching training-path fetches.  Applied per
        attempt and restored afterwards, so the next op on this
        connection sees the default again."""
        retries = self.max_retries if retries is None else int(retries)
        with self._lock:
            last_exc = None
            for attempt in range(retries + 1):
                # Stop-aware: a shutdown mid-retry surfaces immediately
                # instead of sleeping out the backoff schedule.
                if stop is not None and stop.is_set():
                    raise ConnectionAbortedError(
                        "exchange stopped by shutdown")
                if attempt:
                    # The whole retry loop (backoff sleep, reconnect,
                    # send, recv) runs under the per-connection lock on
                    # purpose: the framed protocol is a strict
                    # request-response stream, and a second thread
                    # interleaving mid-round-trip would desync it.  The
                    # escape hatch is interrupt(): it closes the socket
                    # out of band, the blocked I/O raises, and the
                    # stop-aware loop observes `stop` and releases the
                    # lock.
                    # gltlint: disable-next=blocking-call-while-holding-lock
                    self._sleep_backoff(attempt - 1, stop)
                    if stop is not None and stop.is_set():
                        raise ConnectionAbortedError(
                            "exchange stopped by shutdown")
                try:
                    if self._broken or self.sock is None:
                        # A timeout/short-read mid-exchange leaves the
                        # framed stream desynced; reconnecting is the only
                        # way to resync it.
                        self._connect()
                    if timeout is not None:
                        self.sock.settimeout(float(timeout))
                    # NTP sample half: t0 just before send, t3 just after
                    # a complete receive, both in the trace clock (only
                    # stamped while tracing — zero timestamp calls when
                    # off).
                    tracer = _current_tracer()
                    t0 = tracer.now_us() if tracer is not None else None
                    send_frame(self.sock, _KIND_JSON, payload)
                    kind, data = recv_frame(
                        self.sock, max_len=self.max_frame_bytes)
                    t3 = tracer.now_us() if tracer is not None else None
                    if kind is None:
                        # EOF (clean or mid-frame) — the server closed the
                        # socket (died, or dropped us after an error).
                        raise ConnectionResetError(
                            "server closed the connection")
                    if kind == _KIND_JSON and b'"error"' in data[:64]:
                        resp = json.loads(data)
                        if resp.get("code") == "protocol":
                            # The server saw a desynced/corrupt frame from
                            # us and is closing: retryable — a fresh
                            # connection resyncs the framing.
                            raise ProtocolError(resp.get("error", ""))
                    if timeout is not None:
                        # Restore the connection-wide default: later ops
                        # on this socket get rpc_timeout semantics back.
                        # (Failure paths mark the socket broken, and the
                        # reconnect re-applies the default.)
                        self.sock.settimeout(self.timeout)
                    return kind, data, t0, t3
                except self.RETRYABLE as e:
                    self._broken = True
                    last_exc = e
            raise RuntimeError(
                f"exchange failed after {retries} retries over "
                f"{self._addrs}: {last_exc}") from last_exc

    @staticmethod
    def _raise_structured(resp: dict) -> None:
        code = resp.get("code")
        if code == "unknown_producer":
            raise UnknownProducerError(resp["error"])
        if code is not None:
            # Serving rejections round-trip as their typed exceptions
            # (Overloaded keeps its retry_after_ms hint).
            from ..serving.errors import SERVING_CODES, error_from_response

            if code in SERVING_CODES:
                raise error_from_response(resp)
            if code in FATAL_CODES:
                # The server's explicit non-retryable verdict: surface
                # the code so operators (and the failover discipline)
                # can tell it from a transport fault.
                raise RuntimeError(
                    f"server error [{code}]: {resp['error']}")
        raise RuntimeError(f"server error: {resp['error']}")

    # -- protocol ----------------------------------------------------------
    def request(self, _stop: Optional[threading.Event] = None,
                _retries: Optional[int] = None,
                _trace_ctx: Optional[dict] = None,
                _timeout: Optional[float] = None, **req) -> dict:
        with _span("remote.request", op=str(req.get("op"))) as sp:
            if self.epoch_ctx:
                sp.link(self.epoch_ctx.get("tid"),
                        self.epoch_ctx.get("sid"))
            if _trace_ctx is not None:
                # Explicit remote parent (the loader passes the EPOCH
                # span for start_new_epoch_sampling: producer spans live
                # far longer than this request's round trip, so they
                # must hang off the epoch, not off this request span).
                req[_prop.WIRE_KEY] = _trace_ctx
            else:
                _prop.inject(req, sp)
            kind, data, t0, t3 = self._exchange(
                json.dumps(req).encode(), stop=_stop, retries=_retries,
                timeout=_timeout)
            if kind != _KIND_JSON:
                raise RuntimeError("expected JSON response")
            resp = json.loads(data)
            _prop.record_clock_sync(resp.pop(_prop.WIRE_KEY, None), t0, t3)
            if "error" in resp:
                self._raise_structured(resp)
            return resp

    def fetch_message(self, producer_id: int, epoch: int = 0,
                      ack: int = -1,
                      stop: Optional[threading.Event] = None):
        """Fetch one sampled message; returns ``(seq, message)``.

        ``ack`` (highest seq contiguously received) releases the server's
        replay window and directs resume after a reconnect.
        """
        with _span("remote.fetch", epoch=epoch) as sp:
            if self.epoch_ctx:
                sp.link(self.epoch_ctx.get("tid"),
                        self.epoch_ctx.get("sid"))
            req = {"op": "fetch_one_sampled_message",
                   "producer_id": producer_id,
                   "epoch": epoch, "ack": ack}
            _prop.inject(req, sp)
            kind, data, t0, t3 = self._exchange(
                json.dumps(req).encode(), stop=stop)
            if kind != _KIND_MSG:
                resp = json.loads(data)
                if "error" in resp:
                    self._raise_structured(resp)
                raise RuntimeError("bad frame")
            # A traced server appends an append-only trailer (clock echo)
            # AFTER the payload — but only when THIS request carried the
            # trace context (negotiation).  Only look for it then, so an
            # untraced exchange can never misread payload bytes that
            # happen to end in the magic.
            if _prop.WIRE_KEY in req:
                payload, echo = _prop.split_trailer(data)
                _prop.record_clock_sync(echo, t0, t3)
            else:
                payload = memoryview(data)
            seq = struct.unpack_from("<Q", payload, 0)[0]
            sp.set(seq=int(seq))
            return int(seq), deserialize(payload[8:])

    def flight_dump(self, retries: int = 0) -> Optional[dict]:
        """Pull the server's flight-recorder ring (``flight_dump`` op).

        Returns the dump object (``glt_flight`` schema,
        :func:`glt_tpu_torch.obs.flight.validate_flight_dump`), or **None
        against a pre-flight-recorder server** — an old server answers
        the unknown op with its fatal error and closes the connection,
        which this helper degrades to "no black box available"
        (mixed-version contract; the connection reconnects on next
        use).  Transport failures degrade the same way: this is a
        best-effort postmortem read, never a new failure mode.
        """
        try:
            resp = self.request(op="flight_dump", _retries=int(retries))
        except (RuntimeError, OSError):
            self._broken = True       # old server closed after the error
            return None
        flight = resp.get("flight")
        return flight if isinstance(flight, dict) else None

    def profile_capture(self, dir: Optional[str] = None,
                        millis: float = 50.0,
                        retries: int = 0) -> Optional[dict]:
        """Trigger a bounded profiler capture on the server host (the
        ``profile_capture`` op).

        Returns ``{"ok", "dir", "millis"}`` naming the server-side
        capture directory, or **None against a server without the op**:
        the unknown-op fatal error (and any transport failure) degrades to
        "no capture available", never a new failure mode; the
        connection reconnects on next use.
        """
        req: dict = {"op": "profile_capture", "millis": float(millis),
                     "_retries": int(retries)}
        if dir is not None:
            req["dir"] = str(dir)
        try:
            resp = self.request(**req)
        except (RuntimeError, OSError):
            self._broken = True       # old server closed after the error
            return None
        return resp if isinstance(resp, dict) and resp.get("ok") else None

    @property
    def broken(self) -> bool:
        return self._broken

    def interrupt(self) -> None:
        """Force-close the socket so a thread blocked inside an exchange
        raises promptly (and observes its stop event instead of
        retrying).  The connection transparently reconnects on next use."""
        self._broken = True
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        try:
            if self.sock is not None:
                self.sock.close()
        except OSError:
            pass


class RemoteNeighborLoader:
    """Loader iterating batches produced on a remote sampling server
    (the reference's DistLoader 'remote' mode); each batch's tensors land
    on ``device`` (default ``"cuda"``).

    After each epoch, ``epoch_stats`` records the sequence-number
    accounting: ``{"received", "duplicates", "reconnects", "seqs"}``.
    The same numbers fold into the ``glt.remote.*`` counters
    (:func:`publish_epoch_stats`).
    """

    def __init__(
        self,
        server_addr: Tuple[str, int],
        num_neighbors: Sequence[int],
        input_nodes: np.ndarray,
        batch_size: int = 512,
        prefetch: Optional[int] = None,
        seed: int = 0,
        worker_options=None,
        fault_plan=None,
        device: DeviceLike = None,
    ):
        from .dist_options import RemoteSamplingWorkerOptions

        self.device = resolve_device(device)
        opts = worker_options or RemoteSamplingWorkerOptions()
        if not isinstance(opts, RemoteSamplingWorkerOptions):
            raise TypeError(
                f"worker_options must be RemoteSamplingWorkerOptions, got "
                f"{type(opts).__name__}")
        # An explicit ``prefetch`` argument wins over the options default.
        if prefetch is not None:
            opts = dataclasses.replace(opts, prefetch_size=int(prefetch))
        self.conn = RemoteServerConnection(
            server_addr,
            timeout=float(opts.rpc_timeout),
            max_retries=int(opts.max_retries),
            backoff_base=float(opts.backoff_base),
            backoff_cap=float(opts.backoff_cap),
            fallback_addrs=tuple(opts.fallback_addrs),
            max_frame_bytes=int(opts.max_frame_bytes),
            fault_plan=fault_plan,
            seed=seed)
        # Stable per-loader identity: a re-create after lease GC (or a
        # retried create whose response was lost) tears down the previous
        # producer server-side instead of leaking it.
        self._client_key = uuid.uuid4().hex
        resp = self.conn.request(
            op="create_sampling_producer",
            num_neighbors=list(num_neighbors),
            input_nodes=np.asarray(input_nodes).tolist(),
            batch_size=int(batch_size),
            seed=seed + opts.worker_seed,
            num_workers=int(opts.num_workers),
            buffer_capacity=int(opts.buffer_capacity),
            channel_capacity_bytes=int(opts.channel_capacity_bytes),
            lease_secs=float(opts.lease_secs),
            replay_window=int(opts.replay_window),
            client_key=self._client_key)
        self.producer_id = resp["producer_id"]
        self.num_expected = resp["num_expected"]
        self.prefetch = max(1, int(opts.prefetch_size))
        self._epoch = 0
        self.epoch_stats: dict = {}
        # GLT_OBS_TRACE_DIR: per-process trace file exported at shutdown
        # (one track per fleet process; stitch with `obs merge`).
        self._trace_export_path = auto_trace("client")

    def __len__(self) -> int:
        return self.num_expected

    # -- state-capture protocol (glt_tpu_torch.ckpt) -----------------------
    def state_dict(self) -> dict:
        """Per-producer epoch-fence + accounting state for checkpoints.

        The durable facts a restarted client needs: its epoch fence (so
        the resumed process's next epoch outranks every message the
        killed process's epoch could still replay — the server discards
        stale-epoch fetches), its ``client_key`` (a re-created producer
        under the same key tears down the orphan server-side), and the
        last completed epoch's seq accounting for the record.
        """
        return {
            "epoch": int(self._epoch),
            "client_key": self._client_key,
            "num_expected": int(self.num_expected),
            "last_epoch_stats": {
                k: sorted(v) if isinstance(v, set) else v
                for k, v in self.epoch_stats.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Resume the epoch fence in THIS (freshly constructed) loader.

        The fence only ratchets forward: a fresh loader starts at 0, so
        ``max`` keeps the restored fence above anything the interrupted
        run produced — its next ``__iter__`` starts epoch ``saved + 1``
        and the server's epoch check discards any in-flight replays of
        the killed epoch.
        """
        saved = int(state["epoch"])
        if saved != self._epoch and self.num_expected != int(
                state.get("num_expected", self.num_expected)):
            raise ValueError(
                f"checkpoint was taken against a producer expecting "
                f"{state.get('num_expected')} batches; this loader "
                f"expects {self.num_expected} — different seed set?")
        self._epoch = max(self._epoch, saved)

    def __iter__(self) -> Iterator[Batch]:
        self._epoch += 1
        epoch = self._epoch
        with _span("remote.epoch", epoch=epoch) as ep_span:
            yield from self._iter_epoch(epoch, ep_span)

    def _iter_epoch(self, epoch: int, ep_span) -> Iterator[Batch]:
        # The epoch span is the trace ROOT: every request/fetch span
        # (this process), server stage span, and producer/worker span of
        # this epoch joins its trace id — one causally-linked tree per
        # remote-sampling run once `obs merge` aligns the clocks.
        self.conn.epoch_ctx = ep_span.context()
        self.conn.request(op="start_new_epoch_sampling",
                          producer_id=self.producer_id, epoch=epoch,
                          _trace_ctx=self.conn.epoch_ctx)
        # Bounded to the configured prefetch depth: a slow trainer holds at
        # most ``prefetch`` unconsumed messages instead of buffering the
        # whole epoch in client RAM (the reference's prefetch_size).
        buf: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        stats = {"received": 0, "duplicates": 0, "seqs": set()}
        reconnects_before = self.conn.reconnects

        def prefetcher():
            # A fetch error (dead server, socket timeout past the retry
            # budget, GC'd lease) is forwarded to the consumer instead of
            # dying silently in this thread and leaving the consumer
            # blocked forever on buf.get().
            try:
                ack = -1
                dup_run = 0
                while len(stats["seqs"]) < self.num_expected:
                    if stop.is_set():
                        return
                    seq, msg = self.conn.fetch_message(
                        self.producer_id, epoch=epoch, ack=ack, stop=stop)
                    if seq in stats["seqs"]:
                        # Duplicate suppression: a replayed message we
                        # already hold is dropped, but an identical resend
                        # loop must not spin forever.
                        stats["duplicates"] += 1
                        dup_run += 1
                        if dup_run > 2 * self.num_expected + 16:
                            raise RuntimeError(
                                "resume protocol livelock: server keeps "
                                "resending already-received seqs")
                        continue
                    dup_run = 0
                    stats["seqs"].add(seq)
                    stats["received"] += 1
                    while ack + 1 in stats["seqs"]:
                        ack += 1
                    if not bounded_put(buf, msg, stop):
                        return
            except ConnectionAbortedError:
                return   # stop-aware exchange observed the shutdown
            except Exception as e:  # noqa: BLE001 — relayed to consumer
                bounded_put(buf, e, stop)

        t = threading.Thread(target=prefetcher, daemon=True)
        t.start()
        try:
            for _ in range(self.num_expected):
                try:
                    item = bounded_get(buf, alive=t.is_alive, poll=0.2)
                except QueueSourceDied:
                    raise RuntimeError(
                        "remote sampling prefetch thread died "
                        "unexpectedly") from None
                if isinstance(item, Exception):
                    raise RuntimeError(
                        f"remote sampling prefetch failed: {item}"
                    ) from item
                yield message_to_batch(item, device=self.device)
        finally:
            stop.set()
            # Join the prefetcher: one still blocked inside fetch_message
            # holds the connection lock, so an un-joined exit would make a
            # prompt shutdown() (or the next epoch's start request) wait
            # out rpc_timeout.  If it doesn't exit on its own, force the
            # socket closed — the blocked recv raises, the stop-aware
            # retry loop sees `stop`, and the lock is released.
            t.join(timeout=1.0)
            if t.is_alive():
                self.conn.interrupt()
                t.join(timeout=2.0)
            stats["reconnects"] = self.conn.reconnects - reconnects_before
            self.epoch_stats = publish_epoch_stats(stats)
            self.conn.epoch_ctx = None

    def shutdown(self, exit_server: bool = False) -> None:
        try:
            self.conn.request(op="destroy_sampling_producer",
                              producer_id=self.producer_id, _retries=1)
            if exit_server:
                self.conn.request(op="exit", _retries=1)
        except (RuntimeError, OSError):
            pass   # unreachable server: the lease reaper collects it
        finally:
            self.conn.close()
            auto_trace_export(self._trace_export_path)
