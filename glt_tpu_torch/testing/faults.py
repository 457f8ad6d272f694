"""Deterministic fault injection for the remote sampling protocol.

A :class:`FaultPlan` is a reproducible schedule of failures — *the Nth
frame write fails*, *every connection drops after K frames*, *the 3rd
frame is delayed past the RPC timeout*, *the producer thread dies after
2 batches* — injectable into both socket endpoints
(a server wraps its accepted connections, a client its outbound
socket), into a server-side producer thread, into the training loop
(:class:`~glt_tpu_torch.ckpt.driver.TrainLoop` calls
:meth:`FaultPlan.on_train_step` after each block) and into the disk
tier (:class:`~glt_tpu_torch.store.disk.DiskFeatureStore` calls
:meth:`FaultPlan.on_disk_read`).  A copy of ``glt_tpu``'s module: one
plan against one workload counts and injects the same way in both
packages.

Everything is counter-based and lock-protected: the same plan against the
same workload injects at the same protocol step every run — no sleeps
racing the scheduler, no flaky "usually drops around batch 3".
"""
from __future__ import annotations

import dataclasses
import os
import signal
import socket
import struct
import threading
import time
from typing import Optional, Tuple

# Length written into a corrupted frame header: far above any configured
# frame bound, so the receiver rejects it before allocating.
_CORRUPT_LEN = 1 << 62


class ProducerKilled(BaseException):
    """Simulated crash of a server-side sampling thread.

    Deliberately a ``BaseException``: the producer's relay-to-client
    ``except Exception`` must NOT turn this into a clean error message —
    the thread has to die the way a real crash kills it (no relay, no
    cleanup), so the fetch path's liveness recheck is what surfaces it.
    """


class SimulatedPreemption(BaseException):
    """In-process stand-in for a SIGKILL at a train-step boundary.

    A ``BaseException`` for the same reason as :class:`ProducerKilled`:
    no ``except Exception`` recovery path may see it — the training
    process is "gone" from this point, and only a from-scratch rebuild +
    ``resume()`` continues the run.  The
    real-signal variant (``kill_at_train_step``) SIGKILLs the actual
    process; this one exists so the kill-at-every-k sweep can run in one
    pytest process.
    """


@dataclasses.dataclass
class FaultPlan:
    """One deterministic fault schedule.

    Frame indices are 1-based and count frame *writes* through faulty
    endpoints, globally across connections (``fail_nth_frame``,
    ``corrupt_length_frame``, ``delay_frames``) or per connection
    (``drop_after_frames``).  A plan is mutable shared state: hand the
    same instance to the endpoint under test and read the ``injected_*``
    counters back in assertions.
    """

    # Close the transport once this many frames were carried by a
    # connection — the K+1th write finds a dead socket (ECONNRESET-class).
    drop_after_frames: Optional[int] = None
    # Raise ``fail_exc`` instead of performing the Nth frame write.
    fail_nth_frame: Optional[int] = None
    fail_exc: type = ConnectionResetError
    # Sleep ``delay_secs`` before each listed frame write (simulates a
    # stall long enough to trip the peer's rpc_timeout).
    delay_frames: Tuple[int, ...] = ()
    delay_secs: float = 0.0
    # Overwrite the u64 length field of the Nth frame write with a huge
    # value — the hostile/corrupt-header case recv_frame must reject.
    corrupt_length_frame: Optional[int] = None
    # Kill the server-side producer epoch thread after this many buffer
    # puts (via ProducerKilled, so it dies unrelayed).
    kill_producer_after_puts: Optional[int] = None
    # SIGKILL THIS PROCESS after its Nth completed train step (1-based;
    # the ckpt.driver.TrainLoop fires on_train_step once per block,
    # after any due checkpoint save) — the chaos suite's counter-exact
    # preemption point.  SIGKILL is unhandleable by design: no atexit,
    # no flush, exactly what a preempted training host looks like.
    kill_at_train_step: Optional[int] = None
    # Same point, but raise SimulatedPreemption instead of dying — the
    # in-process variant for the kill-at-every-k resume sweep.
    preempt_at_train_step: Optional[int] = None
    # Fail the Nth serving micro-batch dispatch (1-based): the serving
    # front's dispatcher sees an engine exception exactly when that
    # coalesced batch would run, and must degrade to structured errors
    # for THAT batch's requests only (no poisoning of later batches).
    fail_serving_batch: Optional[int] = None
    # Kill the whole replica after this many serving micro-batches
    # (1-based): fires ``replica_kill_hook`` — a test-supplied closure,
    # typically spawning a thread that kills the server so
    # the replica dies abruptly mid-load (the fleet chaos scenario).
    # The hook runs at most once and must not block the dispatcher.
    kill_replica_after_serving_batches: Optional[int] = None
    replica_kill_hook: Optional[object] = None
    # Only the first N accepted/established connections are faulty;
    # later ones run clean (lets a test end the weather deterministically).
    max_faulty_conns: Optional[int] = None
    # Disk-tier chaos (glt_tpu_torch.store): chunk reads through a faulty
    # DiskFeatureStore count 1-based, globally across threads.  The Nth
    # read raises ``disk_fail_exc`` (an OSError — the EIO class the
    # store path must surface structurally); reads listed in
    # ``delay_disk_read`` sleep ``disk_delay_secs`` first (a stalled
    # staging thread / slow device — the degraded-mode trigger).
    fail_disk_read_at: Optional[int] = None
    disk_fail_exc: type = OSError
    delay_disk_read: Tuple[int, ...] = ()
    disk_delay_secs: float = 0.0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._frames_total = 0
        self._conns = 0
        self._puts = 0
        self._train_steps = 0
        self._serving_batches = 0
        self._disk_reads = 0
        self.injected_drops = 0
        self.injected_failures = 0
        self.injected_corruptions = 0
        self.injected_delays = 0
        self.injected_preemptions = 0
        self.injected_serving_failures = 0
        self.injected_replica_kills = 0
        self.injected_disk_failures = 0
        self.injected_disk_delays = 0

    # -- endpoint hooks ----------------------------------------------------
    def wrap(self, sock: socket.socket):
        """Wrap one endpoint's socket; returns it unwrapped once
        ``max_faulty_conns`` connections have been made faulty."""
        with self._lock:
            self._conns += 1
            idx = self._conns
        if self.max_faulty_conns is not None and idx > self.max_faulty_conns:
            return sock
        return FaultyConnection(sock, self, idx)

    def on_producer_put(self) -> None:
        """Called by the producer epoch thread after each buffer put."""
        if self.kill_producer_after_puts is None:
            return
        with self._lock:
            self._puts += 1
            fire = self._puts == self.kill_producer_after_puts
        if fire:
            raise ProducerKilled(
                f"fault injection: producer thread killed after "
                f"{self.kill_producer_after_puts} puts")

    def on_train_step(self) -> None:
        """Called by the training loop after each completed step/block
        (and after any checkpoint due at that step) — the counter-exact
        preemption point for ``kill_at_train_step`` /
        ``preempt_at_train_step``."""
        if (self.kill_at_train_step is None
                and self.preempt_at_train_step is None):
            return
        with self._lock:
            self._train_steps += 1
            n = self._train_steps
        if self.kill_at_train_step is not None \
                and n == self.kill_at_train_step:
            os.kill(os.getpid(), signal.SIGKILL)   # never returns
        if self.preempt_at_train_step is not None \
                and n == self.preempt_at_train_step:
            with self._lock:
                self.injected_preemptions += 1
            raise SimulatedPreemption(
                f"fault injection: process preempted after {n} "
                f"train steps")

    def on_serving_batch(self) -> None:
        """Called by the serving dispatcher before each micro-batch
        (``fail_serving_batch`` raises a plain RuntimeError — the
        engine-crash class the front must contain to the one batch;
        ``kill_replica_after_serving_batches`` fires the replica kill
        hook exactly once — whole-replica death under load)."""
        if (self.fail_serving_batch is None
                and self.kill_replica_after_serving_batches is None):
            return
        with self._lock:
            self._serving_batches += 1
            n = self._serving_batches
            fire = n == self.fail_serving_batch
            kill = (n == self.kill_replica_after_serving_batches
                    and self.replica_kill_hook is not None)
            if fire:
                self.injected_serving_failures += 1
            if kill:
                self.injected_replica_kills += 1
        if kill:
            self.replica_kill_hook()
        if fire:
            raise RuntimeError(
                f"fault injection: serving engine crashed on micro-batch "
                f"{self.fail_serving_batch}")

    def on_disk_read(self) -> None:
        """Called by :meth:`glt_tpu_torch.store.disk.DiskFeatureStore.
        _read_chunk` before every chunk read (``fail_disk_read_at`` /
        ``delay_disk_read``).  A delay sleeps on the READING thread —
        stage-ahead workers stall exactly like a slow device; the serve
        path must degrade around them, never wait on them."""
        if self.fail_disk_read_at is None and not self.delay_disk_read:
            return
        with self._lock:
            self._disk_reads += 1
            n = self._disk_reads
            fail = n == self.fail_disk_read_at
            delay = n in self.delay_disk_read
            if fail:
                self.injected_disk_failures += 1
            if delay:
                self.injected_disk_delays += 1
        if delay:
            time.sleep(self.disk_delay_secs)
        if fail:
            raise self.disk_fail_exc(
                f"fault injection: disk read {n} failed")

    @property
    def connections(self) -> int:
        with self._lock:
            return self._conns

    # -- internal ----------------------------------------------------------
    def _frame_action(self, conn: "FaultyConnection") -> Optional[str]:
        with self._lock:
            self._frames_total += 1
            n = self._frames_total
            if (self.drop_after_frames is not None
                    and conn._frames >= self.drop_after_frames):
                self.injected_drops += 1
                return "drop"
            if self.fail_nth_frame is not None and n == self.fail_nth_frame:
                self.injected_failures += 1
                return "fail"
            if (self.corrupt_length_frame is not None
                    and n == self.corrupt_length_frame):
                self.injected_corruptions += 1
                return "corrupt"
            if n in self.delay_frames:
                self.injected_delays += 1
                return "delay"
        return None


class FaultyConnection:
    """Socket wrapper injecting a :class:`FaultPlan` at frame writes.

    Duck-types the subset of the socket API the framed protocol uses
    (``sendall``/``recv``/``settimeout``/``close``); everything else
    delegates.  Faults act on writes because both protocol directions
    have a writer — wrap the client to perturb requests, the server to
    perturb responses — and a dropped/failed write is observed by the
    peer as EOF mid-frame, the same desync real network failures cause.
    """

    def __init__(self, sock: socket.socket, plan: FaultPlan,
                 conn_index: int):
        self._sock = sock
        self._plan = plan
        self.conn_index = conn_index
        self._frames = 0

    def sendall(self, data: bytes) -> None:
        action = self._plan._frame_action(self)
        if action == "drop":
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
            raise ConnectionResetError(
                "fault injection: connection dropped")
        if action == "fail":
            raise self._plan.fail_exc("fault injection: frame write failed")
        if action == "delay":
            time.sleep(self._plan.delay_secs)
        elif action == "corrupt":
            data = bytes(data[:4]) + struct.pack("<Q", _CORRUPT_LEN) \
                + bytes(data[12:])
        self._frames += 1
        self._sock.sendall(data)

    def recv(self, n: int) -> bytes:
        return self._sock.recv(n)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        self._sock.close()

    def __getattr__(self, name):
        return getattr(self._sock, name)
