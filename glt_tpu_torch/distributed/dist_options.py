"""Sampling worker options (cf. ``glt_tpu/distributed/dist_options.py``;
the same fields and defaults).

The option type selects a loader's mode: collocated (in-process),
mp (sampling subprocesses feeding a shm channel) or remote (producers on
a sampling server; :class:`RemoteSamplingWorkerOptions` is consumed by
:class:`~glt_tpu_torch.distributed.dist_client.RemoteNeighborLoader`
and forwarded to the server's producer factory).  The port adds one
field: :attr:`MpSamplingWorkerOptions.device`, where each mp worker
samples (the reference's ``worker_devices``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CollocatedSamplingWorkerOptions:
    """Sample in-process, synchronously (the default fused-on-device path)."""


@dataclasses.dataclass
class MpSamplingWorkerOptions:
    """Sample in ``num_workers`` spawned subprocesses feeding a shm
    channel: per-worker channel capacity, worker seeds split
    batch-aligned.  Each worker builds its dataset and samples on
    ``device`` (default ``"cuda"``: every worker shares the card with
    the trainer, in a CUDA context of its own; ``"cpu"`` to sample on
    the host).  A ``"cuda"`` worker without a card raises."""
    num_workers: int = 2
    channel_capacity_bytes: int = 64 * 1024 * 1024
    worker_seed: int = 0
    # Trainer-side recv timeout (seconds) between worker-liveness checks;
    # bounds how long a mid-epoch worker death can stall the epoch.
    heartbeat_secs: float = 5.0
    device: str = "cuda"


@dataclasses.dataclass
class RemoteSamplingWorkerOptions:
    """Sample on a remote server; producers run there, batches stream back.

    Mirrors ``RemoteDistSamplingWorkerOptions`` (dist_options.py:202-254):
    the client sets the server-side producer shape (worker count, buffer
    bounds) and its own prefetch depth.

    Attributes:
      num_workers: sampling subprocesses the server spawns for this
        producer (0 = one in-server thread; >0 needs the server to have
        been started with a picklable ``dataset_builder``; they sample
        on the server dataset's device).
      buffer_capacity: server-side bounded buffer, in messages (the
        reference's per-producer shm buffer capacity).
      channel_capacity_bytes: shm ring size for the server's mp workers.
      prefetch_size: client-side prefetch depth — at most this many
        fetched-but-unconsumed messages are held by the loader (the
        reference's RemoteReceivingChannel prefetch, remote_channel.py:24).
      max_retries: retryable transport failures (timeout, ECONNRESET,
        EOF, desynced frame) per exchange before giving up; each retry
        reconnects with exponential backoff + jitter.
      backoff_base / backoff_cap: reconnect backoff schedule, seconds —
        ``min(cap, base * 2**attempt)`` with 50-100% jitter.
      fallback_addrs: replica ``(host, port)`` addresses tried when the
        primary is unreachable (failover for meta/create traffic; a
        mid-epoch producer cannot migrate, so a failed-over fetch
        surfaces ``UnknownProducerError``).
      lease_secs: server-side producer lease; renewed implicitly by any
        request naming the producer, including every poll of a blocked
        fetch.  A client that vanishes without destroy leaks nothing —
        the server reaper GCs the producer (mp fleet + shm segment)
        once the lease expires.  0 disables expiry.
      replay_window: sent-but-unacked messages the server retains per
        producer for resume-after-reconnect.
      max_frame_bytes: reject protocol frames above this payload size (a
        corrupt u64 length must not drive an unbounded allocation).
      server_addr: ``(host, port)`` — only consumed by the worker-mode
        ``DistNeighborLoader`` front-end to select remote mode by option
        type; ``RemoteNeighborLoader`` takes the address positionally.
    """
    num_workers: int = 0
    buffer_capacity: int = 8
    channel_capacity_bytes: int = 64 * 1024 * 1024
    prefetch_size: int = 4
    worker_seed: int = 0
    # Socket timeout for every client<->server exchange (the reference's
    # rpc_timeout).  Generous default: a first kernel build or CUDA graph
    # capture on a loaded host can stall the producer before the first
    # batch lands.  Latency-sensitive ops override it per request
    # (`RemoteServerConnection.request(_timeout=)`).
    rpc_timeout: float = 600.0
    # -- fault tolerance ---------------------------------------------
    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    fallback_addrs: tuple = ()
    lease_secs: float = 300.0
    replay_window: int = 8
    max_frame_bytes: int = 1 << 30
    server_addr: tuple = None
