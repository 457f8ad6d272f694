"""Serving configuration: the coalescing policy and the admission bounds
(cf. ``glt_tpu/serving/options.py``).

One dataclass so ``init_server(serving=ServingOptions(...))`` carries
the whole policy: which sampling shapes exist (``seed_buckets``), how
long an idle server waits to coalesce (``max_wait_ms``, the
latency/throughput dial), and how much queued work admission control
takes before it rejects with ``Overloaded`` (``max_inflight``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class ServingOptions:
    """Policy knobs of the serving front on a server.

    Attributes:
      num_neighbors: per-hop fanouts of the shared serving sampler.
      seed_buckets: ascending padded seed-vector widths; a micro-batch is
        padded to the smallest bucket holding its total seed count, so
        the device sees one shape (one captured graph) per bucket.  The
        largest bucket bounds how many seeds one dispatch coalesces.
      max_seeds_per_request: per-request seed-set bound; larger requests
        are rejected ``bad_request``.
      max_batch_requests: at most this many requests share one
        micro-batch (1 = per-request dispatch).
      max_wait_ms: how long the coalescer holds a non-full micro-batch
        open for co-riders; a loaded server never waits.
      max_inflight: bound on queued-but-undispatched requests; admission
        rejects past it with ``Overloaded`` + ``retry_after_ms``.
      default_deadline_ms: per-request budget when the client sends
        none; a request still queued past its deadline is dropped with
        ``deadline_exceeded``.
      with_features / with_labels: gather node features/labels into the
        response (one shared gather per micro-batch).
      with_edge: include global edge ids in responses.
      frontier_cap: optional per-hop frontier cap for the sampler.
      seed_cache_entries: capacity of the replica's seed-affinity LRU,
        which every dispatched request counts its seeds against
        (``seed_cache_hit_rate`` in ``stats()``): the measure of how well
        fleet routing keeps a replica on a stable slice of the ids.
        0 disables it.
      seed: base RNG seed for the serving samplers.
    """

    num_neighbors: Sequence[int] = (10, 5)
    seed_buckets: Tuple[int, ...] = (8, 32, 128)
    max_seeds_per_request: int = 100
    max_batch_requests: int = 32
    max_wait_ms: float = 2.0
    max_inflight: int = 64
    default_deadline_ms: float = 1000.0
    with_features: bool = True
    with_labels: bool = True
    with_edge: bool = True
    frontier_cap: Optional[int] = None
    seed_cache_entries: int = 4096
    seed: int = 0

    def __post_init__(self):
        buckets = tuple(sorted(int(b) for b in self.seed_buckets))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"seed_buckets must be positive, got "
                             f"{self.seed_buckets!r}")
        self.seed_buckets = buckets
        if int(self.max_seeds_per_request) > buckets[-1]:
            raise ValueError(
                f"max_seeds_per_request {self.max_seeds_per_request} "
                f"exceeds the largest seed bucket {buckets[-1]}: a "
                f"single admissible request must fit one micro-batch")
        if int(self.max_batch_requests) < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if int(self.max_inflight) < 1:
            raise ValueError("max_inflight must be >= 1")
        if int(self.seed_cache_entries) < 0:
            raise ValueError("seed_cache_entries must be >= 0")
