"""The serving front: admission control and the cross-request coalescer
(cf. ``glt_tpu/serving/front.py``).

Request lifecycle (timings are ``glt.serving.*`` histograms):

  submit -> [bounded inflight queue] -> coalesce -> micro-batch dispatch
         -> per-request scatter -> complete (or a structured error)

* **Admission** (:meth:`ServingFront.submit`): the inflight queue is
  bounded at ``max_inflight``; a full queue rejects at once with
  :class:`~glt_tpu_torch.serving.errors.Overloaded` carrying a
  ``retry_after_ms`` hint from the measured micro-batch service time.
* **Coalescing** (:meth:`_collect`): the dispatcher pops the first
  pending request, then holds the micro-batch open up to ``max_wait_ms``
  for co-riders, closing early when ``max_batch_requests`` requests or
  the largest seed bucket fills.  A request that does not fit leads the
  next micro-batch.
* **Deadline-aware drop**: a request still queued past its deadline is
  completed with ``deadline_exceeded`` at dispatch time.
* **Fault containment**: an engine failure fails exactly the requests
  of that micro-batch (``serving_failed``); the dispatcher survives.

The dispatcher thread is the only one that drives the engine, so on the
card it is where each bucket's CUDA graph is captured and replayed.  It
binds the dataset's card before its first micro-batch: the current
device is per thread.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from ..obs import flight as _flight
from ..obs import metrics as _metrics
from ..obs import profiler as _profiler
from ..obs.trace import span as _span
from .engine import SubgraphEngine
from .errors import DeadlineExceeded, Overloaded, ServingDown, ServingError
from .options import ServingOptions

# The SLO window: e2e covers submit -> complete server-side; the client
# adds its own glt.serving.client_ms around the wire round trip.
_M_REQUESTS = _metrics.counter(
    "glt.serving.requests", "subgraph requests admitted")
_M_OVERLOAD = _metrics.counter(
    "glt.serving.rejected_overload",
    "requests rejected by admission control (queue full)")
_M_DEADLINE = _metrics.counter(
    "glt.serving.rejected_deadline",
    "requests dropped after missing their deadline in queue")
_M_FAILED = _metrics.counter(
    "glt.serving.failed", "requests failed by an engine fault")
_M_BATCHES = _metrics.counter(
    "glt.serving.micro_batches", "coalesced micro-batches dispatched")
_H_QUEUE_WAIT = _metrics.histogram(
    "glt.serving.queue_wait_ms",
    "submit -> coalescer pickup wait per request")
_H_WIDTH = _metrics.histogram(
    "glt.serving.coalesce_width", "requests per dispatched micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_H_SEEDS = _metrics.histogram(
    "glt.serving.coalesce_seeds", "total seeds per micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024))
_H_BATCH = _metrics.histogram(
    "glt.serving.batch_ms",
    "micro-batch device stage: sample+gather dispatch + host fetch")
_H_SCATTER = _metrics.histogram(
    "glt.serving.scatter_ms",
    "micro-batch host stage: per-request split/relabel")
_H_E2E = _metrics.histogram(
    "glt.serving.e2e_ms", "submit -> completion per request, server-side")
_M_SHED = _metrics.counter(
    "glt.serving.rejected_shed",
    "requests rejected early while an SLO burn alert sheds load")
_G_SEED_CACHE = _metrics.gauge(
    "glt.serving.seed_cache_hit_rate",
    "hit rate of the replica's seed-affinity LRU (routing quality)")


class _Pending:
    """One inflight request: seeds in, message (or error) out."""

    __slots__ = ("seeds", "deadline", "enqueued", "done", "message",
                 "error")

    def __init__(self, seeds: np.ndarray, deadline: Optional[float]):
        self.seeds = seeds
        self.deadline = deadline          # monotonic, None = no deadline
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.message = None
        self.error: Optional[ServingError] = None

    def succeed(self, message) -> None:
        self.message = message
        self.done.set()

    def fail(self, error: ServingError) -> None:
        self.error = error
        self.done.set()


def _card_index(dataset, engine) -> Optional[int]:
    """The CUDA device index the engine runs on (None off the card),
    resolved in the constructing thread: ``"cuda"`` without an index is
    that thread's current device."""
    dev = getattr(dataset, "device", None)
    if dev is None:
        dev = getattr(getattr(engine, "graph", None), "device", None)
    if dev is None or getattr(dev, "type", None) != "cuda":
        return None
    if dev.index is not None:
        return int(dev.index)
    import torch

    return torch.cuda.current_device()


class ServingFront:
    """Admission + coalescing dispatcher over one :class:`SubgraphEngine`.

    Thread-safe for submitters (many connection threads); the engine is
    driven by the single dispatcher thread.
    """

    def __init__(self, dataset, options: ServingOptions,
                 fault_plan=None, engine: Optional[SubgraphEngine] = None):
        self.options = options
        self.engine = engine or SubgraphEngine(dataset, options)
        self._fault_plan = fault_plan
        self._card = _card_index(dataset, self.engine)
        # submit() never blocks: a full queue is an immediate Overloaded.
        self._queue: "queue.Queue[_Pending]" = queue.Queue(
            maxsize=int(options.max_inflight))
        self._carry: Optional[_Pending] = None
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._dispatched_batches = 0
        self._completed = 0
        self._failed = 0
        self._rejected_overload = 0
        self._rejected_deadline = 0
        self._rejected_shed = 0
        # While an SLO burn alert fires, admission shrinks to
        # (1 - shed_frac) of the queue so the backlog drains.  0.0 = open.
        self._shed_frac = 0.0
        self._shed_slo: Optional[str] = None
        # The seed-affinity LRU, counted per dispatched request (not per
        # admission, so rejected work does not pollute it).
        self._seed_cache: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._seed_cache_cap = int(options.seed_cache_entries)
        self._seed_cache_hits = 0
        self._seed_cache_lookups = 0
        # EWMA of micro-batch service time; seeds the retry-after hint
        # before the first batch lands.
        self._ewma_batch_ms = max(10.0, 2.0 * float(options.max_wait_ms))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="glt-serving-dispatch")
        self._thread.start()

    # -- admission ----------------------------------------------------------
    def submit(self, seeds, deadline_ms: Optional[float] = None) -> _Pending:
        """Validate and admit one request; returns its pending record.

        Raises :class:`BadRequest` / :class:`Overloaded` /
        :class:`ServingDown` instead of queueing doomed work.
        """
        if self._stop.is_set() or not self._thread.is_alive():
            raise ServingDown("serving front is stopped")
        canonical = self.engine.validate_seeds(seeds)
        if deadline_ms is None:
            deadline_ms = self.options.default_deadline_ms
        deadline = (None if deadline_ms is None or deadline_ms <= 0
                    else time.monotonic() + float(deadline_ms) / 1e3)
        pending = _Pending(canonical, deadline)
        shed = self._shed_frac
        if shed > 0.0:
            bound = max(1, int(self._queue.maxsize * (1.0 - shed)))
            if self._queue.qsize() >= bound:
                with self._stats_lock:
                    self._rejected_shed += 1
                _M_SHED.inc()
                _flight.record("serving.rejected_shed",
                               slo=self._shed_slo, shed_frac=shed,
                               inflight=self._queue.qsize())
                raise Overloaded(
                    f"shedding load ({self._shed_slo} SLO burning, "
                    f"shed_frac={shed:g}); retry after the hint",
                    retry_after_ms=self.retry_after_ms()) from None
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            with self._stats_lock:
                self._rejected_overload += 1
            _M_OVERLOAD.inc()
            _flight.record("serving.rejected_overload",
                           inflight=self._queue.maxsize,
                           retry_after_ms=self.retry_after_ms())
            raise Overloaded(
                f"serving queue full ({self.options.max_inflight} "
                f"inflight); retry after the hint",
                retry_after_ms=self.retry_after_ms()) from None
        _M_REQUESTS.inc()
        return pending

    def slo_alert(self, alert: dict) -> None:
        """``on_alert`` seam for :class:`~glt_tpu_torch.obs.slo.SloMonitor`:
        a firing burn alert shrinks admission by its ``shed_frac`` and
        triggers the armed profiler once; the resolve reopens it."""
        if alert.get("state") == "firing":
            self._shed_frac = float(alert.get("shed_frac") or 0.5)
            self._shed_slo = alert.get("slo")
            _flight.record("serving.shed_on", slo=self._shed_slo,
                           shed_frac=self._shed_frac)
            prof = _profiler.armed()
            if prof is not None:
                prof.trigger("slo:" + str(self._shed_slo))
        else:
            _flight.record("serving.shed_off", slo=alert.get("slo"))
            self._shed_frac = 0.0
            self._shed_slo = None

    def retry_after_ms(self) -> float:
        """Backoff hint: the queue's depth in micro-batches times the
        measured batch service time."""
        depth_batches = 1 + (self._queue.qsize()
                             // max(1, self.options.max_batch_requests))
        return round(depth_batches * self._ewma_batch_ms, 3)

    def wait_budget_s(self, deadline_ms: Optional[float]) -> float:
        """Server-side wait bound for a connection thread blocked on a
        pending result: the request's deadline budget plus one queue's
        worth of service time."""
        budget = (self.options.default_deadline_ms
                  if deadline_ms is None else float(deadline_ms))
        slack = (self._queue.maxsize + 1) * self._ewma_batch_ms + 1000.0
        return (max(budget, 0.0) + slack) / 1e3

    # -- coalescer ----------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        """Pop one micro-batch: the first pending request (a bounded poll,
        so stop is observed), then co-riders until the width, seed or
        wait limit."""
        first = self._carry
        self._carry = None
        while first is None:
            if self._stop.is_set():
                return []
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
        batch = [first]
        total = first.seeds.size
        max_bucket = self.engine.buckets[-1]
        close_at = time.monotonic() + float(self.options.max_wait_ms) / 1e3
        while len(batch) < self.options.max_batch_requests:
            rem = close_at - time.monotonic()
            if rem <= 0:
                break
            try:
                nxt = self._queue.get(timeout=rem)
            except queue.Empty:
                break
            if total + nxt.seeds.size > max_bucket:
                self._carry = nxt          # leads the next micro-batch
                break
            batch.append(nxt)
            total += nxt.seeds.size
        return batch

    def _run(self) -> None:
        if self._card is not None:
            import torch

            torch.cuda.set_device(self._card)
        while not self._stop.is_set():
            batch = self._collect()
            if batch:
                self._dispatch(batch)
        # Drain on stop: everything still queued fails structurally.
        leftovers, self._carry = [self._carry], None
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in leftovers:
            if p is not None and not p.done.is_set():
                p.fail(ServingDown("serving front stopped"))

    def _dispatch(self, batch: List[_Pending]) -> None:
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            _H_QUEUE_WAIT.observe((now - p.enqueued) * 1e3)
            if p.deadline is not None and now > p.deadline:
                with self._stats_lock:
                    self._rejected_deadline += 1
                _M_DEADLINE.inc()
                p.fail(DeadlineExceeded(
                    f"request spent {(now - p.enqueued) * 1e3:.1f} ms "
                    f"queued, past its deadline; dropped undispatched"))
                continue
            live.append(p)
        if not live:
            return
        if self._seed_cache_cap > 0:
            self._touch_seed_cache(live)
        _H_WIDTH.observe(len(live))
        _H_SEEDS.observe(sum(p.seeds.size for p in live))
        t0 = time.perf_counter()
        try:
            if self._fault_plan is not None:
                self._fault_plan.on_serving_batch()
            with _span("serving.micro_batch", width=len(live)):
                with _H_BATCH.time():
                    coal = self.engine.sample([p.seeds for p in live])
                with _H_SCATTER.time():
                    messages = self.engine.scatter(coal)
        except Exception as e:  # noqa: BLE001 — relayed per request
            with self._stats_lock:
                self._failed += len(live)
            _M_FAILED.inc(len(live))
            for p in live:
                p.fail(ServingError(f"serving engine failed: {e}"))
            return
        batch_ms = (time.perf_counter() - t0) * 1e3
        done = time.monotonic()
        for p, msg in zip(live, messages):
            p.succeed(msg)
            _H_E2E.observe((done - p.enqueued) * 1e3)
        with self._stats_lock:
            # A read-modify-write: under the lock stats() reads it by.
            self._ewma_batch_ms += 0.2 * (batch_ms - self._ewma_batch_ms)
            self._dispatched_batches += 1
            self._completed += len(live)
        _M_BATCHES.inc()

    def _touch_seed_cache(self, live: List[_Pending]) -> None:
        """Count every dispatched seed against the affinity LRU (only the
        dispatcher mutates it; the counters are read under the lock)."""
        cache, cap = self._seed_cache, self._seed_cache_cap
        hits = lookups = 0
        for p in live:
            for s in p.seeds.tolist():
                lookups += 1
                if s in cache:
                    hits += 1
                    cache.move_to_end(s)
                else:
                    cache[s] = None
                    if len(cache) > cap:
                        cache.popitem(last=False)
        with self._stats_lock:
            self._seed_cache_hits += hits
            self._seed_cache_lookups += lookups
            hit_rate = (self._seed_cache_hits
                        / max(1, self._seed_cache_lookups))
        _G_SEED_CACHE.set(round(hit_rate, 6))

    # -- introspection / lifecycle ------------------------------------------
    def stats(self) -> dict:
        """JSON-able occupancy and outcome counters (the ``serving_stats``
        wire op)."""
        with self._stats_lock:
            return {
                "inflight": self._queue.qsize(),
                "max_inflight": self._queue.maxsize,
                "dispatched_batches": self._dispatched_batches,
                "completed": self._completed,
                "failed": self._failed,
                "rejected_overload": self._rejected_overload,
                "rejected_deadline": self._rejected_deadline,
                "rejected_shed": self._rejected_shed,
                "shed_frac": self._shed_frac,
                "shed_slo": self._shed_slo,
                "ewma_batch_ms": round(self._ewma_batch_ms, 3),
                "compiled_buckets": self.engine.compiled_buckets(),
                "seed_cache_hits": self._seed_cache_hits,
                "seed_cache_lookups": self._seed_cache_lookups,
                "seed_cache_hit_rate": round(
                    self._seed_cache_hits
                    / max(1, self._seed_cache_lookups), 6),
            }

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
