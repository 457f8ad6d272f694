"""Bounded-DRAM staging cache over a
:class:`~glt_tpu_torch.store.disk.DiskFeatureStore` (cf.
``glt_tpu/store/stager.py``).

``DramStager`` is the middle of the three-tier read path:

    device hot prefix / cold cache  →  **DRAM stage (this)**  →  disk store

Its contract is an *explicit, enforced* DRAM budget: the one feature-byte
allocation is ``[capacity, dim]`` at the store's storage width, with
``capacity = dram_budget_bytes // row_nbytes``, sized at construction and
never grown.  (Residency metadata — a slot map over store rows — costs
~12 bytes/row on top; it scales with the store, not the budget, and is
documented out of the budget.)

Residency is frequency-based: every row carries an access count (seeded
by :meth:`warm` from an oracle's scores), rows are admitted on demand or
by :meth:`stage_ahead`, and eviction takes the lowest-scoring resident
slots, so frequently touched rows converge to DRAM while the long tail
faults to disk.

Failure semantics (the chaos contract):

* a **stalled staging thread** degrades, never hangs: :meth:`gather`
  NEVER waits on staging — rows not yet resident are demand-faulted
  synchronously from disk (correct bytes, degraded latency);
* a **failed staging read** is swallowed into ``stage_errors`` (the
  stager keeps operating in degraded synchronous-fetch mode);
* a **failed demand read** raises the store's structured error out of
  :meth:`gather` — never a silent zero-row batch.

Counters (``bytes_from_dram`` / ``bytes_from_disk``, hit/miss, stage
depth) are read with :meth:`stats` and :meth:`epoch_stats`, and
published as ``glt.store.*`` gauges with :func:`publish_store_stats` /
:meth:`DramStager.publish_epoch_stats`; an eviction records a
``store.evict`` flight event.
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Optional

import numpy as np

from ..obs import device as _device
from ..obs import flight as _flight
from ..obs import metrics as _metrics
from .disk import DiskFeatureStore


class DramStager:
    """Explicitly-budgeted DRAM row cache with async stage-ahead.

    Args:
      store: the backing :class:`DiskFeatureStore`.
      dram_budget_bytes: hard cap on resident feature bytes; capacity is
        ``budget // row_nbytes`` rows (must be >= 1).
      stage_threads: workers for :meth:`stage_ahead` staging reads.
      row_chunk: chunk width for fanned disk reads.
    """

    def __init__(self, store: DiskFeatureStore, dram_budget_bytes: int,
                 stage_threads: int = 1, row_chunk: int = 16384):
        self.store = store
        self.dram_budget_bytes = int(dram_budget_bytes)
        self.row_chunk = int(row_chunk)
        cap = self.dram_budget_bytes // store.row_nbytes
        if cap < 1:
            raise ValueError(
                f"dram_budget_bytes={dram_budget_bytes} holds zero "
                f"{store.row_nbytes}-byte rows; raise the budget")
        self.capacity = min(cap, store.num_rows)
        # THE feature-byte allocation — never grown (the enforced budget).
        self._buf = np.empty((self.capacity, store.dim), store.dtype)
        assert self._buf.nbytes <= self.dram_budget_bytes
        _device.register_owner("stager", self._buf)
        # Residency metadata (out of budget, documented): store row ->
        # slot, slot -> store row, slot -> score, row -> access frequency.
        self._slot_of = np.full(store.num_rows, -1, np.int64)
        self._row_of = np.full(self.capacity, -1, np.int64)
        self._score = np.zeros(self.capacity, np.float64)
        self._freq = np.zeros(store.num_rows, np.float64)
        self._used = 0
        self._lock = threading.Lock()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(stage_threads)),
            thread_name_prefix="glt-store-stage")
        # Counters (all under self._lock).
        self.hits = 0
        self.misses = 0
        self.bytes_from_dram = 0
        self.bytes_from_disk = 0
        self.staged_rows = 0
        self.stage_errors = 0
        self.stage_depth = 0          # stage-ahead tasks in flight
        self.stage_depth_max = 0
        self._epoch_mark = self._counters()

    # -- residency ---------------------------------------------------------
    def resident_rows(self) -> int:
        with self._lock:
            return self._used

    def resident_bytes(self) -> int:
        return self.resident_rows() * self.store.row_nbytes

    def _install(self, row_ids: np.ndarray, rows: np.ndarray) -> int:
        """Admit ``rows`` for ``row_ids`` (parallel arrays), evicting the
        lowest-score residents when full.  Returns rows admitted."""
        with self._lock:
            row_ids, first = np.unique(row_ids, return_index=True)
            rows = rows[first]
            fresh = self._slot_of[row_ids] < 0
            row_ids, rows = row_ids[fresh], rows[fresh]
            if row_ids.size > self.capacity:
                # More new rows than the whole budget: keep the
                # highest-frequency subset (the rest re-faults to disk).
                keep = np.argsort(-self._freq[row_ids],
                                  kind="stable")[: self.capacity]
                row_ids, rows = row_ids[keep], rows[keep]
            k = row_ids.size
            if k == 0:
                return 0
            nfree = self.capacity - self._used
            take = min(k, nfree)
            n_evict = k - take
            victims = None
            if n_evict:
                # Evict the n_evict lowest-score residents — chosen from
                # the OLD resident region, before the fresh slots (whose
                # scores are stale) join it.
                victims = np.argpartition(
                    self._score[: self._used],
                    n_evict - 1)[:n_evict].astype(np.int64)
                self._slot_of[self._row_of[victims]] = -1
                _flight.record("store.evict", count=int(n_evict),
                               resident=int(self._used))
            slots = np.arange(self._used, self._used + take, dtype=np.int64)
            self._used += take
            if victims is not None:
                slots = np.concatenate([slots, victims])
            self._row_of[slots] = row_ids
            self._slot_of[row_ids] = slots
            self._score[slots] = self._freq[row_ids]
            self._buf[slots] = rows
            return k

    def warm(self, scores: np.ndarray) -> int:
        """Prefill DRAM with the top-``capacity`` rows by oracle score.

        ``scores``: ``[num_rows]`` access statistics (e.g. per-row access
        probabilities from a partition book).  Seeds the frequency counts, so the oracle prior also
        steers later evictions.  Returns rows staged.
        """
        scores = np.asarray(scores, np.float64)
        if scores.shape[0] != self.store.num_rows:
            raise ValueError(
                f"oracle scores cover {scores.shape[0]} rows, store has "
                f"{self.store.num_rows}")
        with self._lock:
            np.maximum(self._freq, scores, out=self._freq)
        top = np.argsort(-scores, kind="stable")[: self.capacity]
        rows = self.store.read_rows(top)
        with self._lock:
            self.bytes_from_disk += top.size * self.store.row_nbytes
        return self._install(top.astype(np.int64), rows)

    # -- the serve path ----------------------------------------------------
    def gather(self, row_ids: np.ndarray) -> np.ndarray:
        """``[len(row_ids), dim]`` rows (zeros at ids < 0); DRAM hits plus
        synchronous demand faults for the rest."""
        row_ids = np.asarray(row_ids)
        out = np.zeros((row_ids.shape[0], self.store.dim), self.store.dtype)
        self.gather_into(out, row_ids)
        return out

    def gather_into(self, out: np.ndarray, row_ids: np.ndarray,
                    pool=None, row_chunk: Optional[int] = None) -> list:
        """Serve ``row_ids`` (< 0 = skip) into ``out``: resident rows copy
        from DRAM under the lock; misses demand-fault from disk.

        With ``pool`` the miss reads fan out as chunk futures (returned;
        the caller awaits them); admitted misses are
        installed by a completion callback off the caller's critical
        path.  Never waits on the staging threads: a stalled stage-ahead
        degrades this call to more disk reads, not a hang.
        """
        row_ids = np.asarray(row_ids)
        sel = np.where(row_ids >= 0)[0]
        if sel.size == 0:
            return []
        ids = row_ids[sel].astype(np.int64)
        with self._lock:
            self._freq[ids] += 1.0
            slots = self._slot_of[ids]
            hit = slots >= 0
            hitpos = sel[hit]
            out[hitpos] = self._buf[slots[hit]]
            self._score[slots[hit]] = self._freq[ids[hit]]
            nh, nm = int(hit.sum()), int((~hit).sum())
            self.hits += nh
            self.misses += nm
            self.bytes_from_dram += nh * self.store.row_nbytes
            self.bytes_from_disk += nm * self.store.row_nbytes
        if nm == 0:
            return []
        misspos = sel[~hit]
        miss_req = np.full(row_ids.shape[0], -1, np.int64)
        miss_req[misspos] = ids[~hit]
        futs = self.store.gather_into(
            out, miss_req, pool=pool,
            row_chunk=row_chunk or self.row_chunk)
        if not futs:
            self._install(ids[~hit], out[misspos])
            return []
        # Install once every chunk landed.  The callback snapshots the
        # rows immediately (the caller may eventually reuse ``out`` as a
        # staging buffer; its reuse is synced batches later, but the copy
        # removes the window entirely).
        state = {"remaining": len(futs), "failed": False}
        cb_lock = threading.Lock()
        miss_ids = ids[~hit]

        def _on_chunk_done(fu):
            bad = fu.cancelled() or fu.exception() is not None
            with cb_lock:
                state["failed"] = state["failed"] or bad
                state["remaining"] -= 1
                last = state["remaining"] == 0
                failed = state["failed"]
            if last and not failed:
                # Any failed chunk vetoes the install: never cache rows a
                # read error left unfilled.
                self._install(miss_ids, np.array(out[misspos]))

        for fu in futs:
            fu.add_done_callback(_on_chunk_done)
        return futs

    # -- async stage-ahead -------------------------------------------------
    def stage_ahead(self, row_ids: np.ndarray):
        """Queue an async staging read for ``row_ids`` (the prefetch
        oracle's next-batch guess).  Returns the future (tests await it;
        production code never needs to — see the failure semantics)."""
        ids = np.unique(np.asarray(row_ids))
        ids = ids[ids >= 0].astype(np.int64)
        with self._lock:
            self.stage_depth += 1
            self.stage_depth_max = max(self.stage_depth_max,
                                       self.stage_depth)
        return self._pool.submit(self._stage, ids)

    def _stage(self, ids: np.ndarray) -> int:
        try:
            with self._lock:
                ids = ids[self._slot_of[ids] < 0]
            if ids.size == 0:
                return 0
            if ids.size > self.capacity:
                ids = ids[np.argsort(-self._freq[ids],
                                     kind="stable")[: self.capacity]]
            rows = self.store.read_rows(ids)
            with self._lock:
                self.bytes_from_disk += ids.size * self.store.row_nbytes
            n = self._install(ids, rows)
            with self._lock:
                self.staged_rows += n
            return n
        except Exception:
            # Degraded operation: the rows this read would have staged
            # will demand-fault from disk instead.  Recorded, not raised
            # (a staging thread must never take the epoch down).
            with self._lock:
                self.stage_errors += 1
            return 0
        finally:
            with self._lock:
                self.stage_depth -= 1

    # -- stats / lifecycle -------------------------------------------------
    def _counters(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "bytes_from_dram": self.bytes_from_dram,
            "bytes_from_disk": self.bytes_from_disk,
            "staged_rows": self.staged_rows,
            "stage_errors": self.stage_errors,
        }

    def stats(self) -> dict:
        """Lifetime counters + residency snapshot (host-side)."""
        with self._lock:
            c = self._counters()
            c.update({
                "capacity_rows": self.capacity,
                "resident_rows": self._used,
                "resident_bytes": self._used * self.store.row_nbytes,
                "budget_bytes": self.dram_budget_bytes,
                "stage_depth": self.stage_depth,
                "stage_depth_max": self.stage_depth_max,
            })
        total = c["hits"] + c["misses"]
        c["hit_rate"] = c["hits"] / total if total else 0.0
        return c

    def epoch_stats(self) -> dict:
        """Counters since the previous call (the per-epoch view), plus
        the residency snapshot."""
        cur = self.stats()
        with self._lock:
            mark, self._epoch_mark = self._epoch_mark, self._counters()
        out = dict(cur)
        for k, v in mark.items():
            out[k] = cur[k] - v
        total = out["hits"] + out["misses"]
        out["hit_rate"] = out["hits"] / total if total else 0.0
        return out

    def publish_epoch_stats(self, namespace: str = "glt.store") -> dict:
        """Epoch-boundary ``glt.store.*`` publication of
        :meth:`epoch_stats` (``glt_tpu`` publishes from its
        ``DiskColdStore``, which is not ported yet)."""
        return publish_store_stats(self.epoch_stats(), namespace)

    def close(self) -> None:
        self._pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def publish_store_stats(stats: dict, namespace: str = "glt.store") -> dict:
    """Publish a stager stats dict as ``<namespace>.*`` gauges.

    Host-side only; no overhead when metrics are disabled.  Returns the
    stats dict for chaining."""
    if _metrics.enabled():
        for k, v in stats.items():
            _metrics.gauge(f"{namespace}.{k}",
                           f"glt_tpu.store tier metric {k}").set(float(v))
    return stats
