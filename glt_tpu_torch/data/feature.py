"""Tiered feature store: device-resident hot rows + host cold rows (cf.
``glt_tpu/data/feature.py``).

* The **hot tier** is one tensor on ``device`` holding the first
  ``int(N * split_ratio)`` rows.  ``id2index`` translates global ids to
  rows (the hotness order of
  :func:`~glt_tpu_torch.data.reorder.sort_by_in_degree`); ``dedup=True``
  fetches each unique row once.
* The **cold tier** stays on the host: a numpy array, or for
  :meth:`Feature.from_store` a :class:`~glt_tpu_torch.store.stager.
  DramStager` over a disk store under an enforced DRAM budget.  A
  tiered gather touches each tier only at its own batch positions: the
  host moves the cold rows alone, through one pinned staging buffer and
  a non-blocking copy, and the device merges them into the hot gather.
* An optional **cold cache** (:meth:`Feature.enable_cold_cache`) keeps
  recently fetched cold rows on the device, so repeat lookups skip the
  host; its counters are read with :meth:`Feature.cache_stats`.
* A **compressed store** (codec bf16 or int8) keeps compressed bytes in
  every tier — the device hot prefix, the stager's DRAM buffer and the
  host→device copy — and decodes on the device: the hot gather through
  kernel B4 (:func:`~glt_tpu_torch.ops.gather_cuda.gather_rows` with a
  ``dequant`` spec), the cold rows after their copy.  ``dtype`` is then
  the logical dtype gathers return (f32), not the storage dtype.

Padding ids (< 0) give zero rows, zeroed AFTER any decode (an int8 zero
code decodes to its column's zero point).  Host id values must fit
int32.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..store import quant
from ..utils.device import DeviceLike, resolve_device
from .feature_cache import cache_init, cache_insert, cache_lookup

_I32_MAX = np.iinfo(np.int32).max
_I32_MIN = np.iinfo(np.int32).min

# numpy -> torch dtype of a stored table when no dtype is given: 64-bit
# inputs narrow to 32 bits, as jax does with 64-bit mode off.
_NARROW = {np.dtype(np.float64): torch.float32,
           np.dtype(np.int64): torch.int32}


def require_int32_ids(ids) -> None:
    """Refuse host id VALUES that overflow int32 (the engine runs int32
    ids; a silent downcast would read the wrong rows)."""
    if isinstance(ids, torch.Tensor):
        return
    a = np.asarray(ids)
    if a.dtype.kind in "iu" and a.dtype.itemsize > 4 and a.size:
        mx, mn = int(a.max()), int(a.min())
        if mx > _I32_MAX or mn < _I32_MIN:
            raise OverflowError(
                f"node ids [{mn}, {mx}] overflow int32; the id space must "
                f"fit int32 (relabel/partition first)")


def _default_dtype(np_dtype) -> torch.dtype:
    dt = np.dtype(np_dtype)
    return _NARROW.get(dt) or quant.torch_dtype_of(dt)


class _HostStage:
    """One pinned host buffer for host->device row copies.  Each copy
    is non-blocking; the buffer is reused only after the previous copy
    has finished (an event wait).  On a CPU device rows are wrapped
    without a copy."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None
        self._done = None

    def to_device(self, host: torch.Tensor) -> torch.Tensor:
        """The CPU tensor ``host`` as a tensor on the device."""
        if self.device.type != "cuda":
            return host
        k = host.shape[0]
        need = max(1, 1 << max(k - 1, 0).bit_length())
        if (self._buf is None or self._buf.shape[0] < need
                or self._buf.shape[1:] != host.shape[1:]
                or self._buf.dtype != host.dtype):
            if self._done is not None:
                self._done.synchronize()
            self._buf = torch.empty((need,) + tuple(host.shape[1:]),
                                    dtype=host.dtype, pin_memory=True)
        elif self._done is not None:
            self._done.synchronize()
        stage = self._buf[:k]
        stage.copy_(host)
        out = stage.to(self.device, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(self.device))
        return out


class Feature:
    """Row-gatherable feature matrix with hot/cold tiering.

    Args:
      feature_array: ``[N, d]`` host array (already hotness-reordered if
        ``id2index`` is given).
      split_ratio: fraction of rows resident on the device (the rest
        stays on the host); 1.0 = all on the device, 0.0 = all on host.
      id2index: optional ``[N]`` indirection from global id to row.
      dtype: optional torch dtype of the gathered rows (e.g.
        ``torch.bfloat16``).
      dedup: gather each unique hot row once (bit-identical output).
      device: where the hot tier lives and gathers land (default
        ``"cuda"``).
    """

    def __init__(self, feature_array: np.ndarray, split_ratio: float = 1.0,
                 id2index: Optional[np.ndarray] = None,
                 dtype: Optional[torch.dtype] = None, dedup: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        arr = np.asarray(feature_array)
        if arr.ndim == 1:
            arr = arr[:, None]
        self._n, self._dim = arr.shape
        self.split_ratio = float(split_ratio)
        self._hot_count = int(self._n * self.split_ratio)
        self.dtype = dtype or _default_dtype(arr.dtype)
        self.dedup = bool(dedup)
        self._quant = None               # compressed stores only
        self._hot = torch.from_numpy(
            np.ascontiguousarray(arr[: self._hot_count])).to(
                device=self.device, dtype=self.dtype)
        # Host tier, a contiguous numpy copy for fast fancy indexing.
        self._cold = np.ascontiguousarray(arr[self._hot_count:])
        self._cold_count = self._cold.shape[0]
        self._cold_np_dtype = self._cold.dtype
        self._set_id2index(id2index)
        self._host_full = arr            # for cpu_get
        self._store = None
        self._stager = None
        self._init_tier_state()

    def _set_id2index(self, id2index) -> None:
        self._id2index_np = (None if id2index is None
                             else np.asarray(id2index, np.int32))
        self._id2index = (None if id2index is None
                          else torch.from_numpy(self._id2index_np).to(
                              self.device))

    def _init_tier_state(self) -> None:
        self.bytes_from_hbm = 0          # hot-tier bytes served (tiered)
        self._cache = None               # optional cold-tier device cache
        self._stage = _HostStage(self.device)

    @classmethod
    def from_store(cls, store, dram_budget_bytes: int,
                   split_ratio: float = 0.0,
                   id2index: Optional[np.ndarray] = None,
                   dtype: Optional[torch.dtype] = None, dedup: bool = False,
                   stage_threads: int = 1,
                   prefetch_scores: Optional[np.ndarray] = None,
                   device: DeviceLike = None) -> "Feature":
        """Features on disk, never all in DRAM.

        The ``split_ratio`` prefix loads to the device once, straight
        from the store (at storage width for a compressed store); every
        other row is served by a
        :class:`~glt_tpu_torch.store.stager.DramStager` under the given,
        enforced DRAM budget.  ``prefetch_scores`` (``[N]`` access
        scores) warms the stager.  A compressed store decodes on the
        device and ``dtype`` is its logical dtype (f32).
        """
        from ..store.stager import DramStager

        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self._n, self._dim = store.num_rows, store.dim
        self.split_ratio = float(split_ratio)
        self._hot_count = int(self._n * self.split_ratio)
        hot_np = store.read_rows(np.arange(self._hot_count, dtype=np.int64))
        spec = store.quant_spec() if hasattr(store, "quant_spec") else None
        self._quant = spec if (spec is not None and spec.is_compressed) \
            else None
        self.dedup = bool(dedup)
        if self._quant is not None:
            self.dtype = dtype or _default_dtype(self._quant.logical_dtype)
            # storage-width hot tier
            self._hot = quant.host_to_torch(hot_np).to(self.device)
        else:
            self.dtype = dtype or _default_dtype(store.dtype)
            self._hot = quant.host_to_torch(hot_np).to(
                device=self.device, dtype=self.dtype)
        self._cold = None                # no DRAM copy of the cold tier
        self._cold_count = self._n - self._hot_count
        self._cold_np_dtype = store.dtype
        self._set_id2index(id2index)
        self._host_full = None           # cpu_get reads the store directly
        self._store = store
        self._stager = DramStager(store, dram_budget_bytes,
                                  stage_threads=stage_threads)
        if prefetch_scores is not None and self._cold_count:
            scores = np.zeros(self._n, np.float64)
            scores[:] = np.asarray(prefetch_scores, np.float64)
            scores[: self._hot_count] = 0.0   # hot prefix never staged
            self._stager.warm(scores)
        self._init_tier_state()
        return self

    def _fetch_cold(self, local_ids: np.ndarray) -> np.ndarray:
        """Cold rows by LOCAL id (0 = first cold row): the DRAM array of
        a plain feature, the DRAM stage or disk of a store-backed one."""
        if self._stager is not None:
            return self._stager.gather(
                np.asarray(local_ids, np.int64) + self._hot_count)
        return self._cold[local_ids]

    def stage_ahead(self, ids) -> None:
        """Hint upcoming global ``ids`` to the DRAM stager (async; a no-op
        for DRAM-resident features)."""
        if self._stager is None:
            return
        ids = np.asarray(ids).reshape(-1)
        ids = ids[ids >= 0].astype(np.int64)
        if self._id2index_np is not None:
            ids = self._id2index_np[ids].astype(np.int64)
        self._stager.stage_ahead(ids[ids >= self._hot_count])

    def store_stats(self) -> Optional[dict]:
        """Tier byte counters of a store-backed feature: the stager's
        counters plus this feature's hot-tier bytes."""
        if self._stager is None:
            return None
        stats = self._stager.stats()
        stats["bytes_from_hbm"] = self.bytes_from_hbm
        return stats

    def close(self) -> None:
        """Release the staging threads of a store-backed feature."""
        if self._stager is not None:
            self._stager.close()

    # -- the device-resident gather ----------------------------------------
    def _gather_hot_impl(self, hot: torch.Tensor,
                         id2index: Optional[torch.Tensor],
                         ids: torch.Tensor) -> torch.Tensor:
        from ..ops.dedup_gather import dedup_gather_rows
        from ..ops.gather_cuda import gather_rows

        ids = ids.to(torch.int32)
        if self.dedup:
            rows = dedup_gather_rows(hot, ids, id2index=id2index)
            if self._quant is not None:
                # Re-zero padding AFTER the decode (decode(0) != 0).
                rows = torch.where((ids >= 0)[:, None],
                                   quant.dequantize(rows, self._quant), 0)
            return rows
        valid = ids >= 0
        idx = torch.where(valid, ids, 0)
        if id2index is not None:
            idx = id2index[idx.clamp(max=id2index.shape[0] - 1).long()]
        rows = gather_rows(hot, idx.contiguous(), dequant=self._quant)
        return torch.where(valid[:, None], rows, 0)

    # -- shape info --------------------------------------------------------
    @property
    def shape(self):
        return (self._n, self._dim)

    @property
    def size(self) -> int:
        return self._n

    @property
    def hot_count(self) -> int:
        return self._hot_count

    @property
    def id2index(self) -> Optional[torch.Tensor]:
        return self._id2index

    @property
    def hot_rows(self) -> torch.Tensor:
        """The device-resident hot tier ``[hot_count, d]`` (at storage
        width for a compressed store)."""
        return self._hot

    @property
    def quant_spec(self):
        """The :class:`~glt_tpu_torch.store.quant.QuantSpec` of a
        compressed store, else None."""
        return self._quant

    # -- cold-tier cache ---------------------------------------------------
    def enable_cold_cache(self, capacity: int) -> None:
        """Attach a device-resident cache of ``capacity`` rows in front of
        the host cold tier (FIFO replacement); tiered gathers then fetch
        only the cache misses from the host, at the cost of one
        device->host read of the ``[B]`` hit mask per gather.

        With no cold tier (``split_ratio == 1.0``) the call warns and does
        nothing; a capacity above the cold-row count clamps to it, with
        a warning.
        """
        if self._cold_count == 0:
            warnings.warn(
                "enable_cold_cache is a no-op at split_ratio == 1.0: "
                "every row is already on the device, there is no cold "
                "tier to cache", RuntimeWarning, stacklevel=2)
            return
        capacity = int(capacity)
        if capacity > self._cold_count:
            warnings.warn(
                f"cold-cache capacity {capacity} exceeds the "
                f"{self._cold_count}-row cold tier; clamping (a larger "
                f"cache can never hold more than every cold row)",
                RuntimeWarning, stacklevel=2)
            capacity = self._cold_count
        self._cache = cache_init(self._cold_count, capacity, self._dim,
                                 self.dtype, device=self.device)

    def cache_stats(self) -> Optional[dict]:
        """Cold-cache hit/miss counters (host sync), or None."""
        if self._cache is None:
            return None
        from .feature_cache import cache_stats as _stats

        return _stats(self._cache)

    # -- gather ------------------------------------------------------------
    def _ids_tensor(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device)
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(ids).astype(np.int32))).to(
                self.device)

    def gather(self, ids) -> torch.Tensor:
        """Rows for global ``ids`` ``[B]`` (tensor or host array, -1
        padded) as ``[B, d]`` on the feature's device.

        A device-resident store gathers on the device.  A tiered store
        reads the ids on the host, gathers the hot rows on the device and
        the cold rows on the host (each tier only at its own positions)
        and merges them on the device.
        """
        require_int32_ids(ids)
        if self._cold_count == 0:
            return self._gather_hot_impl(self._hot, self._id2index,
                                         self._ids_tensor(ids))
        if isinstance(ids, torch.Tensor):
            ids_np = ids.cpu().numpy().astype(np.int64)
        else:
            ids_np = np.asarray(ids).astype(np.int64)
        valid = ids_np >= 0
        idx = np.where(valid, ids_np, 0)
        if self._id2index_np is not None:
            idx = self._id2index_np[idx].astype(np.int64)
        is_hot = idx < self._hot_count
        hot_mask = valid & is_hot
        cold_mask = valid & ~is_hot
        if self._cache is not None:
            return self._gather_tiered_cached(idx, hot_mask, cold_mask)
        cold_pos = np.nonzero(cold_mask)[0]
        # Hot bytes count at the storage width.
        self.bytes_from_hbm += int(hot_mask.sum()) * self._dim \
            * self._hot.element_size()
        cold_np = self._fetch_cold(idx[cold_pos] - self._hot_count)
        return self._merge_tiered(np.where(hot_mask, idx, 0), hot_mask,
                                  cold_pos, cold_np)

    def _cold_rows(self, rows_np: np.ndarray) -> torch.Tensor:
        """Cold rows on the device: they cross at storage width and
        decode there (compressed), or cast to ``dtype`` first (raw)."""
        host = quant.host_to_torch(rows_np)
        if self._quant is not None:
            return quant.dequantize(self._stage.to_device(host),
                                    self._quant)
        return self._stage.to_device(host.to(self.dtype))

    def _hot_part(self, idx_np: np.ndarray, hot_mask_np: np.ndarray,
                  dtype: torch.dtype) -> torch.Tensor:
        """The hot gather at the hot slots, zeros elsewhere."""
        from ..ops.gather_cuda import gather_rows

        b = idx_np.shape[0]
        if self._hot.shape[0] == 0:
            # Fully host-resident (split_ratio == 0).
            return torch.zeros((b, self._dim), dtype=dtype,
                               device=self.device)
        idx = torch.from_numpy(idx_np.astype(np.int32)).to(self.device)
        mask = torch.from_numpy(hot_mask_np).to(self.device)
        rows = gather_rows(self._hot, idx, dequant=self._quant)
        return torch.where(mask[:, None], rows, 0)

    def _merge_tiered(self, idx_np, hot_mask_np, cold_pos_np, cold_np):
        """Device merge: hot gather at hot slots + cold-row scatter."""
        cold = self._cold_rows(cold_np)
        out = self._hot_part(idx_np, hot_mask_np, cold.dtype)
        pos = torch.from_numpy(cold_pos_np.astype(np.int64)).to(
            self.device)
        return out.index_copy_(0, pos, cold.to(out.dtype))

    def _gather_tiered_cached(self, idx, hot_mask, cold_mask):
        """Tiered gather with the device cold cache in front of the host.

        One device->host sync (the hit mask); the host stages only cache
        misses, and the merge inserts them into the cache for the next
        batch.
        """
        cold_ids = np.where(cold_mask, idx - self._hot_count, -1).astype(
            np.int32)
        cold_ids_dev = torch.from_numpy(cold_ids).to(self.device)
        rows_c, hit = cache_lookup(self._cache, cold_ids_dev)
        hit_np = hit.cpu().numpy()                    # the one sync
        miss_mask = cold_mask & ~hit_np
        miss_pos = np.nonzero(miss_mask)[0]
        self.bytes_from_hbm += int(hot_mask.sum()) * self._dim \
            * self._hot.element_size()
        miss_np = self._fetch_cold(idx[miss_pos] - self._hot_count)
        # The cache stores decoded logical rows; only the freshly staged
        # misses decode here.
        cold = self._cold_rows(miss_np)
        out = self._hot_part(np.where(hot_mask, idx, 0), hot_mask,
                             rows_c.dtype)
        out = torch.where(hit[:, None], rows_c.to(out.dtype), out)
        pos = torch.from_numpy(miss_pos.astype(np.int64)).to(self.device)
        out = out.index_copy_(0, pos, cold.to(out.dtype))
        # out at the miss positions holds exactly the fetched cold rows.
        miss_dev = torch.from_numpy(miss_mask).to(self.device)
        cache = cache_insert(self._cache,
                             torch.where(miss_dev, cold_ids_dev, -1), out,
                             miss_dev)
        self._cache = cache._replace(
            hits=cache.hits + hit.sum(dtype=torch.int32),
            misses=cache.misses + miss_dev.sum(dtype=torch.int32))
        return out

    __getitem__ = gather

    def cpu_get(self, ids: np.ndarray) -> np.ndarray:
        """Pure host-side lookup.  A store-backed feature reads the rows
        straight off the disk store (bypassing the stager, so inspection
        never churns its residency) and decodes them on the host."""
        require_int32_ids(ids)
        ids = np.atleast_1d(np.asarray(ids))
        valid = ids >= 0
        idx = np.where(valid, ids, 0)
        if self._id2index_np is not None:
            idx = self._id2index_np[idx]
        if self._host_full is None:
            rows = self._store.read_rows(np.asarray(idx, np.int64))
            if self._quant is not None:
                # Host decode mirrors the device formula; padding rows
                # re-zero below (decode(0) != 0 for int8).
                rows = quant.decode(rows, self._quant)
        else:
            rows = self._host_full[idx]
        return np.where(valid[:, None], rows, 0)

    def __len__(self) -> int:
        return self._n

    def __repr__(self) -> str:
        return (f"Feature(shape={self.shape}, dtype={self.dtype}, "
                f"split_ratio={self.split_ratio}, hot={self._hot_count}, "
                f"device={str(self.device)!r})")
