"""Cross-batch device-resident feature-row cache (cf.
``glt_tpu/data/feature_cache.py``).

A :class:`FeatureCacheState` keeps recently fetched rows of a backing
store on the device, so repeat lookups (hub nodes under power-law
sampling) skip the host.  Replacement is FIFO over a clock hand: misses
claim consecutive slots, evicting the oldest resident (the id->slot
entry of the evicted id is cleared in the same pass).  Hit/miss counters
are device scalars, read with :func:`publish_cache_stats` (which also
publishes them as ``glt.cache.*`` gauges) or its alias
:func:`cache_stats`.

Layout (``C`` = capacity, ``N`` = id space, ``d`` = row width):
  * ``table``    ``[C + 1, d]``  cached rows; row ``C`` absorbs masked
    writes (the dump row; its content is never read as a hit).
  * ``slot_ids`` ``[C + 1]``     global id resident in each slot (-1 empty).
  * ``id2slot``  ``[N + 2]``     id -> slot (-1 absent); entry ``N`` is the
    padding read slot (never written, always -1), entry ``N + 1`` the
    write dump.
  * ``clock/hits/misses``        int32 device scalars.

Where ``glt_tpu`` returns fresh arrays, :func:`cache_insert` updates the
state's tensors in place (the cache table is the large one) and returns
the state with its new scalars: a state passed in is consumed.  Scatter
discipline: an id wanted twice in one insert claims two slots as in
``glt_tpu``, and only its last position writes ``id2slot`` (the write
XLA's last-wins scatter keeps), so the CPU and the card agree.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..obs import device as _device
from ..obs import metrics as _metrics
from ..utils.device import DeviceLike, resolve_device

_INT32_MAX = 2**31 - 1


class FeatureCacheState(NamedTuple):
    table: torch.Tensor     # [C + 1, d]
    slot_ids: torch.Tensor  # [C + 1] int32
    id2slot: torch.Tensor   # [N + 2] int32
    clock: torch.Tensor     # [] int32 FIFO hand
    hits: torch.Tensor      # [] int32 cumulative
    misses: torch.Tensor    # [] int32 cumulative

    @property
    def capacity(self) -> int:
        return self.slot_ids.shape[0] - 1

    @property
    def dim(self) -> int:
        return self.table.shape[-1]


def cache_init(num_ids: int, capacity: int, dim: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> FeatureCacheState:
    """Empty cache over an id space of ``num_ids`` global ids."""
    if capacity <= 0:
        raise ValueError(f"cache capacity must be positive, got {capacity}")
    dev = resolve_device(device)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    table = torch.zeros((capacity + 1, dim), dtype=dtype, device=dev)
    _device.register_owner("feature_cache", table)
    return FeatureCacheState(
        table=table,
        slot_ids=torch.full((capacity + 1,), -1, dtype=torch.int32,
                            device=dev),
        id2slot=torch.full((num_ids + 2,), -1, dtype=torch.int32,
                           device=dev),
        clock=zero, hits=zero.clone(), misses=zero.clone())


def cache_lookup(state: FeatureCacheState, ids: torch.Tensor):
    """Probe the cache for ``ids`` (-1 = padding), read-only.

    Returns ``(rows, hit)``: ``[M, d]`` rows (zeros at misses and
    padding) and the ``[M]`` bool hit mask.  The hit read is a row
    gather over the cache table, through the same gather as the backing
    store (kernel B2 on the card).
    """
    from ..ops.gather_cuda import gather_rows

    n = state.id2slot.shape[0] - 2
    ids = ids.to(torch.int32)
    valid = ids >= 0
    probe = torch.where(valid, ids.clamp(0, max(n - 1, 0)), n)
    slot = state.id2slot[probe.long()]
    hit = valid & (slot >= 0)
    c_dump = state.table.shape[0] - 1
    rows = gather_rows(state.table,
                       torch.where(hit, slot, c_dump).contiguous())
    return torch.where(hit[:, None], rows, 0), hit


def _last_positions(keys: torch.Tensor) -> torch.Tensor:
    """``[M]`` bool: position ``i`` holds the last occurrence of its key."""
    m = keys.shape[0]
    if m == 0:
        return torch.zeros(0, dtype=torch.bool, device=keys.device)
    sorted_keys, perm = torch.sort(keys, stable=True)
    nxt = torch.cat([sorted_keys[1:], sorted_keys.new_full((1,), -2)])
    last = torch.empty(m, dtype=torch.bool, device=keys.device)
    last[perm] = sorted_keys != nxt
    return last


def cache_insert(state: FeatureCacheState, ids: torch.Tensor,
                 rows: torch.Tensor, want: torch.Tensor
                 ) -> FeatureCacheState:
    """Insert ``rows`` for ``ids`` where ``want`` (FIFO eviction), in
    place.

    Contract: the wanted ids are NOT currently resident (``want`` is a
    subset of a fresh lookup's miss mask).  If more ids are wanted than
    the capacity, only the first ``C`` (in position order) are inserted.
    Counters are untouched (see :func:`cache_gather`).
    """
    cap = state.slot_ids.shape[0] - 1
    n = state.id2slot.shape[0] - 2
    ids = ids.to(torch.int32)
    do = want & (ids >= 0)
    rank = torch.cumsum(do.to(torch.int32), 0, dtype=torch.int32) - 1
    do = do & (rank < cap)
    slot = torch.remainder(state.clock + rank, cap).to(torch.int32)
    wslot = torch.where(do, slot, cap).long()
    # Evict: clear the id->slot entry of each claimed slot's resident.
    evicted = torch.where(do, state.slot_ids[wslot], -1)
    # index_fill_ takes -1 by value: no host->device copy, so a CUDA
    # graph can capture the insert.
    state.id2slot.index_fill_(
        0, torch.where(evicted >= 0, evicted, n + 1).long(), -1)
    sets = do & _last_positions(torch.where(do, ids, _INT32_MAX))
    state.id2slot[torch.where(sets, ids, n + 1).long()] = torch.where(
        sets, slot, -1)
    state.slot_ids[wslot] = torch.where(do, ids, -1)
    # Masked positions all write the dump row C, whose content is never
    # read as a hit.
    state.table[wslot] = rows.to(state.table.dtype)
    clock = torch.remainder(state.clock + do.sum(dtype=torch.int32),
                            cap).to(torch.int32)
    return state._replace(clock=clock)


def cache_gather(state: FeatureCacheState, ids: torch.Tensor,
                 fetch: Callable[[torch.Tensor], torch.Tensor]):
    """Serve UNIQUE ``ids`` through the cache; fetch misses via ``fetch``.

    ``fetch(masked_ids) -> [M, d]`` gathers from the backing store with
    the padding contract (negative id -> zero row); hits and padding
    arrive as -1, so the backing store is touched only for misses.
    Returns ``(state', rows)`` with the fetched rows inserted and the
    counters bumped.  ``ids`` must be duplicate-free among its valid
    entries.
    """
    rows_hit, hit = cache_lookup(state, ids)
    miss = (ids >= 0) & ~hit
    fetched = fetch(torch.where(miss, ids, -1))
    rows = torch.where(hit[:, None], rows_hit,
                       fetched.to(rows_hit.dtype))
    state = cache_insert(state, ids, fetched, miss)
    return state._replace(
        hits=state.hits + hit.sum(dtype=torch.int32),
        misses=state.misses + miss.sum(dtype=torch.int32)), rows


def publish_cache_stats(state: FeatureCacheState,
                        namespace: str = "glt.cache") -> dict:
    """Host copy of the counters, also published as ``glt.cache.*``
    gauges when metrics are enabled (a sync: call outside timed
    regions)."""
    h = int(state.hits)
    m = int(state.misses)
    stats = {
        "hits": h,
        "misses": m,
        "lookups": h + m,
        "hit_rate": h / max(h + m, 1),
        "capacity": state.capacity,
        "resident": int((state.slot_ids[:-1] >= 0).sum()),
    }
    if _metrics.enabled():
        for k, v in stats.items():
            _metrics.gauge(f"{namespace}.{k}",
                           "feature cache counter (device-scalar fetch)"
                           ).set(v)
    return stats


def cache_stats(state: FeatureCacheState) -> dict:
    """Alias of :func:`publish_cache_stats`."""
    return publish_cache_stats(state)
