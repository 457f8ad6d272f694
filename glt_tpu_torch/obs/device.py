"""Per-device memory accounting: gauges, owner classification, leak watch
(cf. ``glt_tpu/obs/device.py``).

This module reads what the *card* reports about its memory and
publishes it through the same ``glt.*`` registry as the rest of the
stack:

* :func:`publish_device_stats` — ``glt.device.*`` gauges per CUDA
  device from ``torch.cuda.memory_stats``: ``bytes_in_use``
  (``allocated_bytes.all.current``), ``peak_bytes``
  (``allocated_bytes.all.peak``), ``num_allocs``
  (``allocation.all.current``), ``bytes_reserved``
  (``reserved_bytes.all.current``), ``bytes_limit`` (the card's total
  memory) and ``largest_alloc`` (the largest live block of the caching
  allocator's snapshot, which ``memory_stats`` does not carry).  Without
  CUDA (the CPU test environment) it publishes **no gauges and never
  raises**: absent data reads as absent, not as zero.
* :func:`snapshot` — classifies the live tensors of registered owners
  (:func:`register_owner`: feature cache, stager, params, serving
  buckets), held through weak references, by owner; the rest of
  ``torch.cuda.memory_allocated()`` lands in ``other``, so the report
  always sums to the live total.  (``glt_tpu`` matches
  ``jax.live_arrays()`` against shape+dtype fingerprints; torch has no
  list of live tensors.)
* :class:`LeakWatch` — epoch-boundary growth detector.  Live bytes
  (``memory_allocated()`` on the card, the registered host buffers'
  bytes otherwise, so the watch works on the CPU) growing monotonically
  across ``epochs`` consecutive boundaries is a leak suspect: a
  ``device.leak_suspect`` flight event and the
  ``glt.device.leak_suspect`` gauge with the growth run length.  The
  gauge clears the moment an epoch stops growing.

Module-level code is stdlib-only; torch is imported inside the calls,
and every entry point degrades to a no-op when a backend call fails:
telemetry must never take the engine down.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from . import flight as _flight
from . import metrics as _metrics

#: ``torch.cuda.memory_stats`` keys published as ``glt.device.<name>``.
_STAT_KEYS = (("allocated_bytes.all.current", "bytes_in_use"),
              ("allocated_bytes.all.peak", "peak_bytes"),
              ("allocation.all.current", "num_allocs"),
              ("reserved_bytes.all.current", "bytes_reserved"))

_lock = threading.Lock()
#: ``(owner, weakref to a tensor)``, in registration order.
_owned: List[Tuple[str, "weakref.ref"]] = []


def register_owner(owner: str, array: Any) -> None:
    """Attribute the storage of ``array`` (a tensor, or a numpy array for
    a host buffer such as the DRAM stager's) to ``owner``; never raises.
    Call at the allocation site; :func:`snapshot` counts the buffer
    under ``owner`` for as long as it is alive.  A storage registered
    twice counts once, under its first owner."""
    try:
        ref = weakref.ref(array)
    except TypeError:     # not a tensor: telemetry must never raise
        return
    with _lock:
        _owned.append((str(owner), ref))


def _live_owned() -> List[Tuple[str, Any]]:
    """Live ``(owner, tensor)`` pairs; dead references are dropped."""
    with _lock:
        live = [(o, r()) for o, r in _owned]
        _owned[:] = [(o, r) for (o, r), (_, t) in zip(_owned, live)
                     if t is not None]
    return [(o, t) for o, t in live if t is not None]


def owners() -> Dict[str, int]:
    """``{owner: live registered tensors}``."""
    out: Dict[str, int] = {}
    for owner, _ in _live_owned():
        out[owner] = out.get(owner, 0) + 1
    return out


def reset_owners_for_tests() -> None:
    with _lock:
        _owned.clear()


def _cuda():
    """``torch`` when a CUDA device is present, else None."""
    try:
        import torch
        return torch if torch.cuda.is_available() else None
    except Exception:  # noqa: BLE001 — telemetry must never raise
        return None


def _largest_block(torch, index: int) -> Optional[int]:
    try:
        sizes = [b["size"] for seg in torch.cuda.memory_snapshot()
                 if seg.get("device") == index
                 for b in seg.get("blocks", ())
                 if b.get("state") == "active_allocated"]
    except Exception:  # noqa: BLE001
        return None
    return max(sizes) if sizes else 0


def _device_stats() -> List[Tuple[str, Dict[str, float]]]:
    """``[(device_str, stats), ...]`` for the CUDA devices, in the
    gauge names; ``[]`` without CUDA."""
    torch = _cuda()
    if torch is None:
        return []
    out: List[Tuple[str, Dict[str, float]]] = []
    for i in range(torch.cuda.device_count()):
        try:
            raw = torch.cuda.memory_stats(i)
            stats = {name: float(raw[key]) for key, name in _STAT_KEYS
                     if key in raw}
            stats["bytes_limit"] = float(
                torch.cuda.get_device_properties(i).total_memory)
        except Exception:  # noqa: BLE001
            continue
        largest = _largest_block(torch, i)
        if largest is not None:
            stats["largest_alloc"] = float(largest)
        out.append((f"cuda:{i}", stats))
    return out


def publish_device_stats() -> Dict[str, float]:
    """Set ``glt.device.*`` gauges from ``torch.cuda.memory_stats``.

    Returns what was published (flat ``{gauge{device=}: value}``).
    Empty, with NO gauges registered, without CUDA.
    """
    published: Dict[str, float] = {}
    for dev, stats in _device_stats():
        for name, v in stats.items():
            g = _metrics.gauge("glt.device." + name,
                               "device memory accounting "
                               "(torch.cuda.memory_stats)",
                               labels={"device": dev})
            g.set(v)
            published[g.full_name] = v
    return published


def peak_bytes_in_use() -> Optional[int]:
    """Max ``max_memory_allocated`` across CUDA devices, else None.

    None (not 0) without CUDA: an unmeasured peak is omitted, not
    published as a fake zero.
    """
    torch = _cuda()
    if torch is None:
        return None
    return max(int(torch.cuda.max_memory_allocated(i))
               for i in range(torch.cuda.device_count()))


def _storage(t: Any) -> Tuple[str, int, int]:
    """``(device, base address, bytes)`` of a tensor's storage or a
    numpy array's buffer."""
    if hasattr(t, "untyped_storage"):
        st = t.untyped_storage()
        return str(t.device), st.data_ptr(), int(st.nbytes())
    return "cpu", t.__array_interface__["data"][0], int(t.nbytes)


def _owner_bytes(on_card: bool) -> Dict[str, Dict[str, int]]:
    """Per-owner ``{count, bytes}`` of the live registered buffers, one
    count per storage: CUDA ones when ``on_card``, host ones otherwise."""
    by_owner: Dict[str, Dict[str, int]] = {}
    seen = set()
    for owner, t in _live_owned():
        try:
            dev, ptr, nbytes = _storage(t)
        except Exception:  # noqa: BLE001
            continue
        if dev.startswith("cuda") != on_card or (dev, ptr) in seen:
            continue
        seen.add((dev, ptr))
        slot = by_owner.setdefault(owner, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += nbytes
    return by_owner


def live_bytes() -> int:
    """Live bytes: ``memory_allocated()`` summed over CUDA devices, the
    registered host buffers' bytes without CUDA."""
    torch = _cuda()
    if torch is not None:
        return int(sum(torch.cuda.memory_allocated(i)
                       for i in range(torch.cuda.device_count())))
    return int(sum(v["bytes"] for v in _owner_bytes(False).values()))


def snapshot() -> Dict[str, Any]:
    """Live memory classified by registered owner.

    ``{"total": {count, bytes}, "owners": {owner: {count, bytes}},
    "devices": {device: stats...}}``.  On the card the owners are the
    registered CUDA tensors, ``total.bytes`` is ``memory_allocated()``
    and ``other`` takes what no owner claims (allocator rounding
    included; its count is unknown and reported as 0), so the owners
    always sum to the total.  Without CUDA the owners are the
    registered host buffers and the total is what they hold.
    """
    on_card = _cuda() is not None
    by_owner = _owner_bytes(on_card)
    count = sum(v["count"] for v in by_owner.values())
    total = sum(v["bytes"] for v in by_owner.values())
    if on_card:
        other = live_bytes() - total
        slot = by_owner.setdefault("other", {"count": 0, "bytes": 0})
        slot["bytes"] += other
        total += other
    return {
        "total": {"count": count, "bytes": int(total)},
        "owners": by_owner,
        "devices": {dev: stats for dev, stats in _device_stats()},
    }


class LeakWatch:
    """Monotonic live-bytes growth across epoch boundaries.

    Call :meth:`observe_epoch` once per epoch.  ``epochs`` consecutive
    boundary-to-boundary increases flag a suspect; the gauge carries
    the current growth-run length (0 when healthy) so dashboards see
    both the binary state and how long the climb has lasted.
    """

    def __init__(self, epochs: int = 3, min_growth_bytes: int = 1):
        self.epochs = max(int(epochs), 1)
        self.min_growth_bytes = max(int(min_growth_bytes), 1)
        self._last: Optional[int] = None
        self._run = 0
        self._lock = threading.Lock()
        self._gauge = _metrics.gauge(
            "glt.device.leak_suspect",
            "consecutive epochs of live-bytes growth "
            "(>= leak-watch threshold => suspect)")

    def observe_epoch(self, live: Optional[int] = None) -> Dict[str, Any]:
        """Record one epoch boundary; returns the watch state."""
        try:
            live = live_bytes() if live is None else int(live)
        except Exception:  # noqa: BLE001
            return {"live_bytes": None, "run": 0, "suspect": False}
        with self._lock:
            grew = (self._last is not None
                    and live - self._last >= self.min_growth_bytes)
            self._run = self._run + 1 if grew else 0
            self._last = live
            run = self._run
        suspect = run >= self.epochs
        self._gauge.set(run if suspect else 0)
        if suspect:
            _flight.record("device.leak_suspect", live_bytes=live,
                           growth_epochs=run, threshold=self.epochs)
        return {"live_bytes": live, "run": run, "suspect": suspect}

    def reset(self) -> None:
        with self._lock:
            self._last = None
            self._run = 0
        self._gauge.set(0)


#: Process-default watch, wired at the scanned-epoch boundary
#: (models/train.py); tests construct their own instances.
_default_watch = LeakWatch()


def observe_epoch() -> Dict[str, Any]:
    """Epoch-boundary hook: default leak watch + device gauges."""
    publish_device_stats()
    return _default_watch.observe_epoch()
