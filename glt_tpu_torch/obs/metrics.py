"""Metrics registry: counters / gauges / histograms, one namespace.

Unifies the engine's scattered stats — ``feature_cache.cache_stats``,
``RemoteNeighborLoader.epoch_stats``, routing/collective timings,
reconnect/lease/replay-window counters — under dotted ``glt.*`` names
(catalog: docs/observability.md).  Design constraints, in order:

  1. **Near-zero cost when disabled.**  Metrics are OFF by default; a
     disabled ``Counter.inc()`` is one module-global read and a branch
     (~100 ns on a host CPU).
  2. **Host-side only.**  Never call these inside a function that a
     CUDA graph captures: the Python call runs once at capture time and
     no replay repeats it.
     Device-side quantities ride as device scalars (the feature cache's
     hit/miss counters) and are *published* here from host code after a
     sync point.
  3. **Stdlib only.**  No torch/numpy imports — usable from the analysis
     CI image and from pure-host tooling.

Instruments are process-global and identified by ``(kind, name,
labels)``; re-requesting one returns the same object, so modules create
them at import time and hot loops pay only the method call.  A
Prometheus-style text exposition (:func:`render_prometheus`) gives the
registry as one text page, in ``glt_tpu``'s format line for line.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

_enabled = False


def enable() -> None:
    """Turn metric recording on, process-wide."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn metric recording off (instruments keep their values)."""
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


# Geometric-ish latency buckets in milliseconds: spans the ~0.1 ms
# dispatch floor through multi-second epochs.
DEFAULT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 10000.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Mapping[str, str]]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = ""

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.help = help
        self.labels: Dict[str, str] = dict(labels or {})
        self._lock = threading.Lock()

    def _suffix(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
        return "{" + inner + "}"

    @property
    def full_name(self) -> str:
        return self.name + self._suffix()


class Counter(_Instrument):
    """Monotonic count (``inc``).  Snapshot value: the running total."""
    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Instrument):
    """Point-in-time value (``set`` / ``inc``)."""
    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _Timer:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe((time.perf_counter() - self._t0) * 1e3)
        return False


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics).

    ``observe(v)`` records one value; ``time()`` is a context manager
    observing the block's wall time in **milliseconds** (a shared no-op
    object when disabled, so instrumented loops pay nothing).
    """
    kind = "histogram"

    def __init__(self, name, help="", labels=None,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def time(self):
        if not _enabled:
            return _NULL_TIMER
        return _Timer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1) by linear interpolation
        within the cumulative buckets (Prometheus
        ``histogram_quantile`` semantics).

        The estimate lands inside the bucket containing the target rank,
        interpolated between the bucket's bounds (lower bound 0 for the
        first bucket); ranks in the +Inf tail return the highest finite
        bucket edge.  NaN on an empty histogram.
        """
        with self._lock:
            counts = list(self._counts)
        return quantile_from_counts(self.buckets, counts, q)


def quantile_from_counts(buckets: Tuple[float, ...],
                         counts: List[int], q: float) -> float:
    """Quantile over raw per-bucket counts (``len(buckets) + 1`` entries,
    +Inf tail last) — the interpolation :meth:`Histogram.quantile` and
    the SLO monitor's windowed bucket deltas share.  NaN when empty."""
    q = min(max(float(q), 0.0), 1.0)
    count = sum(counts)
    if count == 0:
        return float("nan")
    target = q * count
    cum = 0.0
    for i, c in enumerate(counts[:-1]):
        prev = cum
        cum += c
        if cum >= target and c > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            hi = buckets[i]
            return lo + (hi - lo) * (target - prev) / c
    return buckets[-1]


class Registry:
    """Process-global instrument table, keyed by ``(kind, name, labels)``."""

    def __init__(self):
        self._table: Dict[Tuple[str, str, _LabelKey], _Instrument] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            inst = self._table.get(key)
            if inst is None:
                inst = cls(name, help=help, labels=labels, **kw)
                self._table[key] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Mapping[str, str]] = None,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def instruments(self) -> List[_Instrument]:
        with self._lock:
            return list(self._table.values())

    def reset(self) -> None:
        """Zero every instrument IN PLACE (tests).

        Module-level instruments are created once at import and held by
        the hot paths forever; dropping the table would silently detach
        those live handles from every later snapshot, so reset clears
        values, not registrations.
        """
        for inst in self.instruments():
            with inst._lock:
                if isinstance(inst, Histogram):
                    inst._counts = [0] * (len(inst.buckets) + 1)
                    inst._sum = 0.0
                    inst._count = 0
                else:
                    inst._value = 0.0

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name[{labels}]: value}`` view; histograms contribute
        ``<name>.count`` and ``<name>.sum`` plus derived
        ``.p50/.p95/.p99`` latency quantiles once they hold samples —
        the SLO read a serving benchmark wants without
        re-deriving from buckets."""
        out: Dict[str, float] = {}
        for inst in self.instruments():
            if isinstance(inst, Histogram):
                out[inst.full_name + ".count"] = float(inst.count)
                out[inst.full_name + ".sum"] = float(inst.sum)
                if inst.count:
                    out[inst.full_name + ".p50"] = inst.quantile(0.50)
                    out[inst.full_name + ".p95"] = inst.quantile(0.95)
                    out[inst.full_name + ".p99"] = inst.quantile(0.99)
            else:
                out[inst.full_name] = float(inst.value)
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        by_name: Dict[str, List[_Instrument]] = {}
        for inst in self.instruments():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            pname = _prom_name(name)
            kind = group[0].kind
            if kind == "counter":
                pname += "_total"
            help_text = next((g.help for g in group if g.help), "")
            if help_text:
                lines.append(f"# HELP {pname} {help_text}")
            lines.append(f"# TYPE {pname} {kind}")
            for inst in group:
                if isinstance(inst, Histogram):
                    base = _prom_name(inst.name)
                    acc = 0
                    for b, c in zip(inst.buckets, inst._counts):
                        acc += c
                        lines.append(
                            f'{base}_bucket{{{_prom_labels(inst, le=b)}}}'
                            f" {acc}")
                    lines.append(
                        f'{base}_bucket{{{_prom_labels(inst, le="+Inf")}}}'
                        f" {inst.count}")
                    lines.append(f"{base}_sum{_prom_label_suffix(inst)}"
                                 f" {inst.sum}")
                    lines.append(f"{base}_count{_prom_label_suffix(inst)}"
                                 f" {inst.count}")
                else:
                    lines.append(
                        f"{pname}{_prom_label_suffix(inst)} {inst.value}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _escape_label_value(v: str) -> str:
    # Text exposition format 0.0.4: inside a quoted label value,
    # backslash, double-quote, and line-feed must be escaped (backslash
    # FIRST, or the other escapes get double-escaped).
    return (v.replace("\\", r"\\")
             .replace('"', r"\"")
             .replace("\n", r"\n"))


def _prom_labels(inst: _Instrument, **extra) -> str:
    items = dict(inst.labels)
    items.update({k: str(v) for k, v in extra.items()})
    return ",".join(f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in sorted(items.items()))


def _prom_label_suffix(inst: _Instrument) -> str:
    if not inst.labels:
        return ""
    return "{" + _prom_labels(inst) + "}"


#: The process-global registry every module-level instrument lands in.
REGISTRY = Registry()


def counter(name: str, help: str = "",
            labels: Optional[Mapping[str, str]] = None) -> Counter:
    return REGISTRY.counter(name, help=help, labels=labels)


def gauge(name: str, help: str = "",
          labels: Optional[Mapping[str, str]] = None) -> Gauge:
    return REGISTRY.gauge(name, help=help, labels=labels)


def histogram(name: str, help: str = "",
              labels: Optional[Mapping[str, str]] = None,
              buckets: Tuple[float, ...] = DEFAULT_BUCKETS_MS) -> Histogram:
    return REGISTRY.histogram(name, help=help, labels=labels,
                              buckets=buckets)


def snapshot() -> Dict[str, float]:
    return REGISTRY.snapshot()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()


def prune_unmeasured(d: Mapping[str, object]) -> Dict[str, object]:
    """Drop unmeasured (``None``) entries from a metrics mapping.

    The JSON contract of a benchmark line: a metric that was not
    measured this run is OMITTED, never emitted as an in-band sentinel
    such as ``-1.0`` (downstream consumers can't tell "not measured"
    from a measured negative).
    """
    return {k: v for k, v in d.items() if v is not None}
