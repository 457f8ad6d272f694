"""Graph-safe stage spans and device counters: time and counts inside a
CUDA graph, measured by the card itself.

A host span (:mod:`.trace`) cannot see into a captured block: its Python
runs once, at the capture, and a replay runs none.  A **stage** records
its boundaries on the device instead.  A boundary is one launch of a
one-thread kernel (``csrc/stamp.cu``) that reads the card's global timer
and appends ``(tag, ns)`` to a device ring at a device-side cursor; the
tag names the boundary's mark and the stream lane it was recorded on.  A
graph that captured the launches appends again at every replay, in
stream order, with no host involvement.  The ring is read once, by
:func:`read` (the tracer's export calls it), and the marks are paired
back into spans per lane, in the order the card appended them.

    with obs.stage("sampler.init", device=dev) as st:
        ...                                # the dense map, the seeds
        for hop in range(len(fanouts)):
            st.next("sampler.draw", hop=hop)   # one shared boundary
            ...
        st.next("sampler.finish")
        ...

* **On or off at the moment the code runs.**  The device half runs when
  a tracer is installed (:func:`.trace.start_trace`) at the moment the
  code runs eagerly, or at the moment a graph captures it.  With no
  tracer, :func:`stage` returns the shared no-op (one global read) and
  :func:`device_counter` a no-op counter, so a graph captured with
  tracing off holds no stamp and no counter node, and one captured with
  it on keeps them for its lifetime (the ring and the counters are never
  freed).
* **Eager, a stage is also a host span** of the same name and attributes
  on the installed tracer (and so a ``torch.profiler`` range while the
  profiler records); inside a capture it opens none.  The host span
  leaves out the stamps' own launches.
* ``st.next(name, **attrs)`` closes the stage and opens its sibling at
  ONE stamp: adjacent stages share a boundary, to keep the in-graph cost
  down.
* **Lost entries.**  The ring holds :data:`RING_ENTRIES` entries and is
  allocated at the first stamp on a device (outside any capture: inside
  one, on a helper thread).  Past that the newest overwrite the oldest;
  :func:`read` counts them as ``lost``, and the marks whose partner was
  lost as ``unmatched``.
* **Device counters** (:func:`device_counter`): a persistent int64
  scalar per name and device that code, captured or not, increments in
  place (``add_``); :func:`.metrics.snapshot` reads them with one
  device-to-host copy a device.  Compute the increment only under
  :func:`tracing`, so that tracing off adds no kernel.
* **On the CPU** the device half stamps the host clock
  (``perf_counter_ns``, the tracer's own) into a ring of the same layout,
  so all of the bookkeeping runs without a card.

Module-level code is stdlib-only; torch is imported at the first stamp.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace

#: Entries of a device's stamp ring (16 bytes each).
RING_ENTRIES = 1 << 20
#: Chrome-trace thread id of stamp lane 0 in the tracer's export.
DEVICE_TID_BASE = 1 << 30

_BEGIN, _END, _NEXT = 0, 1, 2

_lock = threading.Lock()
_stage_ids: Dict[tuple, int] = {}       # (name, attrs) -> stage id
_stage_of: List[Tuple[str, dict]] = []  # stage id -> (name, attrs)
_lanes: Dict[tuple, int] = {}           # (device, stream) -> lane
_lane_dev: List[str] = []               # lane -> device
_rings: Dict[str, "_Ring"] = {}         # device -> ring
_probes: Dict[str, "_Ring"] = {}        # device -> one-entry clock probe
_counters: Dict[Tuple[str, str], Any] = {}   # (name, device) -> tensor


def tracing() -> bool:
    """Whether a tracer is installed: the on/off switch of every stage
    and device counter (one global read)."""
    return _trace._current is not None


def _device(torch, device):
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _capturing(torch, dev) -> bool:
    return dev.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _allocate(torch, dev, make):
    """``make()`` on ``dev``, never inside a capture: a capturing thread
    may not allocate outside the graph's pool, nor launch a fill that
    only the graph would run, so a helper thread builds it on its own
    stream and waits for it."""
    if not _capturing(torch, dev):
        return make()
    box: Dict[str, Any] = {}

    def work():
        try:
            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                with torch.cuda.stream(side):
                    box["value"] = make()
                side.synchronize()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            box["error"] = exc

    t = threading.Thread(target=work, name="glt-obs-alloc", daemon=True)
    t.start()
    while t.is_alive():     # the helper ends when its allocation does
        t.join(timeout=1.0)
    if "error" in box:
        raise box["error"]
    return box["value"]


class _Ring:
    """``buf`` int64 ``[capacity, 2]`` of ``(tag, ns)`` and ``cursor``,
    the entries ever appended, on one device."""

    def __init__(self, torch, dev, capacity: int):
        self.dev = dev
        self.capacity = int(capacity)
        self.cuda = dev.type == "cuda"
        self.buf, self.cursor = _allocate(torch, dev, lambda: (
            torch.zeros((self.capacity, 2), dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev)))

    def stamp(self, torch, tag: int) -> None:
        if self.cuda:
            from ..ops import cuda_lib

            lib = cuda_lib.library()
            with torch.cuda.device(self.dev):
                status = lib.glt_stamp(
                    self.buf.data_ptr(), self.cursor.data_ptr(),
                    self.capacity, tag,
                    torch.cuda.current_stream(self.dev).cuda_stream)
            cuda_lib.check(status, "stamp")
            return
        i = int(self.cursor[0])
        slot = i % self.capacity
        self.buf[slot, 0] = tag
        self.buf[slot, 1] = time.perf_counter_ns()
        self.cursor[0] = i + 1

    def entries(self) -> Tuple[List[List[int]], int]:
        """``([tag, ns]`` rows in append order, entries lost to
        wrap-around); waits for the device."""
        import torch

        if self.cuda:
            torch.cuda.synchronize(self.dev)
        n = int(self.cursor[0].item())
        cap = self.capacity
        if n <= cap:
            rows = self.buf[:n]
        else:
            start = n % cap
            rows = torch.cat([self.buf[start:], self.buf[:start]])
        return rows.cpu().tolist(), max(0, n - cap)


def _ring(torch, dev) -> _Ring:
    key = str(dev)
    ring = _rings.get(key)
    if ring is None:
        # Built outside the lock (it may wait for a helper thread); a
        # racing second build is dropped unused.
        new = _Ring(torch, dev, RING_ENTRIES)
        with _lock:
            ring = _rings.setdefault(key, new)
    return ring


def _lane(torch, dev) -> int:
    handle = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else threading.get_ident())
    key = (str(dev), handle)
    lane = _lanes.get(key)
    if lane is None:
        with _lock:
            lane = _lanes.get(key)
            if lane is None:
                lane = _lanes[key] = len(_lane_dev)
                _lane_dev.append(str(dev))
    return lane


def _stage_id(name: str, attrs: dict) -> int:
    key = (name, tuple(sorted(attrs.items())))
    sid = _stage_ids.get(key)
    if sid is None:
        with _lock:
            sid = _stage_ids.get(key)
            if sid is None:
                sid = _stage_ids[key] = len(_stage_of)
                _stage_of.append((name, dict(attrs)))
    return sid


class Stage:
    """One graph-safe stage (see :func:`stage`); a context manager."""

    __slots__ = ("_tracer", "name", "_attrs", "_device", "_ring", "_lane",
                 "_host")

    def __init__(self, tracer, name: str, device, attrs: dict):
        self._tracer = tracer
        self.name = name
        self._attrs = attrs
        self._device = device
        self._host = None

    def _stamp(self, torch, op: int) -> None:
        sid = _stage_id(self.name, self._attrs)
        self._ring.stamp(torch, (self._lane << 32) | (sid << 2) | op)

    def _open_host(self, eager: bool) -> None:
        if eager:
            self._host = self._tracer.span(self.name, **self._attrs)
            self._host.__enter__()

    def _close_host(self, exc=(None, None, None)) -> bool:
        host, self._host = self._host, None
        if host is not None:
            host.__exit__(*exc)
        return host is not None

    def __enter__(self) -> "Stage":
        import torch

        dev = _device(torch, self._device)
        self._device = dev
        self._ring = _ring(torch, dev)
        self._lane = _lane(torch, dev)
        self._stamp(torch, _BEGIN)
        self._open_host(not _capturing(torch, dev))
        return self

    def next(self, name: str, **attrs) -> None:
        """Close this stage and open its sibling ``name`` at one shared
        boundary stamp."""
        import torch

        eager = self._close_host()
        self.name, self._attrs = name, attrs
        self._stamp(torch, _NEXT)
        self._open_host(eager)

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._close_host((exc_type, exc, tb))
        if exc_type is None:
            import torch

            self._stamp(torch, _END)
        return False


class _NullStage:
    """Shared no-op stage served while no tracer is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def next(self, name, **attrs):
        pass


NULL_STAGE = _NullStage()


def stage(name: str, device=None, **attrs):
    """A graph-safe stage on ``device`` (default: the current CUDA device
    once CUDA is initialised, else the CPU) — the shared no-op when no
    tracer is installed.  Legal inside code a CUDA graph captures."""
    tracer = _trace._current
    if tracer is None:
        return NULL_STAGE
    return Stage(tracer, name, device, attrs)


# -- device counters ---------------------------------------------------------

class _NullCounter:
    """No-op counter served while no tracer is installed."""

    __slots__ = ()

    def add_(self, other):
        return self


_NULL_COUNTER = _NullCounter()


def device_counter(name: str, device=None, labels=None):
    """The persistent int64 scalar counter ``name`` on ``device`` (the
    no-op counter when no tracer is installed); increment it in place
    with ``add_``, captured or not.  ``labels`` (a mapping) make it its
    own counter, read as ``name{k=v,...}`` as the metrics registry
    names a labelled instrument."""
    if _trace._current is None:
        return _NULL_COUNTER
    import torch

    if labels:
        name += "{" + ",".join(f"{k}={v}" for k, v in
                               sorted(labels.items())) + "}"
    dev = _device(torch, device)
    key = (name, str(dev))
    c = _counters.get(key)
    if c is None:
        new = _allocate(torch, dev, lambda: torch.zeros(
            (), dtype=torch.int64, device=dev))
        with _lock:
            c = _counters.setdefault(key, new)
    return c


def counter_values() -> Dict[str, float]:
    """``{name: value}`` of every device counter, summed over devices: one
    device-to-host copy a device."""
    if not _counters:
        return {}
    import torch

    by_dev: Dict[str, List[Tuple[str, Any]]] = {}
    for (name, dev), t in list(_counters.items()):
        by_dev.setdefault(dev, []).append((name, t))
    out: Dict[str, float] = {}
    for items in by_dev.values():
        vals = torch.stack([t for _, t in items]).tolist()
        for (name, _), v in zip(items, vals):
            out[name] = out.get(name, 0.0) + float(v)
    return out


def reset() -> None:
    """Empty every ring and zero every counter, in place (the graphs that
    captured them keep their pointers)."""
    for ring in list(_rings.values()):
        ring.cursor.zero_()
    for t in list(_counters.values()):
        t.zero_()


_metrics.add_source(counter_values, reset)


# -- reading -----------------------------------------------------------------

def _pair(rows) -> Tuple[List[tuple], int, int]:
    """``(spans, unmatched, still_open)`` of ``(tag, ns)`` rows in append
    order; a span is ``(lane, depth, stage id, t0, t1)``."""
    stacks: Dict[int, List[Tuple[int, int]]] = {}
    spans: List[tuple] = []
    unmatched = 0
    for tag, ns in rows:
        lane, mark = tag >> 32, tag & 0xFFFFFFFF
        sid, op = mark >> 2, mark & 3
        st = stacks.setdefault(lane, [])
        if op == _BEGIN:
            st.append((sid, ns))
        elif op == _NEXT:
            if st:
                prev, t0 = st.pop()
                spans.append((lane, len(st), prev, t0, ns))
            else:
                unmatched += 1          # its opening stamp was lost
            st.append((sid, ns))
        elif st and st[-1][0] == sid:
            prev, t0 = st.pop()
            spans.append((lane, len(st), prev, t0, ns))
        elif any(s == sid for s, _ in st):
            while st[-1][0] != sid:     # inner stages whose end was lost
                st.pop()
                unmatched += 1
            prev, t0 = st.pop()
            spans.append((lane, len(st), prev, t0, ns))
        else:
            unmatched += 1              # its opening stamp was lost
    return spans, unmatched, sum(len(s) for s in stacks.values())


def _clock_offset(torch, dev) -> int:
    """Host ``perf_counter_ns`` minus the device's stamp clock: one stamp
    under a synchronize, the tightest of five, paired with the host
    clock's midpoint around it (0 on the CPU, whose stamps are host
    times)."""
    if dev.type != "cuda":
        return 0
    key = str(dev)
    probe = _probes.get(key)
    if probe is None:
        probe = _probes[key] = _Ring(torch, dev, 1)
    best = None
    for _ in range(5):
        torch.cuda.synchronize(dev)
        h0 = time.perf_counter_ns()
        probe.stamp(torch, 0)
        torch.cuda.synchronize(dev)
        h1 = time.perf_counter_ns()
        d = int(probe.buf[0, 1].item())
        if best is None or h1 - h0 < best[0]:
            best = (h1 - h0, (h0 + h1) // 2 - d)
    return best[1]


class Reading:
    """The stage spans of every ring, read once.

    ``spans``: dicts of ``name``, ``attrs``, ``device``, ``lane``,
    ``depth``, ``t0_ns``/``t1_ns`` (device clock) and ``host_t0_ns`` (the
    host ``perf_counter_ns`` clock); ``lost``: entries overwritten before
    the read; ``unmatched``: marks whose partner is missing; ``open``:
    stages begun and not yet ended."""

    def __init__(self):
        self.spans: List[dict] = []
        self.lost = 0
        self.unmatched = 0
        self.open = 0

    def totals(self) -> Dict[str, float]:
        """Seconds of device time in each stage, by name."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s["name"]] = (out.get(s["name"], 0.0)
                              + (s["t1_ns"] - s["t0_ns"]) / 1e9)
        return out

    def counts(self) -> Dict[str, int]:
        """Spans of each stage, by name."""
        out: Dict[str, int] = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0) + 1
        return out


def read() -> Reading:
    """Every ring's stage spans, also on the host clock (waits for each
    device, then one synchronised probe stamp a device)."""
    out = Reading()
    if not _rings:
        return out
    import torch

    for key, ring in list(_rings.items()):
        rows, lost = ring.entries()
        offset = _clock_offset(torch, ring.dev)
        spans, unmatched, still_open = _pair(rows)
        out.lost += lost
        out.unmatched += unmatched
        out.open += still_open
        for lane, depth, sid, t0, t1 in spans:
            name, attrs = _stage_of[sid]
            out.spans.append({"name": name, "attrs": attrs, "device": key,
                              "lane": lane, "depth": depth, "t0_ns": t0,
                              "t1_ns": t1, "host_t0_ns": t0 + offset})
    return out


def device_events(tracer) -> Tuple[List[dict], List[dict], dict]:
    """The device track of ``tracer``'s export: metadata naming one
    thread a lane, each stage span since the tracer started as a
    complete event on the tracer's clock, and the read's loss counts."""
    if not _rings:
        return [], [], {}
    r = read()
    events: List[dict] = []
    lanes = set()
    for s in r.spans:
        ts_ns = s["host_t0_ns"] - tracer._t0_ns
        if ts_ns < 0:
            continue
        lanes.add(s["lane"])
        events.append({
            "name": s["name"], "ph": "X", "cat": "glt.device",
            "ts": round(ts_ns / 1e3, 3),
            "dur": round((s["t1_ns"] - s["t0_ns"]) / 1e3, 3),
            "pid": tracer.pid, "tid": DEVICE_TID_BASE + s["lane"],
            "args": dict(s["attrs"], device=s["device"], lane=s["lane"],
                         depth=s["depth"])})
    meta = [{"name": "thread_name", "ph": "M", "pid": tracer.pid,
             "tid": DEVICE_TID_BASE + lane,
             "args": {"name": f"device stages {_lane_dev[lane]} "
                              f"lane {lane}"}} for lane in sorted(lanes)]
    return meta, events, {"device_lost": r.lost,
                          "device_unmatched": r.unmatched}


def reset_for_tests() -> None:
    """Drop every ring, counter, mark and lane (a graph captured before
    keeps pointers into the dropped ones: tests only)."""
    with _lock:
        _rings.clear()
        _probes.clear()
        _counters.clear()
        _stage_ids.clear()
        _stage_of.clear()
        _lanes.clear()
        _lane_dev.clear()
