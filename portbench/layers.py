"""The profiled stretch's idle gaps put down to the program's layers.

With the program's tracer installed, every host span of
``glt_tpu_torch.obs`` is also a ``torch.profiler`` range of its name
(cat ``user_annotation``) on the thread that opened it, on the trace's
own clock.  :func:`idle_by_layer` takes the traced window and its idle
gaps exactly as :func:`portbench.trace.summarize` does (from the first
``portbench.block`` range to the end of the last device operation; a gap
is time with no kernel, copy or memset) and splits each gap over the
innermost enclosing program span of a layer (``sampler.*``,
``gather.*``, ``train.*``) on the dispatching thread; what no such span
encloses is ``host``.  The parts sum to the window's idle time, so each
layer's share and ``host`` add up to ``device.idle``.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Tuple

from .trace import BLOCK_RANGE, DEVICE_CATS, _union

#: Span-name prefixes of the program's layers.
LAYERS = ("sampler", "gather", "train")


def _gaps(events: List[dict]):
    """``(window_s, gaps, thread)`` of the traced window (``summarize``'s
    window and busy union), or None without a block or a device op."""
    blocks = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == BLOCK_RANGE]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not blocks or not dev:
        return None
    w0 = min(a for a, _ in blocks)
    w1 = max(max(b for _, b in blocks),
             max(e["ts"] + e["dur"] for e in dev))
    busy = _union([(max(e["ts"], w0), e["ts"] + e["dur"]) for e in dev
                   if e["ts"] + e["dur"] > w0])
    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    thread = next((e.get("pid"), e.get("tid")) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == BLOCK_RANGE)
    return (w1 - w0) / 1e6, gaps, thread


def _layer(name: str):
    head = name.split(".", 1)[0]
    return head if head in LAYERS and "." in name else None


def idle_by_layer(events: List[dict]) -> Dict[str, float]:
    """Seconds of the window's idle gaps under each layer's innermost
    span, and ``host`` for the rest; a layer none of whose spans is in
    the trace is left out.  ``{}`` without a traced window."""
    got = _gaps(events)
    if got is None:
        return {}
    _, gaps, thread = got
    spans: List[Tuple[float, float, str]] = sorted(
        (e["ts"], e["ts"] + e.get("dur", 0), _layer(e["name"]))
        for e in events if e.get("ph") == "X"
        and e.get("cat") == "user_annotation"
        and (e.get("pid"), e.get("tid")) == thread
        and _layer(e.get("name", "")))
    starts = [s[0] for s in spans]
    out = {layer: 0.0 for layer in sorted({s[2] for s in spans})}
    out["host"] = 0.0
    for a, b in gaps:
        # The spans that overlap the gap; cut it at their edges, and give
        # each piece to the innermost span over it (spans of one thread
        # nest: the latest start, then the earliest end).
        over = [s for s in spans[:bisect_left(starts, b)] if s[1] > a]
        cuts = sorted({a, b} | {t for s in over for t in s[:2]
                                if a < t < b})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) / 2
            inner = max((s for s in over if s[0] <= mid < s[1]),
                        key=lambda s: (s[0], -s[1]), default=None)
            key = inner[2] if inner is not None else "host"
            out[key] += (hi - lo) / 1e6
    return out
