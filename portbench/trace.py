"""A profiled stretch of the measured window, and what is read from it.

:class:`Profiled` starts ``torch.profiler`` (CPU and CUDA activity) at
a block boundary, lets it settle (device records of work launched in the
first milliseconds after a start can be lost), and stops it after the
last traced block's work has finished.  The Chrome trace goes to a file
under ``TMPDIR``, is read back and deleted.

:func:`summarize` reduces the trace to the numbers the per-layer
readers take: device time by kernel name, device time launched from
inside each benchmark range (a kernel belongs to the host call that
launched it, a kernel launch or a graph launch, matched by correlation
id: the arithmetic of ``glt_tpu_torch.utils.profile.trace_kernels``,
copied here), the busy union and the length of the traced window, and
the breakdown: the device operations that took most time and the
longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import time
from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

#: Idle time left after the profiler starts, before the first traced
#: block is dispatched.
SETTLE_S = 0.5
#: The benchmark's range around each traced block.
BLOCK_RANGE = "portbench.block"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Profiled:
    """Built in set-up, which starts and stops one profiler so that the
    tracer's first start (seconds of set-up on the card) falls outside
    the window; then ``start()`` at a block boundary and ``stop()`` after
    the last traced block; ``summary`` then holds :func:`summarize`'s
    result."""

    def __init__(self, torch):
        self.torch = torch
        self.summary: Optional[dict] = None
        self.prof = self._profile()
        self.prof.start()
        torch.cuda.synchronize()
        self.prof.stop()
        self.prof = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.start()
        self.torch.cuda.synchronize()
        time.sleep(SETTLE_S)

    def stop(self, ranges: Tuple[str, ...]) -> None:
        self.torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        self.summary = summarize(events, ranges)


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _name_gaps(host: List[Tuple[float, float, str]],
               gaps: List[Tuple[float, float]]) -> Dict[str, float]:
    """Sum each gap's length under the innermost host event running at
    its midpoint (``host`` from one thread, so properly nested)."""
    out: Dict[str, float] = {}
    queries = sorted(((a + b) / 2, b - a) for a, b in gaps)
    stack: List[Tuple[float, str]] = []
    i = 0
    for t, length in queries:
        while i < len(host) and host[i][0] <= t:
            a, b, name = host[i]
            while stack and stack[-1][0] <= a:
                stack.pop()
            stack.append((b, name))
            i += 1
        while stack and stack[-1][0] <= t:
            stack.pop()
        name = stack[-1][1] if stack else "host idle"
        out[name] = out.get(name, 0.0) + length
    return out


def summarize(events: List[dict], ranges: Tuple[str, ...]) -> dict:
    """Numbers of one trace (times in seconds).

    The traced window runs from the start of the first
    :data:`BLOCK_RANGE` range to the end of the last device operation
    (or of the last block range, if later)."""
    blocks = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") == BLOCK_RANGE]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not blocks or not dev:
        return {"blocks": len(blocks), "device_ops": len(dev)}
    w0 = min(a for a, _ in blocks)
    w1 = max(max(b for _, b in blocks),
             max(e["ts"] + e["dur"] for e in dev))
    dev = [e for e in dev if e["ts"] + e["dur"] > w0]
    busy = _union([(max(e["ts"], w0), e["ts"] + e["dur"]) for e in dev])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    # Device time launched from inside each benchmark range.
    spans = {r: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("name") == r) for r in ranges}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    in_range = {r: 0.0 for r in ranges}
    for e in dev:
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for r, sp in spans.items():
            i = bisect_right(sp, (ts, float("inf"))) - 1
            if i >= 0 and sp[i][0] <= ts <= sp[i][1]:
                in_range[r] += e["dur"]
    # Idle gaps inside the window, named by what the dispatching thread
    # was doing.
    thread = next((e.get("pid"), e.get("tid")) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == BLOCK_RANGE)
    host = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                   for e in events if e.get("ph") == "X"
                   and (e.get("pid"), e.get("tid")) == thread
                   and e.get("cat") not in DEVICE_CATS),
                  key=lambda h: (h[0], -h[1]))
    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = _name_gaps(host, [(a, b) for (_, a), (b, _)
                             in zip(edges, edges[1:]) if b > a])
    busy_us = sum(b - a for a, b in busy)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "blocks": len(blocks),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "range_s": {k: v / 1e6 for k, v in in_range.items()},
        "breakdown": {"device_ops": [[k, v / 1e6] for k, v in top],
                      "idle_gaps": [[k, v / 1e6] for k, v in idle]},
    }


def kernel_time(summary: dict, kernel: str) -> float:
    """Seconds of the kernels named ``kernel`` (as a whole word of the
    trace's name, which may carry template arguments and a signature)."""
    word = re.compile(rf"\b{re.escape(kernel)}\b")
    return sum(v for k, v in summary.get("kernel_s", {}).items()
               if word.search(k))
