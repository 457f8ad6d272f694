"""Profiling and throughput metering, cf. ``glt_tpu/utils/profile.py``.

:func:`trace` wraps a region in a ``torch.profiler`` capture (CPU and
CUDA activity) and writes its Chrome trace into a directory on exit, so
the hand kernels (``sample_kernel``, ``fused_frontier_kernel``, ...)
appear by name under the regions :func:`annotate` labels.
:class:`ThroughputMeter` standardizes the rates the benchmarks print
(sampled edges/s, steps/s, subgraphs/s).

These wrap the framework profiler; the library-level instruments (spans
with device fences, the metrics namespace, the memcpy roofline) are
:mod:`glt_tpu_torch.obs`.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Dict, Optional

import torch

from .device import DeviceLike, resolve_device

_TRACE_SEQ = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = "cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed region and
    write it to ``log_dir`` as ``trace_<pid>_<n>.json`` (Chrome trace
    format) on exit.  Yields the profiler, whose ``trace_file`` names
    that file.  On ``"cuda"`` (the default) it records CPU and CUDA
    activity and raises without a CUDA device; ``device="cpu"`` records
    CPU activity only."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json")
    with profile(activities=activities) as prof:
        prof.trace_file = path
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """Name a region inside a profiler trace."""
    with torch.profiler.record_function(name):
        yield


def trace_kernels(trace_file: str,
                  region: Optional[str] = None) -> Dict[str, int]:
    """Device kernels of a Chrome trace that :func:`trace` wrote,
    counted by name.  With ``region``, only those launched from inside
    a range :func:`annotate` gave that name: a kernel counts when the
    host call that launched it (a kernel or CUDA graph launch, matched
    by correlation id) started within one of the region's ranges, so
    the kernels of a replayed graph count under the range of its
    replay."""
    with open(trace_file) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == region]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out: Dict[str, int] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        if region is not None:
            ts = launched.get(e.get("args", {}).get("correlation"))
            if ts is None or not any(a <= ts <= b for a, b in spans):
                continue
        out[e["name"]] = out.get(e["name"], 0) + 1
    return out


class ThroughputMeter:
    """Accumulate counts over wall-clock time; report rates.

    >>> m = ThroughputMeter()
    >>> with m.measure():
    ...     run_epoch()           # call m.add(edges=..., batches=...) inside
    >>> m.rate("edges")           # edges/sec
    """

    def __init__(self):
        self._counts: Dict[str, float] = {}
        self._elapsed = 0.0

    def add(self, **counts: float) -> None:
        for k, v in counts.items():
            self._counts[k] = self._counts.get(k, 0.0) + float(v)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._elapsed += time.perf_counter() - t0

    @property
    def elapsed(self) -> float:
        return self._elapsed

    def rate(self, key: str) -> float:
        if self._elapsed == 0:
            return 0.0
        return self._counts.get(key, 0.0) / self._elapsed

    def summary(self) -> Dict[str, float]:
        return {f"{k}_per_sec": self.rate(k) for k in self._counts}
