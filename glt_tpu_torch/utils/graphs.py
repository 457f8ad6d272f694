"""One CUDA graph over static input buffers: the port's counterpart of a
jitted program (``glt_tpu`` compiles a bucket's sample, a batched
sample or a scanned training block into ONE XLA program and dispatches
it once a call).

:class:`CapturedProgram` runs ``fn(*inputs)`` under
``torch.cuda.graph`` once and replays the recorded launches on every
later call: the caller's values are copied into the static ``inputs``
(``copy_``, no host sync), the graph is replayed on the current stream,
and the tensors ``fn`` returned during capture, rewritten in place by
each replay, are handed back.  Everything ``fn`` reads besides
``inputs`` (weights, optimizer state, graph arrays, counters) is read
from the same storage at every replay, so ``fn`` must update such state
in place and never read a Python value that changes between calls: a
replay does not run Python.

A failed capture raises :class:`GraphCaptureError`; nothing runs
eagerly in its place.  Each capture reports itself to
:mod:`glt_tpu_torch.obs.compilewatch` (``glt.compile.count`` and
``glt.compile.ms`` under the caller's ``compilewatch.label``), the
port's counterpart of an XLA compilation.  The object is built only for
CUDA tensors: on the CPU the callers run ``fn`` eagerly, as before.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..obs import compilewatch


class GraphCaptureError(RuntimeError):
    """Capturing a program into a CUDA graph failed (an operation that a
    capture cannot record, such as a host sync, ran inside it)."""


# Captures running at once (a serving dispatcher beside a training loop)
# share one pause of the garbage collector: the last one to end resumes
# it, if it ran before the first began.
_NO_GC_LOCK = threading.Lock()
_NO_GC = {"depth": 0, "resume": False}


@contextlib.contextmanager
def _no_gc():
    """Pause the cyclic garbage collector in every thread.  A collection
    inside a capture runs the finalizers of whatever dead objects it
    finds, and freeing a dead pinned host tensor records events on the
    streams that used it, which can invalidate the capture."""
    with _NO_GC_LOCK:
        if _NO_GC["depth"] == 0:
            _NO_GC["resume"] = gc.isenabled()
            gc.disable()
        _NO_GC["depth"] += 1
    try:
        yield
    finally:
        with _NO_GC_LOCK:
            _NO_GC["depth"] -= 1
            if _NO_GC["depth"] == 0 and _NO_GC["resume"]:
                gc.enable()


def _copy_into(buf: torch.Tensor, value) -> None:
    """Copy ``value`` (a tensor, or a host array through pinned memory)
    into the static CUDA buffer ``buf`` without waiting for the
    device."""
    if not isinstance(value, torch.Tensor):
        # The caching host allocator keeps the pinned block until the
        # copy has run, so the host may refill it on the next call.
        value = torch.as_tensor(np.ascontiguousarray(value)).to(
            buf.dtype).pin_memory()
    buf.copy_(value, non_blocking=True)


class CapturedProgram:
    """``fn(*inputs)`` captured into one :class:`torch.cuda.CUDAGraph`.

    Args:
      fn: the program; called with ``inputs`` and returning any
        structure of tensors (the static outputs).
      inputs: static CUDA tensors, already holding valid values (the
        warm-up reads them).
      warmup: eager calls of ``fn`` on a side stream before the capture
        (their results are dropped), so that lazy set-up work (module
        loading, library handles) stays out of the graph.  A caller
        whose ``fn`` updates state in place passes 0 and warms up with
        a real call of its own.

    The kernels' launch counters move during the warm-up and once per
    launch the capture records; a replay moves none of them.
    """

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[torch.Tensor],
                 warmup: int = 1):
        inputs = tuple(inputs)
        if not inputs or any(not t.is_cuda for t in inputs):
            raise ValueError("CapturedProgram takes CUDA input buffers; on "
                             "the CPU run the program eagerly")
        dev = inputs[0].device
        self.inputs = inputs
        cur = torch.cuda.current_stream(dev)
        if warmup:
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(int(warmup)):
                    fn(*inputs)
            cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with _no_gc(), torch.cuda.device(dev), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                self.outputs = fn(*inputs)
        except Exception as exc:
            # A failed capture_end leaves the capture stream current.
            torch.cuda.set_stream(cur)
            raise GraphCaptureError(
                f"capturing {getattr(fn, '__name__', fn)!r} into a CUDA "
                f"graph failed: {exc}") from exc
        compilewatch.note_compile(None, (time.perf_counter() - t0) * 1e3)

    def replay(self) -> Any:
        """Replay the graph on the current stream; return the static
        outputs (valid once the stream reaches them)."""
        self.graph.replay()
        return self.outputs

    def __call__(self, *values) -> Any:
        """Copy ``values`` into the input buffers, then :meth:`replay`."""
        if len(values) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(values)}")
        for buf, v in zip(self.inputs, values):
            _copy_into(buf, v)
        return self.replay()
