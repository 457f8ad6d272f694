"""What the exact-shape sweeps share (:func:`~.gather_cuda.
autotune_gather_rows`, :func:`~.sample_cuda.autotune_sample` and
:func:`~glt_tpu_torch.parallel.dist_sampler.autotune_routing`).

A sweep runs eagerly on the card, at warmup, and times each launch point
with CUDA events on the current stream: one warm call, then ``rounds``
rounds of ``iters`` calls queued behind a sleep kernel (so the host's own
call overhead never shows as idle device time), the median round's
device time over ``iters``.  A sweep inside a CUDA graph capture raises:
its launches would land in the graph and its event syncs would invalidate
the capture.
"""
from __future__ import annotations

import statistics

import torch

# About 1 ms of the H100's 1.98 GHz SM clock: long enough for the host to
# queue a round's calls before the card reaches them.
SLEEP_CYCLES = 2_000_000
ROUNDS = 5


def dtype_name(dtype: torch.dtype) -> str:
    """``glt_tpu``'s name of a dtype in a table key ("float32", not
    "torch.float32")."""
    return str(dtype).replace("torch.", "")


def check_eager(what: str) -> None:
    """Raise when the current stream is capturing a CUDA graph."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} sweeps at warmup, eagerly: it cannot "
                           f"run inside a CUDA graph capture")


def sweep_ms(fn, iters: int = 3, rounds: int = ROUNDS) -> float:
    """Device ms of one ``fn()`` call on the current CUDA stream (see the
    module docstring)."""
    iters = max(1, int(iters))
    fn()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)
