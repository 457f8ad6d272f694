"""Four capture hazards as small programs, one for each rule that names
one: GLT001 (a host sync in the body), GLT003 (a closed-over Python
scalar), GLT006 (an output held across a second call) and GLT010 (an
obs counter in the body).

Each :class:`Hazard` is a source that the port's linter flags with its
code at the line marked ``# <- GLTnnn``, and a program that shows the
hazard on the card: executed, the source defines ``run(table, idx,
other)``, which builds a :class:`~glt_tpu_torch.utils.graphs.
CapturedProgram` around a launch of kernel B2 (``ops.gather_rows`` of
``table`` at the CUDA ids ``idx``; ``other`` holds other ids of the
same shape) and returns what it saw, with ``ok`` true when the hazard
behaved as its rule says.  ``python3 chip_smoke.py`` runs them on the
card (phase 20); ``tests/test_torch_lint_jaxrules.py`` lints them on the
CPU.  This module holds text only and imports nothing.
"""
from __future__ import annotations

from typing import NamedTuple


class Hazard(NamedTuple):
    code: str
    rule: str
    behaviour: str      # what the card shows, in words
    source: str

    @property
    def line(self) -> int:
        """The line the linter flags: the one marked ``# <- code``."""
        for i, text in enumerate(self.source.splitlines(), 1):
            if text.rstrip().endswith(f"# <- {self.code}"):
                return i
        raise ValueError(f"{self.code}: no marked line")


HOST_SYNC = Hazard("GLT001", "host-sync-in-jit", (
    ".item() in the body makes the capture fail with GraphCaptureError"),
    '''\
from glt_tpu_torch.ops import gather_rows
from glt_tpu_torch.utils.graphs import CapturedProgram, GraphCaptureError


def body(table, idx):
    rows = gather_rows(table, idx)
    return rows * rows.sum().item()  # <- GLT001


def run(table, idx, other):
    try:
        CapturedProgram(lambda i: body(table, i), [idx])
    except GraphCaptureError as exc:
        return {"ok": True, "error": str(exc).splitlines()[0][:160]}
    return {"ok": False, "error": None}
''')

SCALAR = Hazard("GLT003", "recompile-hazard", (
    "a closed-over Python scale changed before a replay leaves the "
    "output equal to the old one"),
    '''\
import torch

from glt_tpu_torch.ops import gather_rows
from glt_tpu_torch.utils.graphs import CapturedProgram


def run(table, idx, other):
    scale = 2.0
    prog = CapturedProgram(lambda i: gather_rows(table, i) * scale, [idx])  # <- GLT003
    first = prog.replay().clone()
    scale = 3.0
    again = prog.replay().clone()
    eager = gather_rows(table, idx) * scale
    kept = torch.equal(first, again)
    moved = not torch.equal(again, eager)
    return {"ok": kept and moved, "replay_kept_old_scale": kept,
            "eager_took_new_scale": moved}
''')

HELD_OUTPUT = Hazard("GLT006", "shadowed-jit-donation", (
    "an output held across a second call equals the second call's "
    "result"),
    '''\
import torch

from glt_tpu_torch.ops import gather_rows
from glt_tpu_torch.utils.graphs import CapturedProgram


def run(table, idx, other):
    want = gather_rows(table, idx).clone()
    prog = CapturedProgram(lambda i: gather_rows(table, i), [idx])
    a = prog(idx)
    b = prog(other)
    rewritten = torch.equal(a, b)  # <- GLT006
    lost = not torch.equal(b, want)
    return {"ok": rewritten and lost, "held_equals_second": rewritten,
            "first_result_lost": lost}
''')

SPAN = Hazard("GLT010", "span-in-traced-code", (
    "an obs counter in the body moves once, at the capture, and not over "
    "5 replays"),
    '''\
from glt_tpu_torch.obs import metrics
from glt_tpu_torch.ops import gather_rows
from glt_tpu_torch.utils.graphs import CapturedProgram

_CALLS = metrics.counter("glt.smoke.hazard_body_calls",
                         "calls of a captured body")


def body(table, idx):
    _CALLS.inc()  # <- GLT010
    return gather_rows(table, idx)


def run(table, idx, other):
    was = metrics.enabled()
    metrics.enable()
    try:
        v0 = _CALLS.value
        prog = CapturedProgram(lambda i: body(table, i), [idx], warmup=0)
        v1 = _CALLS.value
        for _ in range(5):
            prog.replay()
        v2 = _CALLS.value
    finally:
        if not was:
            metrics.disable()
    return {"ok": v1 - v0 == 1 and v2 == v1, "at_capture": v1 - v0,
            "over_5_replays": v2 - v1}
''')

# In the order the card runs them: the failed capture last.
HAZARDS = (SCALAR, HELD_OUTPUT, SPAN, HOST_SYNC)
