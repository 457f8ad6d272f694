"""gltlint for the port: static analysis of ``glt_tpu_torch``.

An AST pass over the whole package with every rule of ``glt_tpu``'s
linter (``glt_tpu/analysis``), GLT001-GLT027, under the same codes,
names and severities.  The framework-free rules keep its descriptions
and messages: lock-order inversions and blocking calls under a lock,
unbounded waits and queues, non-atomic publishes, wall-clock
durations, unjittered retries, client/server wire-op drift, unguarded
shared fields, synchronous disk reads in an epoch driver's loop.  The
rules that name JAX there check the torch form of the same hazard: a
host sync, a closed-over Python scalar, an obs call or a rewritten
output around a CUDA graph capture (``CapturedProgram``,
``torch.cuda.graph``), threefry key reuse, int64 ids narrowed to int32,
a device fetch in an epoch loop, an unbalanced ``torch.profiler``
capture, a narrowing cast outside ``store/quant.py``, a collective
under a rank-dependent branch or on an axis the mesh lacks.  The kernel
model (``kernelmodel.py``) checks every launch point a kernel module
sweeps against the H100's limits (GLT017, GLT019) and the asynchronous-
copy rings of the CUDA sources it builds (GLT018).

Usage::

    python -m glt_tpu_torch.analysis [paths...]   # exit 1 on errors
    python -m glt_tpu_torch.analysis --list-rules

Programmatic::

    from glt_tpu_torch.analysis import analyze_source, analyze_paths
    findings = analyze_source(src, "module.py")   # or "kernel.cu"

Suppression (justify every one)::

    # Parent owns this worker's lifetime: the wait is bounded.
    item = q.get()  # gltlint: disable=unbounded-blocking-get

This subpackage analyzes with stdlib ``ast`` only and never imports
torch (the parent package brings numpy).
"""
from .cli import (
    analyze_paths,
    analyze_project,
    analyze_source,
    build_project,
    main,
)
from .report import Finding, Severity, Suppressions, format_report
from .rules import RULES, Rule, all_rules
from .symbols import Project

__all__ = [
    "Finding",
    "Project",
    "RULES",
    "Rule",
    "Severity",
    "Suppressions",
    "all_rules",
    "analyze_paths",
    "analyze_project",
    "analyze_source",
    "build_project",
    "format_report",
    "main",
]
