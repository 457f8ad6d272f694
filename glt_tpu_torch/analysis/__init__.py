"""gltlint for the port: static analysis of ``glt_tpu_torch``.

An AST pass over the whole package that catches the hazards of its
threaded and distributed layers: lock-order inversions and blocking
calls under a lock, unbounded waits and queues, non-atomic publishes of
state other processes read, wall-clock durations, unjittered retries,
client/server wire-op drift, unguarded shared fields, and synchronous
disk reads in an epoch driver's loop.  These are the framework-free
rules of ``glt_tpu``'s linter (``glt_tpu/analysis``), with the same
codes, names, severities and messages.  Beside them the launch model
(``kernelmodel.py``, GLT017 and GLT019) checks every launch point a
kernel module sweeps against the H100's limits.

Usage::

    python -m glt_tpu_torch.analysis [paths...]   # exit 1 on errors
    python -m glt_tpu_torch.analysis --list-rules

Programmatic::

    from glt_tpu_torch.analysis import analyze_source, analyze_paths
    findings = analyze_source(src, "module.py")

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
