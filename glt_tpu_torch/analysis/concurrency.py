"""Concurrency rules for the threaded layers: GLT008/GLT009 (cf.
``glt_tpu/analysis/concurrency.py``).

Both rules read the project-wide effect summaries (analysis/effects.py),
so a hazard hidden one (or N) calls deep is as visible as a direct one —
the shape of bug the dynamic ``bounded_get`` fix closed at runtime, now
gated statically before it ships.

* **GLT008 lock-order-inversion** — the engine records every ordered
  pair "lock A held while lock B is acquired", whether the inner
  acquisition is textually nested (``with a: with b:``) or buried in a
  callee's summary.  Two call paths acquiring the same two locks in
  opposite orders can deadlock the moment both run concurrently (server
  request thread vs. reaper vs. client prefetcher); the rule reports each
  inverted unordered pair once, citing both paths.

* **GLT009 blocking-call-while-holding-lock** — a may-block effect
  (socket recv/accept/connect/sendall, ``time.sleep``, subprocess waits,
  zero-arg ``.get()``/``.join()``/``.wait()``, timeout-polling get
  loops) reachable while a ``threading`` lock is held.  Every other
  thread that touches the lock then inherits the wait: a wedged peer
  turns into a wedged *server*.  Scopes running the GLT007
  timeout-and-recheck pattern are exempt for the poll class
  (``bounded_get``'s waits are bounded by its liveness probe), and
  ``cond.wait()`` on the held Condition itself is the sanctioned monitor
  pattern.  One finding per (function, lock): the first blocking site is
  reported, further sites under the same lock are implied.
"""
from __future__ import annotations

import ast
from typing import List

from .report import Finding, Severity
from .rules import Rule, register
from .symbols import FunctionSymbol
from .visitor import ModuleInfo


@register
class LockOrderInversion(Rule):
    """Two locks acquired in inconsistent orders across any two paths."""
    name = "lock-order-inversion"
    code = "GLT008"
    severity = Severity.ERROR
    description = ("two locks acquired in opposite orders on two call "
                   "paths (deadlock the moment both run concurrently)")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        pairs = project.effects.pairs
        findings: List[Finding] = []
        seen = set()
        for (a, b) in sorted(pairs):
            if a == b or frozenset((a, b)) in seen:
                continue
            other = pairs.get((b, a))
            if other is None:
                continue
            seen.add(frozenset((a, b)))
            site = pairs[(a, b)]
            rep, alt = ((site, other)
                        if (site.path, site.line) <= (other.path,
                                                      other.line)
                        else (other, site))
            # one report per inversion, in the module holding the
            # representative site (the rule runs once per module)
            if rep.path != module.path:
                continue
            findings.append(Finding(
                path=rep.path, line=rep.line, col=1, rule=self.name,
                code=self.code, severity=self.severity,
                message=(f"lock order inversion between '{a}' and "
                         f"'{b}': {rep.detail} ({rep.path}:{rep.line}) "
                         f"but on another path {alt.detail} "
                         f"({alt.path}:{alt.line}); two threads taking "
                         f"these paths concurrently deadlock — pick one "
                         f"global acquisition order")))
        return findings


@register
class BlockingUnderLock(Rule):
    """A may-block effect reachable while holding a threading lock."""
    name = "blocking-call-while-holding-lock"
    code = "GLT009"
    severity = Severity.ERROR
    description = ("a blocking call (socket recv/send, sleep, zero-arg "
                   "get/join/wait, subprocess) reachable while a "
                   "threading.Lock/Condition is held")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        eng = project.effects
        findings: List[Finding] = []
        for scope in module.scopes:
            if isinstance(scope.node, ast.Lambda):
                continue
            fid = project.fid_of(scope)
            facts = eng.facts.get(fid) if fid else None
            if facts is None:
                continue
            events = []      # (line, innermost lock, detail, held)
            for site, held in facts.blocks:
                if held:
                    events.append((site.line, held[-1],
                                   f"{site.detail}", held))
            for cf in facts.calls:
                if not cf.held:
                    continue
                csum = eng.summary_for(cf.callee)
                if not csum.blocking:
                    continue
                short = (cf.callee.short
                         if isinstance(cf.callee, FunctionSymbol)
                         else cf.callee.name)
                b = csum.blocking[0]
                events.append((cf.line, cf.held[-1],
                               f"{short}() -> {b.detail}", cf.held))
            events.sort(key=lambda e: (e[0], e[1]))
            reported = set()
            for line, lock, detail, held in events:
                if lock in reported:
                    continue
                reported.add(lock)
                held_s = ", ".join(f"'{h}'" for h in held)
                findings.append(Finding(
                    path=module.path, line=line, col=1, rule=self.name,
                    code=self.code, severity=self.severity,
                    message=(f"blocking call {detail} while holding "
                             f"{held_s}: every thread contending on the "
                             f"lock inherits the wait (wedged peer -> "
                             f"wedged service); move the blocking call "
                             f"outside the critical section, bound it, "
                             f"or suppress with a justified escape "
                             f"hatch")))
        return findings
