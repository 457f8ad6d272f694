"""Per-function effect summaries, computed bottom-up over the call graph
(cf. ``glt_tpu/analysis/effects.py``).

For every function in the project the engine derives one
:class:`Summary` answering the questions the transitive rules ask:

* **may-block** — does calling this function possibly park the calling
  thread? (socket ``recv``/``accept``/``connect``/``sendall``,
  ``time.sleep``, ``subprocess`` waits, and the GLT007 class: zero-arg
  ``.get()``/``.join()``/``.wait()`` plus timeout-polling ``.get()``
  loops).  A scope running the GLT007 timeout-and-recheck pattern (a
  liveness probe in scope) is *not* a blocking source for the poll class
  — its waits are bounded by the recheck loop (``bounded_get``).
* **acquires** — which locks (``module.Class.attr`` /
  ``module.NAME`` ids from the symbol table) it may take, directly or
  transitively.
* **disk** — which synchronous storage reads (``np.load``, memmap
  slices, file ``.read()``) it reaches — GLT014's one-call-deep seed.

The JAX linter's summaries of host syncs, PRNG-key consumption and
collectives feed only its JAX rules and are not carried over.

Summaries compose along the SCC condensation of the call graph
(callees first); recursive components iterate to a bounded fixpoint.
Effect chains carry a depth and are cut off at :data:`MAX_CHAIN_DEPTH`.
Lock *pairs* — "held A while acquiring B" — are collected into one
global table (`EffectEngine.pairs`) that GLT008 reads.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .callgraph import CallEdge, CallGraph
from .symbols import ClassSymbol, FunctionSymbol, Project, Symbol
from .visitor import (
    FunctionScope,
    ModuleInfo,
    assign_targets,
    dotted_expr,
    walk_own,
)

# -- the effect vocabulary (shared with rules.py) ---------------------------

# Dotted call names that park the calling thread.
BLOCKING_CALLS = {
    "time.sleep": "sleep",
    "socket.create_connection": "connect",
    "subprocess.run": "subprocess",
    "subprocess.call": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
}
# Method spellings that park the calling thread regardless of receiver.
BLOCKING_METHODS = {
    "recv": "recv", "recv_into": "recv", "recvfrom": "recv",
    "sendall": "send", "accept": "accept", "connect": "connect",
    "communicate": "subprocess",
}
# Synchronous disk-read entry points (GLT014): dotted calls that hit
# storage on the calling thread.  MMAP_CALLS additionally taint the
# assigned name — slicing a memmap is a page-fault disk read even
# though no call appears at the slice site.
DISK_CALLS = {
    "numpy.load": "np.load", "numpy.fromfile": "np.fromfile",
    "numpy.loadtxt": "np.loadtxt", "numpy.memmap": "np.memmap",
    "mmap.mmap": "mmap.mmap",
}
MMAP_CALLS = {"numpy.memmap", "mmap.mmap"}
# File-object read method spellings (receiver-agnostic, like
# BLOCKING_METHODS): .read()/.readinto()/.readline(s)().
DISK_READ_METHODS = {"read", "readinto", "readline", "readlines"}
# Zero-argument spellings of the GLT007 hang class.
WAIT_METHODS = {"get": "get", "join": "join", "wait": "wait"}
# Kinds exempted in a scope that runs the timeout-and-recheck pattern.
POLL_KINDS = frozenset({"get", "join", "wait"})
# A call to any of these (bare name or attribute) marks the scope as a
# liveness-rechecking poll loop; `alive` covers bounded_get-style probe
# parameters.
LIVENESS_NAMES = {"is_alive", "is_set", "poll", "alive"}

MAX_CHAIN_DEPTH = 12
_MAX_BLOCK_SITES = 3
_SCC_FIXPOINT_ROUNDS = 4


@dataclass(frozen=True)
class BlockSite:
    kind: str        # 'recv' | 'send' | 'sleep' | 'get' | ... | 'call'
    line: int
    detail: str      # human chain: "sock.recv()" / "_connect() -> ..."
    depth: int


@dataclass(frozen=True)
class PairSite:
    path: str
    line: int
    fid: str
    detail: str


@dataclass(frozen=True)
class Summary:
    """Composable, context-free effect summary of one function."""
    blocking: Tuple[BlockSite, ...] = ()
    disk: Tuple[BlockSite, ...] = ()
    acquires: FrozenSet[str] = frozenset()
    liveness: bool = False


EMPTY_SUMMARY = Summary()


@dataclass
class CallFact:
    node: ast.Call
    callee: Optional[Symbol]
    line: int
    held: Tuple[str, ...]


@dataclass
class ScopeFacts:
    """Direct (intraprocedural) facts about one function scope."""
    fid: str
    module: ModuleInfo
    scope: FunctionScope
    blocks: List[Tuple[BlockSite, Tuple[str, ...]]] = field(
        default_factory=list)
    disk: List[BlockSite] = field(default_factory=list)
    calls: List[CallFact] = field(default_factory=list)
    acquisitions: List[Tuple[str, int]] = field(default_factory=list)
    pairs: List[Tuple[str, str, int]] = field(default_factory=list)
    liveness: bool = False
    type_env: Dict[str, ClassSymbol] = field(default_factory=dict)


class EffectEngine:
    """Builds :class:`ScopeFacts` per function, then composes them into
    :class:`Summary` objects bottom-up over the SCC-condensed call graph."""

    def __init__(self, project: Project) -> None:
        self.project = project
        self.facts: Dict[str, ScopeFacts] = {}
        self.summaries: Dict[str, Summary] = {}
        self.pairs: Dict[Tuple[str, str], PairSite] = {}
        for name in sorted(project.modules):
            m = project.modules[name]
            for scope in m.scopes:
                if isinstance(scope.node, ast.Lambda):
                    continue
                fid = project.fid_of(scope)
                if fid is None:
                    continue
                self.facts[fid] = self._collect_facts(m, scope, fid)
        edges = [
            CallEdge(fid, self._symbol_fid(cf.callee), cf.line)
            for fid, f in self.facts.items()
            for cf in f.calls
            if cf.callee is not None
            and self._symbol_fid(cf.callee) is not None
        ]
        self.graph = CallGraph(self.facts.keys(), edges)
        for scc in self.graph.sccs():          # callees-first
            rounds = 1 if len(scc) == 1 else _SCC_FIXPOINT_ROUNDS
            for _ in range(rounds):
                changed = False
                for fid in scc:
                    if fid in self.facts and self._compute(fid):
                        changed = True
                if not changed:
                    break

    # -- public ------------------------------------------------------------
    def summary_for(self, sym: Optional[Symbol]) -> Summary:
        fid = self._symbol_fid(sym)
        if fid is None:
            return EMPTY_SUMMARY
        return self.summaries.get(fid, EMPTY_SUMMARY)

    def _symbol_fid(self, sym: Optional[Symbol]) -> Optional[str]:
        if isinstance(sym, FunctionSymbol):
            return sym.fid
        if isinstance(sym, ClassSymbol):     # constructor call
            init = sym.methods.get("__init__")
            return init.fid if init is not None else None
        return None

    # -- fact collection -----------------------------------------------------
    def _collect_facts(self, module: ModuleInfo, scope: FunctionScope,
                       fid: str) -> ScopeFacts:
        facts = ScopeFacts(fid, module, scope)
        facts.type_env = self._build_type_env(module, scope)
        self._walk_body(facts, scope.node.body, (), frozenset(), 0)
        self._disk_facts(facts)
        if facts.liveness:
            # GLT007 exemption: a liveness-rechecking scope's poll waits
            # are bounded by the recheck loop, not hang sources.
            facts.blocks = [(b, held) for b, held in facts.blocks
                            if b.kind not in POLL_KINDS]
        return facts

    def _build_type_env(self, module: ModuleInfo, scope: FunctionScope
                        ) -> Dict[str, ClassSymbol]:
        env: Dict[str, ClassSymbol] = {}
        for node in walk_own(scope.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            sym = self.project.resolve_call(module, scope, node.value)
            if not isinstance(sym, ClassSymbol):
                continue
            for t in node.targets:
                d = dotted_expr(t)
                if d is not None:
                    env[d] = sym
        return env

    # the linear walk: statements in source order, lock-hold tracking
    def _walk_body(self, facts: ScopeFacts, body: Sequence[ast.stmt],
                   held: Tuple[str, ...], held_exprs: FrozenSet[str],
                   loop_depth: int) -> None:
        held = tuple(held)
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new_held, new_exprs = held, held_exprs
                for item in stmt.items:
                    self._scan_exprs(facts, item.context_expr, new_held,
                                     loop_depth)
                    lid = self.project.lock_id(
                        facts.module, facts.scope, item.context_expr,
                        facts.type_env)
                    if lid is not None:
                        facts.acquisitions.append((lid, stmt.lineno))
                        for outer in new_held:
                            if outer != lid:
                                facts.pairs.append(
                                    (outer, lid, stmt.lineno))
                        new_held = new_held + (lid,)
                        d = dotted_expr(item.context_expr)
                        if d is not None:
                            new_exprs = new_exprs | {d}
                self._walk_body(facts, stmt.body, new_held, new_exprs,
                                loop_depth)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_exprs(facts, stmt.iter, held, loop_depth)
                self._walk_body(facts, stmt.body, held, held_exprs,
                                loop_depth + 1)
                self._walk_body(facts, stmt.orelse, held, held_exprs,
                                loop_depth)
                continue
            if isinstance(stmt, ast.While):
                self._scan_exprs(facts, stmt.test, held, loop_depth + 1)
                self._walk_body(facts, stmt.body, held, held_exprs,
                                loop_depth + 1)
                self._walk_body(facts, stmt.orelse, held, held_exprs,
                                loop_depth)
                continue
            if isinstance(stmt, ast.If):
                self._scan_exprs(facts, stmt.test, held, loop_depth)
                self._walk_body(facts, stmt.body, held, held_exprs,
                                loop_depth)
                self._walk_body(facts, stmt.orelse, held, held_exprs,
                                loop_depth)
                continue
            if isinstance(stmt, ast.Try):
                self._walk_body(facts, stmt.body, held, held_exprs,
                                loop_depth)
                for h in stmt.handlers:
                    self._walk_body(facts, h.body, held, held_exprs,
                                    loop_depth)
                self._walk_body(facts, stmt.orelse, held, held_exprs,
                                loop_depth)
                self._walk_body(facts, stmt.finalbody, held, held_exprs,
                                loop_depth)
                continue
            # explicit lock.acquire()/.release() adjust the held set for
            # the *following* statements of this body
            adj = self._acquire_release(facts, stmt)
            if adj is not None:
                lid, is_acquire = adj
                if is_acquire:
                    facts.acquisitions.append((lid, stmt.lineno))
                    for outer in held:
                        if outer != lid:
                            facts.pairs.append((outer, lid, stmt.lineno))
                    held = held + (lid,)
                elif lid in held:
                    held = tuple(x for x in held if x != lid)
                continue
            self._scan_exprs(facts, stmt, held, loop_depth,
                             held_exprs=held_exprs)

    def _acquire_release(self, facts: ScopeFacts, stmt: ast.stmt
                         ) -> Optional[Tuple[str, bool]]:
        if not (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr in ("acquire", "release")):
            return None
        lid = self.project.lock_id(facts.module, facts.scope,
                                   stmt.value.func.value, facts.type_env)
        if lid is None:
            return None
        return lid, stmt.value.func.attr == "acquire"

    def _scan_exprs(self, facts: ScopeFacts, node: ast.AST,
                    held: Tuple[str, ...], loop_depth: int,
                    held_exprs: FrozenSet[str] = frozenset()) -> None:
        for sub in walk_own(node):
            if isinstance(sub, ast.Call):
                self._visit_call(facts, sub, held, loop_depth, held_exprs)
        if isinstance(node, ast.Call):       # walk_own skips the root
            self._visit_call(facts, node, held, loop_depth, held_exprs)

    def _visit_call(self, facts: ScopeFacts, call: ast.Call,
                    held: Tuple[str, ...], loop_depth: int,
                    held_exprs: FrozenSet[str]) -> None:
        module = facts.module
        name = module.call_name(call)
        attr = (call.func.attr
                if isinstance(call.func, ast.Attribute) else None)
        bare = call.func.id if isinstance(call.func, ast.Name) else None
        if (attr in LIVENESS_NAMES or bare in LIVENESS_NAMES
                or any(kw.arg == "alive" for kw in call.keywords)):
            facts.liveness = True
        if name in DISK_CALLS:
            facts.disk.append(
                BlockSite("disk", call.lineno, f"{DISK_CALLS[name]}()", 0))
        elif attr in DISK_READ_METHODS:
            facts.disk.append(
                BlockSite("disk", call.lineno, f".{attr}()", 0))
        kind = None
        detail = None
        if name in BLOCKING_CALLS:
            kind, detail = BLOCKING_CALLS[name], f"{name}()"
        elif attr in BLOCKING_METHODS:
            kind, detail = BLOCKING_METHODS[attr], f".{attr}()"
        elif attr in WAIT_METHODS and not call.args and not call.keywords:
            kind, detail = WAIT_METHODS[attr], f".{attr}() [no timeout]"
        elif (attr == "get" and loop_depth > 0
              and any(kw.arg == "timeout" for kw in call.keywords)):
            # timeout-polling get in a loop: bounded per wake, unbounded
            # overall — a hang source unless a liveness probe rechecks.
            kind, detail = "get", f".{attr}(timeout=...) poll loop"
        if kind is not None:
            recv = (dotted_expr(call.func.value)
                    if isinstance(call.func, ast.Attribute) else None)
            if not (kind == "wait" and recv is not None
                    and recv in held_exprs):
                # (condition.wait() on the held Condition itself is the
                # sanctioned monitor pattern, not a blocking hazard)
                facts.blocks.append(
                    (BlockSite(kind, call.lineno, detail, 0), held))
        callee = self.project.resolve_call(module, facts.scope, call,
                                           facts.type_env)
        if callee is not None:
            facts.calls.append(
                CallFact(call, callee, call.lineno, held))

    # -- disk-read facts (GLT014) -------------------------------------------
    def _disk_facts(self, facts: ScopeFacts) -> None:
        """Taint names assigned from mmap constructors and record their
        subscript loads as disk sites: slicing a memmap page-faults to
        storage with no call expression at the read site."""
        module, scope = facts.module, facts.scope
        mapped: Set[str] = set()
        for node in walk_own(scope.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if (isinstance(value, ast.Call)
                        and module.call_name(value) in MMAP_CALLS):
                    mapped.update(assign_targets(node))
        if not mapped:
            return
        for node in walk_own(scope.node):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in mapped):
                facts.disk.append(BlockSite(
                    "disk", node.lineno,
                    f"{node.value.id}[...] (mmap page fault)", 0))

    # -- summary composition -------------------------------------------------
    def _compute(self, fid: str) -> bool:
        facts = self.facts[fid]
        blocking: List[BlockSite] = [b for b, _held in facts.blocks]
        disk: List[BlockSite] = list(facts.disk)
        acquires: Set[str] = {lid for lid, _line in facts.acquisitions}
        for outer, inner, line in facts.pairs:
            self._record_pair(outer, inner, facts, line,
                              f"'{outer}' held, then '{inner}' acquired "
                              f"in {fid}")
        for cf in facts.calls:
            csum = self.summary_for(cf.callee)
            if csum is EMPTY_SUMMARY:
                continue
            short = (cf.callee.short
                     if isinstance(cf.callee, FunctionSymbol)
                     else cf.callee.name)
            if csum.blocking:
                b = csum.blocking[0]
                if b.depth + 1 <= MAX_CHAIN_DEPTH:
                    blocking.append(BlockSite(
                        "call", cf.line,
                        f"{short}() -> {b.detail}", b.depth + 1))
            if csum.disk:
                d = csum.disk[0]
                if d.depth + 1 <= MAX_CHAIN_DEPTH:
                    disk.append(BlockSite(
                        "disk", cf.line,
                        f"{short}() -> {d.detail}", d.depth + 1))
            for outer in cf.held:
                for inner in csum.acquires:
                    if outer != inner:
                        self._record_pair(
                            outer, inner, facts, cf.line,
                            f"'{outer}' held in {fid} while calling "
                            f"{short}() which acquires '{inner}'")
            acquires |= csum.acquires
        blocking.sort(key=lambda b: (b.depth, b.line))
        disk.sort(key=lambda b: (b.depth, b.line))
        summary = Summary(
            blocking=tuple(blocking[:_MAX_BLOCK_SITES]),
            disk=tuple(disk[:_MAX_BLOCK_SITES]),
            acquires=frozenset(acquires),
            liveness=facts.liveness,
        )
        if self.summaries.get(fid) == summary:
            return False
        self.summaries[fid] = summary
        return True

    def _record_pair(self, outer: str, inner: str, facts: ScopeFacts,
                     line: int, detail: str) -> None:
        key = (outer, inner)
        site = PairSite(facts.module.path, line, facts.fid, detail)
        cur = self.pairs.get(key)
        if cur is None or (site.path, site.line) < (cur.path, cur.line):
            self.pairs[key] = site
