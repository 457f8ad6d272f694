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
* **host-sync params** — which of its parameters, if device tensors,
  reach a host sync (``.item()``, ``.cpu()``, ``int()``, ...) — the
  GLT001-transitive and GLT013 one-call-deep seed.
* **consumes-key params** — which parameters are consumed as threefry
  keys (passed to a drawing ``glt_tpu_torch.random`` call, directly or
  transitively) — the GLT002-transitive seed.
* **launches-collective** — whether a collective of the processes
  (``Fleet.exchange``, ``multihost.barrier``, a ``torch.distributed``
  collective) runs inside — GLT020 follows calls by it.

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
    host_guarded,
    host_names,
    is_port_api,
    traced_names,
    walk_own,
)

# -- the effect vocabulary (shared with rules.py) ---------------------------

HOST_SYNC_CALLS = {"torch.cuda.synchronize", "torch.unique", "torch.nonzero"}
# Syncs that wait for the device whatever their arguments.
ALWAYS_SYNC = {"torch.cuda.synchronize"}
COERCIONS = {"int", "float", "bool", "complex"}
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero"}

# The port's threefry keys (``glt_tpu_torch/random.py``).
KEY_SOURCES = {
    "glt_tpu_torch.random.PRNGKey", "glt_tpu_torch.random.split",
    "glt_tpu_torch.random.fold_in",
}
# Deriving fresh keys from a base key is the sanctioned way to reuse it.
NON_CONSUMING = {"glt_tpu_torch.random.split",
                 "glt_tpu_torch.random.fold_in"}
_RANDOM = "glt_tpu_torch.random"

# Rendezvous of every process: a process that skips one hangs the rest.
COLLECTIVES = {
    "glt_tpu_torch.parallel.multihost.barrier",
    "glt_tpu_torch.parallel.multihost.agree_max",
    "glt_tpu_torch.parallel.multihost.agree_first",
    "glt_tpu_torch.parallel.multihost.agree_sum",
}
# Method spellings: ``Fleet``'s collectives and ``torch.distributed``'s,
# whatever the receiver (``fleet``, ``dist``, ``_dist()``).
COLLECTIVE_METHODS = {
    "exchange", "rotate", "all_reduce", "any_host",
    "all_gather", "all_gather_object", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "reduce_scatter", "barrier",
    "monitored_barrier", "gather_object", "scatter_object_list",
}


def is_key_call(name: Optional[str]) -> bool:
    """A call into the port's ``random`` module."""
    return bool(name) and name.startswith(_RANDOM + ".")


def is_collective(module: ModuleInfo, call: ast.Call) -> bool:
    name = module.call_name(call)
    if is_port_api(name, COLLECTIVES):
        return True
    if name and name.startswith("torch.distributed.") \
            and name.rsplit(".", 1)[-1] in COLLECTIVE_METHODS:
        return True
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in COLLECTIVE_METHODS)


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
class SyncSite:
    line: int
    detail: str
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
    sync_params: Tuple[Tuple[str, SyncSite], ...] = ()
    key_params: FrozenSet[str] = frozenset()
    liveness: bool = False
    collective: bool = False

    def sync_param_map(self) -> Dict[str, SyncSite]:
        return dict(self.sync_params)


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
    collective: bool = False
    influences: Dict[str, FrozenSet[str]] = field(default_factory=dict)
    sync_sites: Dict[str, SyncSite] = field(default_factory=dict)
    key_params: Set[str] = field(default_factory=set)
    type_env: Dict[str, ClassSymbol] = field(default_factory=dict)


def _callee_positional_params(sym: FunctionSymbol,
                              call: ast.Call) -> List[str]:
    """The callee's positional parameter names as seen from this call
    site (bound-method calls skip ``self``/``cls``)."""
    params = sym.scope.params
    if (params[:1] in (["self"], ["cls"])
            and isinstance(call.func, ast.Attribute)):
        return params[1:]
    return params


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
        self._sync_and_key_facts(facts)
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
        if is_collective(module, call):
            facts.collective = True
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

    # -- intraprocedural dataflow: host-sync params + key params ------------
    def _sync_and_key_facts(self, facts: ScopeFacts) -> None:
        module, scope = facts.module, facts.scope
        params = [p for p in scope.params if p not in ("self", "cls")]
        # A name annotated with a host type never holds a device value:
        # it carries no influence (``fanout: int`` reassigned from a
        # check of the seeds stays a host int).
        host = host_names(scope.node)
        infl: Dict[str, FrozenSet[str]] = {
            p: frozenset([p]) for p in params if p not in host}

        def influence_of(expr: ast.AST) -> FrozenSet[str]:
            out: FrozenSet[str] = frozenset()
            for n in traced_names(expr):
                out |= infl.get(n, frozenset())
            return out

        for _ in range(2):                   # two passes settle chains
            for node in walk_own(scope.node):
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    value = getattr(node, "value", None)
                    if value is None:
                        continue
                    src = influence_of(value)
                    if src:
                        for t in assign_targets(node):
                            if t not in host:
                                infl[t] = infl.get(t, frozenset()) | src
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    src = influence_of(node.iter)
                    if src and isinstance(node.target, ast.Name):
                        infl[node.target.id] = (
                            infl.get(node.target.id, frozenset()) | src)
        facts.influences = infl
        for node in walk_own(scope.node):
            if not isinstance(node, ast.Call):
                continue
            name = module.call_name(node)
            args = list(node.args) + [kw.value for kw in node.keywords]
            consumed: FrozenSet[str] = frozenset()
            detail = None
            if name in HOST_SYNC_CALLS or (
                    name in COERCIONS
                    and not host_guarded(module, node, scope.node)):
                for a in args:
                    consumed |= influence_of(a)
                detail = f"{name}()"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in SYNC_METHODS):
                consumed = influence_of(node.func.value)
                detail = f".{node.func.attr}()"
            if detail is not None:
                for p in consumed:
                    facts.sync_sites.setdefault(
                        p, SyncSite(node.lineno, detail, 0))
            # direct key consumption: a drawing call of the port's random
            if is_key_call(name) and name not in KEY_SOURCES:
                for a in args:
                    if isinstance(a, ast.Name) and a.id in params:
                        facts.key_params.add(a.id)

    # -- summary composition -------------------------------------------------
    def _compute(self, fid: str) -> bool:
        facts = self.facts[fid]
        blocking: List[BlockSite] = [b for b, _held in facts.blocks]
        disk: List[BlockSite] = list(facts.disk)
        acquires: Set[str] = {lid for lid, _line in facts.acquisitions}
        sync_params: Dict[str, SyncSite] = dict(facts.sync_sites)
        key_params: Set[str] = set(facts.key_params)
        for outer, inner, line in facts.pairs:
            self._record_pair(outer, inner, facts, line,
                              f"'{outer}' held, then '{inner}' acquired "
                              f"in {fid}")
        params = [p for p in facts.scope.params
                  if p not in ("self", "cls")]
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
            if isinstance(cf.callee, (FunctionSymbol, ClassSymbol)):
                self._bind_call_effects(
                    facts, cf, csum, short, params, sync_params,
                    key_params)
        blocking.sort(key=lambda b: (b.depth, b.line))
        disk.sort(key=lambda b: (b.depth, b.line))
        summary = Summary(
            blocking=tuple(blocking[:_MAX_BLOCK_SITES]),
            disk=tuple(disk[:_MAX_BLOCK_SITES]),
            acquires=frozenset(acquires),
            sync_params=tuple(sorted(sync_params.items())),
            key_params=frozenset(key_params),
            liveness=facts.liveness,
            collective=facts.collective or any(
                self.summary_for(cf.callee).collective
                for cf in facts.calls),
        )
        if self.summaries.get(fid) == summary:
            return False
        self.summaries[fid] = summary
        return True

    def _bind_call_effects(self, facts: ScopeFacts, cf: CallFact,
                           csum: Summary, short: str,
                           params: List[str],
                           sync_params: Dict[str, SyncSite],
                           key_params: Set[str]) -> None:
        """Map a callee's parameter-keyed effects back through the call
        site's argument binding onto this function's parameters."""
        callee = cf.callee
        if isinstance(callee, ClassSymbol):
            init = callee.methods.get("__init__")
            if init is None:
                return
            pos = init.scope.params[1:]      # skip self
        else:
            pos = _callee_positional_params(callee, cf.node)
        callee_sync = csum.sync_param_map()

        def bind(arg: ast.expr, pname: str) -> None:
            if pname in callee_sync:
                site = callee_sync[pname]
                if site.depth + 1 <= MAX_CHAIN_DEPTH:
                    for q in traced_names(arg):
                        for p in facts.influences.get(q, ()):  # params
                            sync_params.setdefault(p, SyncSite(
                                cf.line,
                                f"{short}(param '{pname}') -> "
                                f"{site.detail}",
                                site.depth + 1))
            if (pname in csum.key_params and isinstance(arg, ast.Name)
                    and arg.id in params):
                key_params.add(arg.id)

        for i, arg in enumerate(cf.node.args):
            if i < len(pos):
                bind(arg, pos[i])
        for kw in cf.node.keywords:
            if kw.arg is not None:
                bind(kw.value, kw.arg)

    def _record_pair(self, outer: str, inner: str, facts: ScopeFacts,
                     line: int, detail: str) -> None:
        key = (outer, inner)
        site = PairSite(facts.module.path, line, facts.fid, detail)
        cur = self.pairs.get(key)
        if cur is None or (site.path, site.line) < (cur.path, cur.line):
            self.pairs[key] = site
