"""Thread-entry discovery + shared-field race detection (GLT027), cf.
``glt_tpu/analysis/threads.py``.

The distributed tier is deliberately multi-threaded: the server spawns
an accept loop, a lease reaper, and one handler thread per connection;
producers spawn forwarders; the serving front runs a dispatcher; the
fleet controller and SLO monitor run poll loops; the supervisor spawns
heartbeat and watch threads.  GLT008/GLT009 check lock *ordering* —
this pass checks lock *coverage*: an instance field written from one
thread entry and read or written from another must have a common lock
on its access paths, unless it matches a sanctioned lock-free idiom.

**Thread entries** are ``threading.Thread(target=...)`` spawns whose
target is a bound method (``target=self._run``) or a nested function of
a method (``target=loop``).  Each entry's *domain* is the set of
same-class scopes reachable from it through ``self.method()`` calls;
every other method body belongs to the implicit main/caller domain.  A
scope reachable from a spawn entry is attributed to that entry only —
public drivers like ``tick()`` are either called externally *or* from
the spawned loop, never both concurrently in the house designs.

For every ``self.<attr>`` access the pass records read/write, whether
the write is a read-modify-write (``+=``, container mutation through
``.append``/``.add``/``[k] = v``), and the locks held at the access
(``with self._lock:`` blocks and explicit ``acquire``/``release``,
matched through :meth:`~.symbols.Project.lock_id`).

A field accessed from two or more domains and written outside
``__init__`` is flagged **unless**:

* every write shares a common lock (unlocked reads of a lock-guarded
  field are the accepted stale-read idiom);
* all writes are plain whole-value assignments from a single domain
  (atomic publish-via-replace, e.g. a shed fraction published by the
  monitor thread);
* all writes are lock-free read-modify-writes from a single domain
  *and* no access path takes any lock (single-writer counters such as
  heartbeat ``sent``/``failures``) — if other accesses of the same
  field do take a lock, the unlocked write missed the field's locking
  discipline and is flagged.

Fields holding thread-safe primitives (queues, events, thread handles)
and fields declared as locks are exempt; cross-class callback threading
(e.g. a supervisor thread invoking another object's callback) is out of
scope — same-class state is where the calibrated true positives live.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .report import Finding
from .rules import Rule, register
from .symbols import ClassSymbol, Project
from .visitor import FunctionScope, ModuleInfo, walk_own

# Mutating container methods: a load of ``self.attr`` used as their
# receiver is a write to the container's state.
MUTATOR_METHODS = {
    "add", "append", "appendleft", "extend", "insert", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
}

# Constructor refs whose instances are internally synchronized (or only
# ever driven from the owning thread): accesses through them are not
# shared-state hazards.
THREADSAFE_TYPE_REFS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "collections.deque",
    "threading.Event", "threading.local", "threading.Thread",
    "threading.Timer", "threading.Barrier",
    "multiprocessing.Queue", "multiprocessing.Event",
    "multiprocessing.Process",
    "concurrent.futures.ThreadPoolExecutor",
}

_THREAD_FACTORY = "threading.Thread"
_MAIN = "<caller>"


@dataclass(frozen=True)
class FieldAccess:
    attr: str
    line: int
    scope_name: str
    is_write: bool
    is_rmw: bool                    # +=, container mutation, del
    held: FrozenSet[str]
    node: ast.AST


@dataclass
class ThreadEntry:
    label: str                      # entry scope name, e.g. "_run"
    scope: FunctionScope
    spawn_line: int


class _ClassThreadModel:
    """Per-class view: spawn entries, scope domains, field accesses."""

    def __init__(self, project: Project, cls: ClassSymbol) -> None:
        self.project = project
        self.cls = cls
        self.module = cls.module
        self.entries: List[ThreadEntry] = []
        self.scopes: List[FunctionScope] = self._class_scopes()
        self._scope_set = set(self.scopes)

    def _class_scopes(self) -> List[FunctionScope]:
        """Methods of the class plus their nested functions."""
        out: List[FunctionScope] = []
        methods = {m.scope for m in self.cls.methods.values()}
        for scope in self.module.scopes:
            cur: Optional[FunctionScope] = scope
            while cur is not None:
                if cur in methods:
                    out.append(scope)
                    break
                cur = cur.parent
        return out

    # -- call edges + reachability ---------------------------------------
    def _edges(self, scope: FunctionScope) -> List[FunctionScope]:
        out: List[FunctionScope] = []
        for node in walk_own(scope.node):
            if not isinstance(node, ast.Call):
                continue
            target = self._resolve_target(scope, node.func)
            if target is not None:
                out.append(target)
        return out

    def _resolve_target(self, scope: FunctionScope,
                        func: ast.expr) -> Optional[FunctionScope]:
        if (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"):
            sym = self.project.class_method(self.cls, func.attr)
            if sym is not None and sym.scope in self._scope_set:
                return sym.scope
        elif isinstance(func, ast.Name):
            cur: Optional[FunctionScope] = scope
            while cur is not None:
                child = self.project._scope_children.get(
                    cur, {}).get(func.id)
                if child is not None and child in self._scope_set:
                    return child
                cur = cur.parent
        return None

    def domains(self) -> Dict[FunctionScope, Set[str]]:
        """Scope -> domain labels.  Spawn-reachable scopes belong to
        their entries; everything else is the caller domain."""
        reached: Dict[FunctionScope, Set[str]] = {}
        for entry in self.entries:
            frontier = [entry.scope]
            seen: Set[FunctionScope] = set()
            while frontier:
                cur = frontier.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                reached.setdefault(cur, set()).add(entry.label)
                frontier.extend(self._edges(cur))
        out: Dict[FunctionScope, Set[str]] = {}
        for scope in self.scopes:
            if scope.name in ("__init__", "__del__"):
                continue
            out[scope] = reached.get(scope, {_MAIN})
        return out

    # -- field accesses ---------------------------------------------------
    def accesses(self, scope: FunctionScope) -> List[FieldAccess]:
        collector = _AccessWalk(self.project, self.module, scope,
                                self.cls)
        body = getattr(scope.node, "body", None)
        if isinstance(body, list):
            collector.walk(body, ())
        return collector.out


class _AccessWalk:
    """Linear statement walk with lock-hold tracking (the effects.py
    discipline), recording every ``self.<attr>`` read/write."""

    def __init__(self, project: Project, module: ModuleInfo,
                 scope: FunctionScope, cls: ClassSymbol) -> None:
        self.project = project
        self.module = module
        self.scope = scope
        self.cls = cls
        self.out: List[FieldAccess] = []

    def walk(self, body: Sequence[ast.stmt],
             held: Tuple[str, ...]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                  # separate scope
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    self._record_stmt(item.context_expr, held)
                    lid = self.project.lock_id(
                        self.module, self.scope, item.context_expr, {})
                    if lid is not None:
                        inner = inner + (lid,)
                self.walk(stmt.body, inner)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._record_stmt(stmt.iter, held)
                self._record_target(stmt.target, held)
                self.walk(stmt.body, held)
                self.walk(stmt.orelse, held)
                continue
            if isinstance(stmt, ast.While):
                self._record_stmt(stmt.test, held)
                self.walk(stmt.body, held)
                self.walk(stmt.orelse, held)
                continue
            if isinstance(stmt, ast.If):
                self._record_stmt(stmt.test, held)
                self.walk(stmt.body, held)
                self.walk(stmt.orelse, held)
                continue
            if isinstance(stmt, ast.Try):
                self.walk(stmt.body, held)
                for h in stmt.handlers:
                    self.walk(h.body, held)
                self.walk(stmt.orelse, held)
                self.walk(stmt.finalbody, held)
                continue
            adj = self._acquire_release(stmt)
            if adj is not None:
                lid, is_acquire = adj
                if is_acquire:
                    held = held + (lid,)
                elif lid in held:
                    held = tuple(x for x in held if x != lid)
                continue
            self._record_stmt(stmt, held)

    def _acquire_release(self, stmt: ast.stmt
                         ) -> Optional[Tuple[str, bool]]:
        if not (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr in ("acquire", "release")):
            return None
        lid = self.project.lock_id(self.module, self.scope,
                                   stmt.value.func.value, {})
        if lid is None:
            return None
        return lid, stmt.value.func.attr == "acquire"

    # -- per-statement access extraction ----------------------------------
    def _record_stmt(self, node: ast.AST,
                     held: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = getattr(node, "value", None)
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            value_reads = (self._self_attrs(value)
                           if value is not None else set())
            for t in targets:
                self._record_target(t, held, value_reads=value_reads)
            if value is not None:
                self._record_loads(value, held)
            return
        if isinstance(node, ast.AugAssign):
            attr = self._self_attr_of(node.target)
            if attr is not None:
                self._emit(attr, node.lineno, node.target, held,
                           is_write=True, is_rmw=True)
            elif isinstance(node.target, ast.Subscript):
                base = self._self_attr_of(node.target.value)
                if base is not None:
                    self._emit(base, node.lineno, node.target, held,
                               is_write=True, is_rmw=True)
                self._record_loads(node.target.slice, held)
            self._record_loads(node.value, held)
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                attr = self._self_attr_of(t)
                if attr is not None:
                    self._emit(attr, node.lineno, t, held,
                               is_write=True, is_rmw=True)
                elif isinstance(t, ast.Subscript):
                    base = self._self_attr_of(t.value)
                    if base is not None:
                        self._emit(base, node.lineno, t, held,
                                   is_write=True, is_rmw=True)
            return
        self._record_loads(node, held)

    def _record_target(self, target: ast.expr, held: Tuple[str, ...],
                       value_reads: Set[str] = frozenset()) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._record_target(el, held, value_reads=value_reads)
            return
        attr = self._self_attr_of(target)
        if attr is not None:
            # assigning a value computed from the same field is a
            # read-modify-write even when spelled as a plain Assign
            self._emit(attr, target.lineno, target, held,
                       is_write=True, is_rmw=attr in value_reads)
            return
        if isinstance(target, ast.Subscript):
            base = self._self_attr_of(target.value)
            if base is not None:
                self._emit(base, target.lineno, target, held,
                           is_write=True, is_rmw=True)
            self._record_loads(target.slice, held)

    def _record_loads(self, node: ast.AST,
                      held: Tuple[str, ...]) -> None:
        for sub in list(walk_own(node)) + [node]:
            attr = self._self_attr_of(sub)
            if attr is None:
                continue
            if self._is_mutator_receiver(sub):
                self._emit(attr, sub.lineno, sub, held,
                           is_write=True, is_rmw=True)
            else:
                self._emit(attr, sub.lineno, sub, held,
                           is_write=False, is_rmw=False)

    def _self_attrs(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for sub in list(walk_own(node)) + [node]:
            attr = self._self_attr_of(sub)
            if attr is not None:
                out.add(attr)
        return out

    def _self_attr_of(self, node: ast.AST) -> Optional[str]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _is_mutator_receiver(self, node: ast.AST) -> bool:
        """``self.attr`` as the receiver of ``.add()``/``.append()``/…"""
        parent = self.module.parents.get(node)
        if not (isinstance(parent, ast.Attribute)
                and parent.value is node
                and parent.attr in MUTATOR_METHODS):
            return False
        call = self.module.parents.get(parent)
        return isinstance(call, ast.Call) and call.func is parent

    def _emit(self, attr: str, line: int, node: ast.AST,
              held: Tuple[str, ...], is_write: bool,
              is_rmw: bool) -> None:
        if attr in self.cls.lock_attrs:
            return
        ref = self.cls.attr_type_refs.get(attr)
        if ref in THREADSAFE_TYPE_REFS:
            return
        self.out.append(FieldAccess(
            attr=attr, line=line, scope_name=self.scope.name,
            is_write=is_write, is_rmw=is_rmw,
            held=frozenset(held), node=node))


def _own_class(project: Project, module: ModuleInfo,
               scope: Optional[FunctionScope]) -> Optional[ClassSymbol]:
    cur = scope
    while cur is not None:
        if cur.class_name:
            return project.classes.get(
                f"{module.name}.{cur.class_name}")
        cur = cur.parent
    return None


def _thread_target_scope(project: Project, module: ModuleInfo,
                         spawn_scope: Optional[FunctionScope],
                         cls: ClassSymbol,
                         target: ast.expr) -> Optional[FunctionScope]:
    if (isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"):
        sym = project.class_method(cls, target.attr)
        return sym.scope if sym is not None else None
    if isinstance(target, ast.Name):
        cur = spawn_scope
        while cur is not None:
            child = project._scope_children.get(cur, {}).get(target.id)
            if child is not None:
                return child
            cur = cur.parent
    return None


def build_thread_models(project: Project
                        ) -> Dict[str, _ClassThreadModel]:
    """Discover every ``Thread(target=...)`` spawn, grouped by owning
    class (memoized on the project)."""
    cached = getattr(project, "_thread_models", None)
    if cached is not None:
        return cached
    models: Dict[str, _ClassThreadModel] = {}
    for name in sorted(project.modules):
        module = project.modules[name]
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if module.call_name(node) != _THREAD_FACTORY:
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and node.args:
                target = node.args[0]
            if target is None:
                continue
            spawn_scope = _enclosing_scope(module, node)
            cls = _own_class(project, module, spawn_scope)
            if cls is None:
                continue
            model = models.get(cls.cid)
            if model is None:
                model = models[cls.cid] = _ClassThreadModel(
                    project, cls)
            entry_scope = _thread_target_scope(
                project, module, spawn_scope, cls, target)
            if entry_scope is None or entry_scope not in \
                    model._scope_set:
                continue
            model.entries.append(ThreadEntry(
                label=entry_scope.name, scope=entry_scope,
                spawn_line=node.lineno))
    project._thread_models = models
    return models


def _enclosing_scope(module: ModuleInfo,
                     node: ast.AST) -> Optional[FunctionScope]:
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return module.scope_of(cur)
        cur = module.parents.get(cur)
    return None


@register
class UnguardedSharedField(Rule):
    name = "unguarded-shared-field"
    code = "GLT027"
    description = ("an instance field shared across thread entries "
                   "without a common lock or a sanctioned lock-free "
                   "idiom")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        out: List[Finding] = []
        for cid in sorted(build_thread_models(project)):
            model = build_thread_models(project)[cid]
            if model.module is not module or not model.entries:
                continue
            out.extend(self._check_class(model))
        return out

    def _check_class(self, model: _ClassThreadModel) -> List[Finding]:
        domains = model.domains()
        by_attr: Dict[str, List[Tuple[FieldAccess, Set[str]]]] = {}
        for scope, doms in domains.items():
            for acc in model.accesses(scope):
                by_attr.setdefault(acc.attr, []).append((acc, doms))
        out: List[Finding] = []
        for attr in sorted(by_attr):
            finding = self._check_field(model, attr, by_attr[attr])
            if finding is not None:
                out.append(finding)
        return out

    def _check_field(self, model: _ClassThreadModel, attr: str,
                     accesses: List[Tuple[FieldAccess, Set[str]]]
                     ) -> Optional[Finding]:
        writes = [(a, d) for a, d in accesses if a.is_write]
        if not writes:
            return None
        touched: Set[str] = set()
        for _a, doms in accesses:
            touched |= doms
        if len(touched) < 2:
            return None                  # single-threaded field
        common = frozenset.intersection(*[a.held for a, _d in writes])
        if common:
            return None                  # every write shares a lock
        w0 = writes[0][0]
        cname = model.cls.name
        if any(a.held for a, _d in writes):
            unlocked = next(a for a, _d in writes if not a.held)
            return self.finding(
                model.module, unlocked.node,
                f"field '{attr}' of {cname} is written without a lock "
                f"in '{unlocked.scope_name}' but other writes hold "
                f"one — inconsistent locking on a field shared across "
                f"thread entries")
        write_domains: Set[str] = set()
        for _a, doms in writes:
            write_domains |= doms
        if len(write_domains) == 1:
            if all(not a.is_rmw for a, _d in writes):
                return None              # atomic publish-via-replace
            if not any(a.held for a, _d in accesses):
                return None              # single-writer counter idiom
            locked = next(a for a, _d in accesses if a.held)
            return self.finding(
                model.module, w0.node,
                f"field '{attr}' of {cname} is updated in place "
                f"without a lock in '{w0.scope_name}' (thread entry "
                f"domain {sorted(write_domains)[0]!r}) while "
                f"'{locked.scope_name}' accesses it under "
                f"'{sorted(locked.held)[0]}' — the write misses the "
                f"field's locking discipline")
        return self.finding(
            model.module, w0.node,
            f"field '{attr}' of {cname} is written from multiple "
            f"thread domains ({', '.join(sorted(write_domains))}) "
            f"with no common lock")
