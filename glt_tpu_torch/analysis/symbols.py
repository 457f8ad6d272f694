"""Project symbol table: every module, function, class, and lock in one
namespace, with cross-module call resolution (cf.
``glt_tpu/analysis/symbols.py``).

This is the layer that turns gltlint from a per-file linter into a
project analysis: :class:`Project` parses the whole file set, assigns
each function a stable id (``module.Class.method``), resolves import
aliases across modules (``from ..channel.base import bounded_get as bg``
and re-exports through ``__init__`` both land on the one definition),
and answers *"which function does this call site invoke?"* — the
question the call graph, the effect engine, and the transitive rules are
built on.

Resolution strategy for ``x.m(...)`` attribute calls, most precise
first:

1. a fully-dotted alias chain (``mod.fn``, ``pkg.mod.Class.m``);
2. ``self.m`` / ``cls.m`` -> the enclosing class (and its bases);
3. a receiver whose class is known — a local assigned from a project
   class constructor, or a ``self.attr`` recorded as
   ``self.attr = SomeClass(...)`` in the class body;
4. unique-method-name fallback: if exactly one class in the project
   defines ``m`` (and ``m`` is not on the generic-name blocklist), bind
   to it.

Unresolvable calls contribute no effects — the analyses stay
calibrated-quiet rather than guess.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Union

from .visitor import (
    FunctionScope,
    ModuleInfo,
    dotted_expr,
    is_capture_name,
    unwrap_capture_target,
)

# Constructors whose result is a mutual-exclusion object; assignments from
# these define the project's lock universe (GLT008/GLT009).
LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    "multiprocessing.Lock", "multiprocessing.RLock",
}

# Method names too generic for the unique-name fallback: binding `.get()`
# or `.close()` to whichever single class happens to define one would
# invent effects out of coincidence.
AMBIGUOUS_METHOD_NAMES = frozenset({
    "get", "put", "join", "wait", "send", "recv", "close", "stop",
    "start", "run", "read", "write", "flush", "acquire", "release",
    "items", "keys", "values", "append", "pop", "add", "clear", "update",
    "copy", "encode", "decode", "set", "is_set", "is_alive", "poll",
    "sample", "next", "sendall", "accept", "connect", "get_nowait",
    "put_nowait", "empty", "shutdown", "reset", "tolist", "item",
    # str.split / np.split / random-key splits: binding a project
    # class's .split to these call sites invents effects.
    "split", "submit",
    # np.load / torch.load / a store's .store: binding a project
    # class's .load (DistDataset.load) to them invents effects out of
    # coincidence.
    "load", "store",
})

_RESOLVE_DEPTH = 8   # alias-chain / inheritance walk bound


@dataclass(eq=False)
class FunctionSymbol:
    """One addressable function definition."""
    fid: str                       # "glt_tpu_torch.channel.base.bounded_get"
    module: ModuleInfo
    scope: FunctionScope
    class_id: Optional[str] = None  # owning class cid for methods

    @property
    def short(self) -> str:
        return self.fid.rsplit(".", 2)[-1] if self.class_id is None \
            else ".".join(self.fid.rsplit(".", 2)[-2:])


@dataclass(eq=False)
class ClassSymbol:
    """One class definition, with the facts the analyses need: bases,
    methods, constructor-assigned attribute types, and lock attributes."""
    cid: str
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    base_refs: List[str] = field(default_factory=list)
    methods: Dict[str, FunctionSymbol] = field(default_factory=dict)
    lock_attrs: Set[str] = field(default_factory=set)
    attr_type_refs: Dict[str, str] = field(default_factory=dict)


Symbol = Union[FunctionSymbol, ClassSymbol]


class Project:
    """The whole analyzed file set as one namespace."""

    def __init__(self, modules: Iterable[ModuleInfo]) -> None:
        mods = list(modules)
        self.modules: Dict[str, ModuleInfo] = {m.name: m for m in mods}
        self.by_path: Dict[str, ModuleInfo] = {m.path: m for m in mods}
        self.functions: Dict[str, FunctionSymbol] = {}   # module-level fns
        self.classes: Dict[str, ClassSymbol] = {}
        self.all_functions: Dict[str, FunctionSymbol] = {}  # incl. nested
        self._fid_by_scope: Dict[FunctionScope, str] = {}
        self._scope_children: Dict[FunctionScope,
                                   Dict[str, FunctionScope]] = {}
        self._module_locks: Dict[str, Set[str]] = {}
        self._method_index: Dict[str, List[FunctionSymbol]] = {}
        for name in sorted(self.modules):
            self._index_module(self.modules[name])
        self._effects = None
        self._mark_cross_module_jit()

    # -- construction ------------------------------------------------------
    def _index_module(self, m: ModuleInfo) -> None:
        for scope in m.scopes:                 # DFS order: parents first
            if isinstance(scope.node, ast.Lambda):
                continue
            if scope.parent is None:
                qual = (f"{scope.class_name}.{scope.name}"
                        if scope.class_name else scope.name)
            else:
                parent_fid = self._fid_by_scope.get(scope.parent)
                if parent_fid is None:
                    continue                   # nested under a lambda
                qual = (parent_fid[len(m.name) + 1:]
                        + f".<locals>.{scope.name}")
                self._scope_children.setdefault(
                    scope.parent, {})[scope.name] = scope
            fid = f"{m.name}.{qual}"
            self._fid_by_scope[scope] = fid
            sym = FunctionSymbol(
                fid, m, scope,
                class_id=(f"{m.name}.{scope.class_name}"
                          if scope.class_name and scope.parent is None
                          else None))
            self.all_functions[fid] = sym
            if scope.parent is None and scope.class_name is None:
                self.functions[fid] = sym
        # classes (top level only; nested classes are out of scope)
        for node in ast.iter_child_nodes(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            cid = f"{m.name}.{node.name}"
            cls = ClassSymbol(cid, node.name, m, node)
            for b in node.bases:
                ref = m.imports.resolve(b)
                if ref:
                    cls.base_refs.append(ref)
            for scope in m.scopes:
                if (scope.parent is None and scope.class_name == node.name
                        and not isinstance(scope.node, ast.Lambda)):
                    sym = self.all_functions.get(
                        f"{cid}.{scope.name}")
                    if sym is not None:
                        cls.methods[scope.name] = sym
                        self._method_index.setdefault(
                            scope.name, []).append(sym)
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Call)):
                    continue
                ref = m.imports.resolve(sub.value.func)
                if ref is None:
                    continue
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        if ref in LOCK_FACTORIES:
                            cls.lock_attrs.add(t.attr)
                        else:
                            cls.attr_type_refs.setdefault(t.attr, ref)
            self.classes[cid] = cls
        # module-level locks
        for stmt in ast.iter_child_nodes(m.tree):
            if not (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)
                    and m.imports.resolve(stmt.value.func)
                    in LOCK_FACTORIES):
                continue
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self._module_locks.setdefault(
                        m.name, set()).add(t.id)

    def _mark_cross_module_jit(self) -> None:
        """Capture roots the target's home module cannot see: a capture
        of a function imported from another project module, and the
        argument of every construction of a *forwarder* class, one whose
        ``__init__`` keeps a parameter as ``self.<attr>`` that a method
        captures (``CapturedProgram(self.fn, ...)``, or a captured lambda
        calling ``self.fn(...)``: the argument's parameters then take the
        lambda's taint through that call).  The marked modules re-run
        their transitive marking."""
        remark: Set[ModuleInfo] = set()
        # cid -> {init param: (lambda scope, call) or None}
        forwarders: Dict[str, Dict[str, Optional[
            Tuple[FunctionScope, ast.Call]]]] = {}
        for name in sorted(self.modules):
            m = self.modules[name]
            for node in m._calls:
                if not is_capture_name(m.call_name(node)):
                    continue
                target = unwrap_capture_target(node, m.imports)
                if target is None:
                    continue
                scope = m._enclosing_scope(node)
                via = None
                if isinstance(target, ast.Lambda) and isinstance(
                        target.body, ast.Call):
                    via = (m.scope_of(target), target.body)
                    target = target.body.func
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    cls = self.own_class(m, scope)
                    param = self._init_param_of(cls, target.attr)
                    if cls is not None and param is not None:
                        forwarders.setdefault(cls.cid, {})[param] = via
                    continue
                if via is not None or not isinstance(
                        target, (ast.Name, ast.Attribute)):
                    continue
                sym = self.resolve_dotted(m.imports.resolve(target) or "")
                if (isinstance(sym, FunctionSymbol) and sym.module is not m
                        and not sym.scope.jit_root):
                    sym.module.mark_root(
                        sym.scope,
                        f"captured at {m.path}:{node.lineno}")
                    remark.add(sym.module)
        if forwarders:
            for name in sorted(self.modules):
                m = self.modules[name]
                for node in m._calls:
                    scope = m._enclosing_scope(node)
                    cls = self.resolve_call(m, scope, node)
                    if not (isinstance(cls, ClassSymbol)
                            and cls.cid in forwarders):
                        continue
                    init = cls.methods.get("__init__")
                    pos = init.scope.params[1:] if init is not None else []
                    bound = {pos[i]: a for i, a in enumerate(node.args)
                             if i < len(pos)}
                    bound.update({kw.arg: kw.value for kw in node.keywords
                                  if kw.arg})
                    for param, via in forwarders[cls.cid].items():
                        arg = bound.get(param)
                        if arg is None:
                            continue
                        for target in m.scopes_for_target(arg):
                            if target.jit_root:
                                continue
                            m.mark_root(target, f"captured through "
                                        f"{cls.name} at line {node.lineno}")
                            if via is not None and via[0] is not None:
                                target.transitive_call = via
                            remark.add(m)
        for m in remark:
            m._mark_called_from_jit()

    def _init_param_of(self, cls: Optional[ClassSymbol],
                       attr: str) -> Optional[str]:
        """The ``__init__`` parameter a class keeps as ``self.<attr>``."""
        init = cls.methods.get("__init__") if cls is not None else None
        if init is None:
            return None
        params = set(init.scope.params[1:])
        for node in ast.walk(init.scope.node):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in params
                    and any(isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self" and t.attr == attr
                            for t in node.targets)):
                return node.value.id
        return None

    # -- lazily-built analyses ---------------------------------------------
    @property
    def effects(self):
        """The per-function effect summaries (built on first use)."""
        if self._effects is None:
            from .effects import EffectEngine
            self._effects = EffectEngine(self)
        return self._effects

    # -- queries -----------------------------------------------------------
    def fid_of(self, scope: FunctionScope) -> Optional[str]:
        return self._fid_by_scope.get(scope)

    def resolve_dotted(self, dotted: str,
                       depth: int = 0) -> Optional[Symbol]:
        """A project symbol for a canonical dotted path, following
        re-export alias chains (bounded)."""
        if not dotted or depth > _RESOLVE_DEPTH:
            return None
        if dotted in self.functions:
            return self.functions[dotted]
        if dotted in self.classes:
            return self.classes[dotted]
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod_name = ".".join(parts[:cut])
            m = self.modules.get(mod_name)
            if m is None:
                continue
            rest = parts[cut:]
            if len(rest) == 1:
                target = m.imports.alias_of(rest[0])
                if target and target != dotted:
                    return self.resolve_dotted(target, depth + 1)
                return None
            if len(rest) == 2:
                cls = self.classes.get(f"{mod_name}.{rest[0]}")
                if cls is not None:
                    return self.class_method(cls, rest[1])
                target = m.imports.alias_of(rest[0])
                if target and f"{target}.{rest[1]}" != dotted:
                    return self.resolve_dotted(f"{target}.{rest[1]}",
                                               depth + 1)
            return None
        return None

    def class_method(self, cls: ClassSymbol, name: str,
                     depth: int = 0) -> Optional[FunctionSymbol]:
        """Method lookup with (bounded) base-class traversal."""
        if name in cls.methods:
            return cls.methods[name]
        if depth >= _RESOLVE_DEPTH:
            return None
        for ref in cls.base_refs:
            base = self._class_from_ref(cls.module, ref)
            if base is not None:
                got = self.class_method(base, name, depth + 1)
                if got is not None:
                    return got
        return None

    def _class_from_ref(self, module: ModuleInfo,
                        ref: str) -> Optional[ClassSymbol]:
        sym = self.resolve_dotted(ref)
        if sym is None and "." not in ref:
            sym = self.resolve_dotted(f"{module.name}.{ref}")
        return sym if isinstance(sym, ClassSymbol) else None

    def class_attr_type(self, cls: ClassSymbol, attr: str,
                        depth: int = 0) -> Optional[ClassSymbol]:
        """The class of ``self.<attr>`` when a constructor assignment
        recorded it (``self.conn = RemoteServerConnection(...)``)."""
        ref = cls.attr_type_refs.get(attr)
        if ref is not None:
            return self._class_from_ref(cls.module, ref)
        if depth >= _RESOLVE_DEPTH:
            return None
        for bref in cls.base_refs:
            base = self._class_from_ref(cls.module, bref)
            if base is not None:
                got = self.class_attr_type(base, attr, depth + 1)
                if got is not None:
                    return got
        return None

    def own_class(self, module: ModuleInfo,
                  scope: Optional[FunctionScope]) -> Optional[ClassSymbol]:
        if scope is None or not scope.class_name:
            return None
        return self.classes.get(f"{module.name}.{scope.class_name}")

    def resolve_call(self, module: ModuleInfo,
                     scope: Optional[FunctionScope], call: ast.Call,
                     type_env: Optional[Dict[str, ClassSymbol]] = None
                     ) -> Optional[Symbol]:
        """The project symbol a call site invokes, or None.

        Returns a :class:`FunctionSymbol` for plain calls and a
        :class:`ClassSymbol` for constructor calls (effects use its
        ``__init__``).
        """
        func = call.func
        if isinstance(func, ast.Name):
            nm = func.id
            cur = scope
            while cur is not None:           # nested defs shadow outward
                child = self._scope_children.get(cur, {}).get(nm)
                if child is not None:
                    return self.all_functions.get(
                        self._fid_by_scope.get(child, ""))
                cur = cur.parent
            sym = (self.functions.get(f"{module.name}.{nm}")
                   or self.classes.get(f"{module.name}.{nm}"))
            if sym is not None:
                return sym
            target = module.imports.alias_of(nm)
            if target:
                return self.resolve_dotted(target)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        meth = func.attr
        dotted = module.imports.resolve(func)
        if dotted:
            sym = self.resolve_dotted(dotted)
            if sym is not None:
                return sym
        base = func.value
        own = self.own_class(module, scope)
        if (isinstance(base, ast.Name) and base.id in ("self", "cls")
                and own is not None):
            got = self.class_method(own, meth)
            if got is not None:
                return got
        if type_env:
            recv = dotted_expr(base)
            cls = type_env.get(recv) if recv else None
            if cls is not None:
                got = self.class_method(cls, meth)
                if got is not None:
                    return got
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and own is not None):
            t = self.class_attr_type(own, base.attr)
            if t is not None:
                got = self.class_method(t, meth)
                if got is not None:
                    return got
        if (not meth.startswith("__")
                and meth not in AMBIGUOUS_METHOD_NAMES):
            cands = self._method_index.get(meth, [])
            if len(cands) == 1:
                return cands[0]
        return None

    # -- locks -------------------------------------------------------------
    def lock_id(self, module: ModuleInfo, scope: Optional[FunctionScope],
                expr: ast.expr,
                type_env: Optional[Dict[str, ClassSymbol]] = None
                ) -> Optional[str]:
        """Canonical id for a lock expression at a use site
        (``with self._lock:`` / ``_LOCK.acquire()``), or None when the
        expression is not a known lock object."""
        d = dotted_expr(expr)
        if d is None:
            return None
        parts = d.split(".")
        if len(parts) == 1:
            if parts[0] in self._module_locks.get(module.name, set()):
                return f"{module.name}.{parts[0]}"
            target = module.imports.alias_of(parts[0])
            if target and "." in target:
                mod, var = target.rsplit(".", 1)
                if var in self._module_locks.get(mod, set()):
                    return target
            return None
        if len(parts) == 2:
            if parts[0] in ("self", "cls"):
                own = self.own_class(module, scope)
                if own is not None and self._has_lock_attr(own, parts[1]):
                    return f"{own.cid}.{parts[1]}"
                return None
            if type_env:
                cls = type_env.get(parts[0])
                if cls is not None and self._has_lock_attr(cls, parts[1]):
                    return f"{cls.cid}.{parts[1]}"
            # module-qualified: native._LOCK
            target = module.imports.alias_of(parts[0])
            if target and parts[1] in self._module_locks.get(target, set()):
                return f"{target}.{parts[1]}"
        if len(parts) == 3 and parts[0] == "self":
            # self.attr._lock with a typed attr
            own = self.own_class(module, scope)
            if own is not None:
                t = self.class_attr_type(own, parts[1])
                if t is not None and self._has_lock_attr(t, parts[2]):
                    return f"{t.cid}.{parts[2]}"
        return None

    def _has_lock_attr(self, cls: ClassSymbol, attr: str,
                       depth: int = 0) -> bool:
        if attr in cls.lock_attrs:
            return True
        if depth >= _RESOLVE_DEPTH:
            return False
        return any(
            self._has_lock_attr(base, attr, depth + 1)
            for ref in cls.base_refs
            for base in [self._class_from_ref(cls.module, ref)]
            if base is not None)
