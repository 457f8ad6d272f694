"""Shared AST machinery: import resolution, scopes, capture-context
discovery (cf. ``glt_tpu/analysis/visitor.py``).

Every rule needs the same three questions answered about a module:

1. *What does this name really mean?*  ``queue.Queue`` vs
   ``from queue import Queue`` vs ``import queue as q; q.Queue`` are one
   callee.  :class:`ImportMap` canonicalises call targets to full dotted
   paths (``"queue.Queue"``, ``"torch.cuda.graph"``, ...), and resolves
   relative imports against the importing package.

2. *Which code is captured?*  The port's counterpart of a jitted program
   is a CUDA graph: a function passed as ``fn`` to
   ``CapturedProgram(...)`` (``glt_tpu_torch.utils.graphs``) or to
   ``torch.cuda.make_graphed_callables``, and the block under
   ``with torch.cuda.graph(...)``, run once under stream capture; a
   replay runs the recorded launches and no Python.  ``functools.partial``
   unwraps, module functions called from a captured body are captured
   too, and a class that hands a constructor argument to a capture
   (``models/train.py`` ``_ScannedBlocks``, ``parallel/dist_train.py``
   ``_Graphed``) marks the argument of every construction
   (analysis/symbols.py).  Host-side rules must not fire there and
   capture-side rules only fire there.

3. *What is the statement order inside a function?*  Key-reuse and
   output-rewrite analyses walk statements linearly, forking state at
   ``if`` branches (a use in the else-branch is not "after" a use in the
   then-branch).

This module answers 1 and 2 (:class:`ModuleInfo`); rules implement 3 on
top with :func:`iter_statements` / :func:`names_loaded` helpers.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

_PORT = "glt_tpu_torch"

# Canonical dotted names (post alias-resolution) of the capture entry
# points, the counterparts of ``jax.jit``: the callable passed to one of
# them is recorded once into a CUDA graph.  The port's own names match
# through any package path that re-exports them (:func:`api_name`).
JIT_NAMES = {"glt_tpu_torch.utils.graphs.CapturedProgram",
             "torch.cuda.make_graphed_callables"}
# ``with torch.cuda.graph(g):`` captures the block under it.
GRAPH_CONTEXTS = {"torch.cuda.graph"}
# The counterparts of ``shard_map``: the constructions that bind a
# mesh's axis names (``parallel/multihost.py``).
SHARD_MAP_NAMES = {"glt_tpu_torch.parallel.multihost.Mesh",
                   "glt_tpu_torch.parallel.multihost.global_mesh",
                   "glt_tpu_torch.parallel.multihost.global_mesh_2d"}
PARTIAL_NAMES = {"functools.partial", "partial"}
# Wrappers peeled off a capture's callable to reach the function whose
# body is recorded.
TRACE_WRAPPERS = JIT_NAMES | PARTIAL_NAMES


def api_name(name: Optional[str]) -> Optional[str]:
    """The last part of a dotted name when it names the port's API (any
    ``glt_tpu_torch.*`` path, so re-exports match) or a bare local name
    (an unresolved relative import), else None."""
    if not name:
        return None
    head, _, last = name.rpartition(".")
    if not head or head == _PORT or head.startswith(_PORT + "."):
        return last
    return None


def is_port_api(name: Optional[str], canonical: Set[str]) -> bool:
    """Does ``name`` reach one of the ``canonical`` dotted names, through
    the path it names or through any path of the port's package?"""
    if name in canonical:
        return True
    last = api_name(name)
    return last is not None and any(
        c.startswith(_PORT + ".") and c.rsplit(".", 1)[-1] == last
        for c in canonical)


def is_capture_name(name: Optional[str]) -> bool:
    return is_port_api(name, JIT_NAMES)


class ImportMap:
    """Alias table mapping local names to canonical dotted module paths.

    When ``package`` is given (the importing module's package), relative
    imports — ``from ..channel.base import bounded_get`` — are resolved
    against it to absolute dotted paths, so cross-module symbol lookup
    (analysis/symbols.py) sees one canonical spelling.
    """

    def __init__(self) -> None:
        self._alias: Dict[str, str] = {}

    def collect(self, tree_or_nodes, package: str = "") -> "ImportMap":
        """Collect aliases from a whole tree, or from a pre-gathered
        iterable of Import/ImportFrom nodes (ModuleInfo passes the list
        from its single traversal)."""
        nodes = (ast.walk(tree_or_nodes)
                 if isinstance(tree_or_nodes, ast.AST) else tree_or_nodes)
        for node in nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    self._alias[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = package.split(".") if package else []
                    cut = len(pkg) - (node.level - 1)
                    if cut < 0:
                        continue          # escapes the analyzed root
                    prefix = ".".join(pkg[:cut])
                    base = (f"{prefix}.{node.module}"
                            if node.module and prefix
                            else (prefix or node.module or ""))
                if not base:
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    self._alias[a.asname or a.name] = f"{base}.{a.name}"
        return self

    def alias_of(self, name: str) -> Optional[str]:
        """The canonical dotted target this local name was imported as."""
        return self._alias.get(name)

    def resolve(self, node: ast.expr) -> Optional[str]:
        """Canonical dotted path for a Name/Attribute chain, else None.

        Unaliased bare names resolve to themselves so builtins (``open``,
        ``int``) and locals still produce a comparable string.
        """
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = self._alias.get(cur.id, cur.id)
        parts.append(root)
        return ".".join(reversed(parts))


def names_loaded(node: ast.AST) -> Set[str]:
    """All Name identifiers read anywhere inside ``node``."""
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def param_names(fn: FunctionNode) -> List[str]:
    a = fn.args
    names = [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def assign_targets(node: ast.stmt) -> List[str]:
    """Plain-Name targets (including tuple unpacking) of an assignment."""
    out: List[str] = []
    targets: Sequence[ast.expr] = ()
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = (node.target,)
    for t in targets:
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                if isinstance(el, ast.Name):
                    out.append(el.id)
                elif isinstance(el, ast.Starred) and isinstance(
                        el.value, ast.Name):
                    out.append(el.value.id)
    return out


def walk_own(node: ast.AST) -> Iterator[ast.AST]:
    """Walk an AST without descending into nested function/class bodies
    (those are separate scopes with their own analysis passes)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if not isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(cur))


def dotted_expr(node: ast.expr) -> Optional[str]:
    """'self.x.y' style dotted string for Name/Attribute chains (no alias
    resolution — used for tracking local/attribute variables)."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


STATIC_ATTRS = ("shape", "ndim", "dtype", "size", "device", "is_cuda")


def traced_names(node: ast.AST) -> Set[str]:
    """Names + dotted attribute strings read inside ``node``, except those
    reached only through a static attribute (``x.shape[0]`` and
    ``x.device`` are host values even for a device tensor, so they are
    not reads of its data)."""
    out: Set[str] = set()
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, ast.Attribute) and cur.attr in STATIC_ATTRS:
            continue                       # x.shape / x.device: static
        if isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute) \
                and cur.func.attr in ("size", "dim", "numel", "stride"):
            continue                       # x.size(0): a host int
        if isinstance(cur, ast.Name) and isinstance(cur.ctx, ast.Load):
            out.add(cur.id)
        if isinstance(cur, ast.Attribute):
            d = dotted_expr(cur)
            if d is not None:
                out.add(d)
        stack.extend(ast.iter_child_nodes(cur))
    return out


_HOST_TYPES = {"int", "float", "bool", "str", "bytes", "None"}
_HOST_GENERICS = {"Tuple", "tuple", "Sequence", "List", "list", "Optional",
                  "Union"}


def is_host_annotation(ann: Optional[ast.expr]) -> bool:
    """Does an annotation name a host type only (``int``, ``str``,
    ``Tuple[int, int]``, ``Optional[float]``)?  Such a name never holds a
    device tensor."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        return ann.value is None or ann.value is Ellipsis or (
            isinstance(ann.value, str) and ann.value in _HOST_TYPES)
    if isinstance(ann, ast.Name):
        return ann.id in _HOST_TYPES
    if isinstance(ann, ast.Subscript):
        base = ann.value
        base_name = (base.id if isinstance(base, ast.Name) else
                     base.attr if isinstance(base, ast.Attribute) else "")
        if base_name not in _HOST_GENERICS:
            return False
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return all(is_host_annotation(e) for e in elts)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (is_host_annotation(ann.left)
                and is_host_annotation(ann.right))
    return False


def host_names(fn: FunctionNode) -> Set[str]:
    """Parameters and locals of ``fn`` annotated with a host type."""
    out: Set[str] = set()
    if isinstance(fn, ast.Lambda):
        return out
    a = fn.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if is_host_annotation(p.annotation):
            out.add(p.arg)
    for node in walk_own(fn):
        if (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)
                and is_host_annotation(node.annotation)):
            out.add(node.target.id)
    return out


def host_guarded(module: "ModuleInfo", call: ast.Call,
                 root: ast.AST) -> bool:
    """Is a coercion ``int(x)`` inside a branch of an ``if`` (statement
    or expression) that proves
    ``x`` a host value (under ``if not isinstance(x, torch.Tensor)`` or
    ``if isinstance(x, int)``, or in the ``else`` of ``if isinstance(x,
    torch.Tensor)``), below ``root``?"""
    if not call.args or not isinstance(call.args[0], ast.Name):
        return False
    var = call.args[0].id
    child: ast.AST = call
    cur = module.parents.get(call)
    while cur is not None and cur is not root:
        if isinstance(cur, ast.IfExp):
            then, other = [cur.body], [cur.orelse]
        elif isinstance(cur, ast.If):
            then, other = cur.body, cur.orelse
        else:
            then, other = [], []
        if child in then or child in other:
            test, negated = cur.test, child in other
            if isinstance(test, ast.UnaryOp) and isinstance(test.op,
                                                            ast.Not):
                test, negated = test.operand, True
            if (isinstance(test, ast.Call)
                    and isinstance(test.func, ast.Name)
                    and test.func.id == "isinstance"
                    and len(test.args) == 2
                    and isinstance(test.args[0], ast.Name)
                    and test.args[0].id == var):
                kinds = test.args[1]
                names = {module.imports.resolve(k) for k in (
                    kinds.elts if isinstance(kinds, ast.Tuple) else [kinds])}
                if negated and "torch.Tensor" in names:
                    return True
                if not negated and names and names <= _HOST_TYPES:
                    return True
        child, cur = cur, module.parents.get(cur)
    return False


def module_name_for_path(path: str) -> str:
    """Dotted module name for a file, walking up through ``__init__.py``
    packages (``glt_tpu_torch/channel/base.py`` ->
    ``glt_tpu_torch.channel.base``); a file outside any package resolves
    to its bare stem."""
    path = os.path.abspath(path)
    base = os.path.splitext(os.path.basename(path))[0]
    parts = [] if base == "__init__" else [base]
    d = os.path.dirname(path)
    while d and os.path.isfile(os.path.join(d, "__init__.py")):
        parts.insert(0, os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return ".".join(parts) or base


def iter_statements(body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
    """Flatten statements in source order, descending into compound
    statements (but NOT into nested function/class definitions)."""
    for stmt in body:
        yield stmt
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, attr, None)
            if sub and not isinstance(stmt, (ast.FunctionDef,
                                             ast.AsyncFunctionDef,
                                             ast.ClassDef)):
                yield from iter_statements(sub)
        for handler in getattr(stmt, "handlers", ()) or ():
            yield from iter_statements(handler.body)


@dataclass(eq=False)     # identity hash: scopes key analysis caches
class FunctionScope:
    node: FunctionNode
    name: str
    parent: Optional["FunctionScope"]     # enclosing function, if nested
    class_name: Optional[str]             # enclosing class, if a method
    jit_root: bool = False                # directly captured
    jit_reason: str = ""                  # how it became a capture context
    # set when capture-ness is only transitive (called from a captured
    # body): (caller scope, call node) -- rules use it to bind caller
    # taint to params instead of assuming every param is a device buffer
    transitive_call: Optional[Tuple["FunctionScope", ast.Call]] = None

    @property
    def params(self) -> List[str]:
        return param_names(self.node)


@dataclass(eq=False)
class GraphRegion:
    """The block under ``with torch.cuda.graph(...)`` in ``scope`` (None
    at module level)."""
    node: ast.With
    scope: Optional[FunctionScope]


def unwrap_capture_target(call: ast.Call, imports: ImportMap
                          ) -> Optional[ast.expr]:
    """Peel ``CapturedProgram(partial(fn, ...), ...)`` down to the
    innermost captured callable expression (``fn``): the first
    positional argument, or ``fn=``."""
    target: Optional[ast.expr] = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg in ("fn", "callables")),
        None)
    while isinstance(target, ast.Call):
        inner = imports.resolve(target.func)
        if (inner in TRACE_WRAPPERS or is_capture_name(inner)) \
                and target.args:
            target = target.args[0]
        else:
            break
    if isinstance(target, (ast.Tuple, ast.List)) and target.elts:
        target = target.elts[0]        # make_graphed_callables((fn,), ...)
    return target


def _ancestors(scope: FunctionScope) -> List[FunctionScope]:
    """The scope and its enclosing functions: a nested def called by name
    from here is visible if it is defined in one of them."""
    out: List[FunctionScope] = []
    cur: Optional[FunctionScope] = scope
    while cur is not None:
        out.append(cur)
        cur = cur.parent
    return out


class ModuleInfo:
    """Parsed module + resolved imports + capture-context classification.

    ``module_name`` (the dotted import path, e.g.
    ``glt_tpu_torch.distributed.dist_server``) keys the module in a
    project-wide analysis (analysis/symbols.py) and anchors
    relative-import resolution; when omitted it defaults to the file stem
    and relative imports stay unresolved (single-module analysis,
    fixtures).
    """

    def __init__(self, path: str, source: str,
                 module_name: Optional[str] = None):
        self.path = path
        self.source = source
        self.name = module_name or os.path.splitext(
            os.path.basename(path))[0]
        if os.path.basename(path) == "__init__.py":
            self.package = self.name
        else:
            self.package = (self.name.rsplit(".", 1)[0]
                            if "." in self.name else "")
        self.tree = ast.parse(source, filename=path)
        # One traversal feeds the parent map and the import table.
        self.parents: Dict[ast.AST, ast.AST] = {}
        import_nodes: List[ast.stmt] = []
        self._calls: List[ast.Call] = []
        self._withs: List[ast.With] = []
        stack: List[ast.AST] = [self.tree]
        while stack:
            parent = stack.pop()
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
                stack.append(child)
                if isinstance(child, ast.Call):
                    self._calls.append(child)
                elif isinstance(child, ast.With):
                    self._withs.append(child)
                elif isinstance(child, (ast.Import, ast.ImportFrom)):
                    import_nodes.append(child)
        self.imports = ImportMap().collect(import_nodes,
                                           package=self.package)
        self.scopes: List[FunctionScope] = []
        self._scope_by_node: Dict[ast.AST, FunctionScope] = {}
        self._collect_scopes(self.tree, None, None)
        self.graph_regions: List[GraphRegion] = []
        self._mark_jit_roots()
        self._mark_called_from_jit()

    def _collect_scopes(self, node: ast.AST, parent: Optional[FunctionScope],
                        class_name: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = FunctionScope(child, child.name, parent, class_name)
                self.scopes.append(scope)
                self._scope_by_node[child] = scope
                self._collect_scopes(child, scope, None)
            elif isinstance(child, ast.Lambda):
                scope = FunctionScope(child, "<lambda>", parent, class_name)
                self.scopes.append(scope)
                self._scope_by_node[child] = scope
                self._collect_scopes(child, scope, None)
            elif isinstance(child, ast.ClassDef):
                self._collect_scopes(child, parent, child.name)
            else:
                self._collect_scopes(child, parent, class_name)

    # -- capture classification --------------------------------------------
    def _enclosing_scope(self, node: ast.AST) -> Optional[FunctionScope]:
        cur = self.parents.get(node)
        while cur is not None:
            if cur in self._scope_by_node:
                return self._scope_by_node[cur]
            cur = self.parents.get(cur)
        return None

    def scopes_for_target(self, target: ast.expr) -> List[FunctionScope]:
        """The scopes a capture target names: a lambda, a function by
        name (the nearest definition visible where the name is read), or
        ``self.<method>``."""
        if isinstance(target, ast.Lambda) and target in self._scope_by_node:
            return [self._scope_by_node[target]]
        if isinstance(target, ast.Name):
            named = [s for s in self.scopes if s.name == target.id
                     and not isinstance(s.node, ast.Lambda)]
            where = self._enclosing_scope(target)
            for anc in (_ancestors(where) if where is not None else []):
                near = [s for s in named if s.parent is anc]
                if near:
                    return near
            return [s for s in named if s.parent is None]
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            methods = [s for s in self.scopes if s.name == target.attr
                       and s.class_name is not None]
            where = self._enclosing_scope(target)
            while where is not None and where.class_name is None:
                where = where.parent
            own = [s for s in methods if where is not None
                   and s.class_name == where.class_name]
            return own or methods
        return []

    def mark_root(self, scope: FunctionScope, reason: str) -> None:
        scope.jit_root = True
        scope.transitive_call = None
        scope.jit_reason = scope.jit_reason or reason

    def _mark_jit_roots(self) -> None:
        for node in self._calls:
            name = self.call_name(node)
            if not is_capture_name(name):
                continue
            target = unwrap_capture_target(node, self.imports)
            if target is None:
                continue
            for scope in self.scopes_for_target(target):
                self.mark_root(scope, f"captured by {name.rsplit('.', 1)[-1]}"
                               f" at line {node.lineno}")
        for node in self._withs:
            if any(isinstance(item.context_expr, ast.Call)
                   and self.call_name(item.context_expr) in GRAPH_CONTEXTS
                   for item in node.items):
                self.graph_regions.append(
                    GraphRegion(node, self._enclosing_scope(node)))

    def _mark_called_from_jit(self) -> None:
        """One transitive step: module functions called by name (or
        ``self.<method>``) from a captured body are captured too."""
        by_name: Dict[str, List[FunctionScope]] = {}
        for scope in self.scopes:
            by_name.setdefault(scope.name, []).append(scope)
        for _ in range(4):  # small fixpoint; call chains here are shallow
            changed = False
            for scope in [s for s in self.scopes if self.in_jit_context(s)]:
                for node in ast.walk(scope.node):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = None
                    if isinstance(node.func, ast.Name):
                        callee = node.func.id
                    elif (isinstance(node.func, ast.Attribute)
                          and isinstance(node.func.value, ast.Name)
                          and node.func.value.id == "self"):
                        callee = node.func.attr
                    if not callee:
                        continue
                    for cand in by_name.get(callee, []):
                        if not cand.jit_root and (
                                cand.parent is None
                                or cand.parent in _ancestors(scope)):
                            cand.jit_root = True
                            cand.jit_reason = (
                                f"called from captured context "
                                f"'{scope.name}' (line {node.lineno})")
                            cand.transitive_call = (scope, node)
                            changed = True
            if not changed:
                break

    # -- queries -----------------------------------------------------------
    def scope_of(self, fn: FunctionNode) -> Optional[FunctionScope]:
        return self._scope_by_node.get(fn)

    def in_jit_context(self, scope: FunctionScope) -> bool:
        """True if the scope's body is captured: it is a capture root, or
        it is nested (def-in-def) inside one."""
        cur: Optional[FunctionScope] = scope
        while cur is not None:
            if cur.jit_root:
                return True
            cur = cur.parent
        return False

    def jit_scopes(self) -> List[FunctionScope]:
        return [s for s in self.scopes if self.in_jit_context(s)]

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.imports.resolve(call.func)
