"""Shared AST machinery: import resolution and scopes (cf.
``glt_tpu/analysis/visitor.py``).

Every rule needs two questions answered about a module:

1. *What does this name really mean?*  ``queue.Queue`` vs
   ``from queue import Queue`` vs ``import queue as q; q.Queue`` are one
   callee.  :class:`ImportMap` canonicalises call targets to full dotted
   paths (``"queue.Queue"``, ``"numpy.random.default_rng"``, ...), and
   resolves relative imports against the importing package.

2. *Which function scopes are there?*  :class:`ModuleInfo` lists every
   function, method and lambda with its enclosing function and class;
   the rules and the project symbol table (analysis/symbols.py) key
   their per-function analyses by these scopes.

The JAX linter also classifies traced (jit/shard_map) scopes here; the
port's rules read no such classification, so it is not carried over.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


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


@dataclass(eq=False)     # identity hash: scopes key analysis caches
class FunctionScope:
    node: FunctionNode
    name: str
    parent: Optional["FunctionScope"]     # enclosing function, if nested
    class_name: Optional[str]             # enclosing class, if a method

    @property
    def params(self) -> List[str]:
        return param_names(self.node)


class ModuleInfo:
    """Parsed module + resolved imports + function scopes.

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
        stack: List[ast.AST] = [self.tree]
        while stack:
            parent = stack.pop()
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
                stack.append(child)
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    import_nodes.append(child)
        self.imports = ImportMap().collect(import_nodes,
                                           package=self.package)
        self.scopes: List[FunctionScope] = []
        self._scope_by_node: Dict[ast.AST, FunctionScope] = {}
        self._collect_scopes(self.tree, None, None)

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

    def scope_of(self, fn: FunctionNode) -> Optional[FunctionScope]:
        return self._scope_by_node.get(fn)

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.imports.resolve(call.func)
