"""Collective verification across the processes of a mesh: GLT020/021
in their torch forms (cf. ``glt_tpu/analysis/spmd.py``).

A mesh that spans processes (``parallel/multihost.py`` ``global_mesh``,
``global_mesh_2d``) runs one program in every process: every
collective — ``Fleet.exchange``/``rotate``/``all_reduce``/``any_host``,
``multihost.barrier`` and ``agree_*``, a ``torch.distributed``
collective — is a rendezvous over gloo, and a process that skips one
leaves the others blocked in it with no Python frame to debug.  Two
hazards are statically checkable:

* **GLT020 divergent-collective** — a collective under an ``if`` or
  ``while`` whose predicate data-depends on a *rank-local* value.
  Rank-local taint seeds from ``multihost.process_index()``,
  ``torch.distributed.get_rank()``, ``local_shard_range(...)`` and a
  mesh's or fleet's ``.local`` shards, and propagates through
  assignments and loops; values that pass through an *agreeing*
  collective (``Fleet.all_reduce``, ``agree_*``, ``any_host``) are the
  same in every process again and launder the taint, as ``psum`` does
  in ``glt_tpu``.  With a project, a call into a function whose effect
  summary launches a collective counts as one.

* **GLT021 unknown-axis-name** — an axis literal passed to
  ``local_shard_range``, ``resolve_mesh_axes``, ``mesh_axis_sizes`` or
  as a sampler's or step's ``axis_name=`` that the mesh it is given
  does not bind.  Axis sets come from ``Mesh(devices, axis_names)``
  (default ``("shard",)``), ``global_mesh(..., axis_name)`` (default
  ``"shard"``) and ``global_mesh_2d(..., host_axis, chip_axis)``
  (default ``("host", "chip")``); meshes built from parameters are
  *open* and produce no findings.  String constants resolve through the
  project symbol table: unresolvable means silent, not worst-case.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .effects import is_collective
from .kernelmodel import const_value
from .report import Finding, Severity
from .rules import Rule, register
from .symbols import FunctionSymbol
from .visitor import (
    SHARD_MAP_NAMES,
    FunctionScope,
    ModuleInfo,
    api_name,
    is_port_api,
)

_MULTIHOST = "glt_tpu_torch.parallel.multihost."
# Calls whose result is rank-local.
_RANK_LOCAL = {_MULTIHOST + "process_index", _MULTIHOST + "local_shard_range"}
_TORCH_RANK = {"torch.distributed.get_rank"}
# Attributes whose value is rank-local (``mesh.local``, ``fleet.local``).
_RANK_ATTRS = {"local"}
# Collectives whose *result* is the same in every process: they launder
# rank-local taint.
_AGREEING = {_MULTIHOST + "agree_max", _MULTIHOST + "agree_first",
             _MULTIHOST + "agree_sum"}
_AGREEING_METHODS = {"all_reduce", "any_host"}
# A cheap pre-filter: the module reads some rank-local value.
_RANK_TEXT = re.compile(r"process_index|get_rank|local_shard_range|\.local\b")
# Axis consumers: canonical name -> index of the axis argument.
_AXIS_CALLS = {_MULTIHOST + "local_shard_range": 1,
               _MULTIHOST + "resolve_mesh_axes": 1,
               _MULTIHOST + "mesh_axis_sizes": 1}


def _is_rank_seed(module: ModuleInfo, node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        name = module.call_name(node)
        return is_port_api(name, _RANK_LOCAL) or name in _TORCH_RANK
    return isinstance(node, ast.Attribute) and node.attr in _RANK_ATTRS \
        and isinstance(node.ctx, ast.Load)


def _agrees(module: ModuleInfo, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if is_port_api(module.call_name(node), _AGREEING):
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _AGREEING_METHODS)


# ---------------------------------------------------------------------------
# GLT020 divergent-collective
# ---------------------------------------------------------------------------

def _assign_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_assign_names(el))
        return out
    return []


def _tainted_reads(module: ModuleInfo, expr: ast.AST, taint: Set[str]
                   ) -> Optional[str]:
    """First rank-local read in ``expr`` (a tainted name, or a seed read
    inline), skipping subtrees whose value an agreeing collective makes
    the same in every process (taint laundering)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if _agrees(module, node):
            continue                # uniform result: do not descend
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in taint:
            return node.id
        if _is_rank_seed(module, node):
            return ast.unparse(node)
        stack.extend(ast.iter_child_nodes(node))
    return None


def _seed_desc(module: ModuleInfo, node: ast.AST) -> str:
    if isinstance(node, ast.Call):
        name = module.call_name(node) or ""
        return f"{api_name(name) or name.rsplit('.', 1)[-1]}()"
    return f".{node.attr}"


def _unit_taint(module: ModuleInfo, unit: ast.AST
                ) -> Dict[str, Tuple[str, int]]:
    """Rank-local variables in a top-level scope's whole subtree:
    ``{name: (seed description, seed line)}``, propagated through
    assignments and ``for`` targets (nested defs included — closures
    share the namespace)."""
    origin: Dict[str, Tuple[str, int]] = {}

    def bindings(node: ast.AST):
        if isinstance(node, ast.Assign):
            return node.value, [n for t in node.targets
                                for n in _assign_names(t)]
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return node.iter, _assign_names(node.target)
        return None, []

    for node in ast.walk(unit):
        value, names = bindings(node)
        if value is None or _agrees(module, value):
            continue
        for sub in ast.walk(value):
            if _is_rank_seed(module, sub):
                for name in names:
                    origin.setdefault(name, (
                        f"{_seed_desc(module, sub)} at line {sub.lineno}",
                        sub.lineno))
                break
    for _ in range(3):               # shallow chains; fixpoint fast
        changed = False
        for node in ast.walk(unit):
            value, names = bindings(node)
            if value is None:
                continue
            hit = _tainted_reads(module, value, set(origin))
            if hit is None or hit not in origin:
                continue
            for name in names:
                if name not in origin:
                    origin[name] = (f"'{hit}' <- {origin[hit][0]}",
                                    origin[hit][1])
                    changed = True
        if not changed:
            break
    return origin


@register
class DivergentCollective(Rule):
    """Collectives under rank-dependent control flow deadlock."""
    name = "divergent-collective"
    code = "GLT020"
    severity = Severity.ERROR
    description = ("a collective of the processes (Fleet exchange, "
                   "multihost barrier/agree_*, torch.distributed) under "
                   "an if/while whose predicate depends on a rank-local "
                   "value (process_index, get_rank, local shards): "
                   "processes diverge and the rendezvous deadlocks")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        if not _RANK_TEXT.search(module.source):
            return findings
        for scope in module.scopes:
            if scope.parent is not None:
                continue
            taint = _unit_taint(module, scope.node)
            findings.extend(self._check_unit(module, scope, taint,
                                             project))
        return findings

    def _has_collective(self, module: ModuleInfo, scope: FunctionScope,
                        roots: List[ast.AST], project) -> bool:
        for root in roots:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                if is_collective(module, node):
                    return True
                if project is not None:
                    sym = project.resolve_call(module, scope, node)
                    if isinstance(sym, FunctionSymbol) and \
                            project.effects.summary_for(sym).collective:
                        return True
        return False

    def _check_unit(self, module: ModuleInfo, scope: FunctionScope,
                    taint: Dict[str, Tuple[str, int]],
                    project) -> List[Finding]:
        findings: List[Finding] = []
        names = set(taint)
        for node in ast.walk(scope.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            hit = _tainted_reads(module, node.test, names)
            if hit is None:
                continue
            bodies: List[ast.AST] = list(node.body) + list(node.orelse)
            if not self._has_collective(module, scope, bodies, project):
                continue
            desc, line = taint.get(hit, ("read inline", node.lineno))
            where = "a Python branch" if isinstance(node, ast.If) \
                else "a while loop (rank-dependent trip count)"
            findings.append(self.finding(
                module, node,
                f"collective inside {where} whose predicate "
                f"'{ast.unparse(node.test)}' depends on rank-local "
                f"'{hit}' ({desc}, seeded at line {line}): processes "
                f"take different branches and the collective rendezvous "
                f"deadlocks — hoist the collective out of the branch or "
                f"make the predicate uniform (agree on it with "
                f"Fleet.all_reduce/agree_max first)"))
        return findings


# ---------------------------------------------------------------------------
# GLT021 unknown-axis-name
# ---------------------------------------------------------------------------

def _axis_literal(module: ModuleInfo, expr: Optional[ast.expr],
                  project) -> Optional[Set[str]]:
    """Axis names an expression statically resolves to, else None
    (parametric/unknown — calibrated-quiet)."""
    if expr is None:
        return None
    val = const_value(module, expr, project)
    if isinstance(val, str):
        return {val}
    if isinstance(val, tuple) and val \
            and all(isinstance(v, str) for v in val):
        return set(val)
    return None


def _arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.expr]:
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return call.args[pos] if len(call.args) > pos else None


def _mesh_axes(module: ModuleInfo, scope: Optional[FunctionScope],
               expr: ast.expr, project) -> Optional[Set[str]]:
    """Axis set bound by a mesh expression, else None (open mesh)."""
    call = expr
    if isinstance(expr, ast.Name):
        cur = scope
        while cur is not None and call is expr:
            for node in ast.walk(cur.node):
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in node.targets):
                    call = node.value
            cur = cur.parent
        if call is expr:
            for node in module.tree.body:
                if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == expr.id
                        for t in node.targets):
                    call = node.value
    if not isinstance(call, ast.Call):
        return None
    name = module.call_name(call)
    if not is_port_api(name, SHARD_MAP_NAMES):
        return None
    kind = api_name(name)
    if kind == "Mesh":
        axes = _arg(call, 1, "axis_names")
        return {"shard"} if axes is None else _axis_literal(
            module, axes, project)
    if kind == "global_mesh":
        axis = _arg(call, 1, "axis_name")
        return {"shard"} if axis is None else _axis_literal(
            module, axis, project)
    out: Set[str] = set()
    for pos, kw, default in ((1, "host_axis", "host"),
                             (2, "chip_axis", "chip")):
        axis = _arg(call, pos, kw)
        got = {default} if axis is None else _axis_literal(
            module, axis, project)
        if got is None:
            return None
        out |= got
    return out


@register
class UnknownAxisName(Rule):
    """Axis names passed with a mesh must exist on that mesh."""
    name = "unknown-axis-name"
    code = "GLT021"
    severity = Severity.ERROR
    description = ("an axis literal passed to local_shard_range, "
                   "resolve_mesh_axes, mesh_axis_sizes or as axis_name= "
                   "names an axis the mesh it is given does not bind "
                   "(stale string after a mesh-axis rename); parametric "
                   "meshes are skipped")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        if "axis" not in module.source \
                and "local_shard_range" not in module.source:
            return findings
        seen: Set[int] = set()
        for scope in module.scopes:
            for node in ast.walk(scope.node):
                if isinstance(node, ast.Call) and id(node) not in seen:
                    seen.add(id(node))
                    findings.extend(self._check_call(module, scope, node,
                                                     project))
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call) and id(node) not in seen:
                seen.add(id(node))
                findings.extend(self._check_call(module, None, node,
                                                 project))
        return findings

    def _check_call(self, module: ModuleInfo,
                    scope: Optional[FunctionScope], call: ast.Call,
                    project) -> List[Finding]:
        name = module.call_name(call)
        axis: Optional[ast.expr] = None
        mesh: Optional[ast.expr] = None
        what = ""
        for canon, pos in _AXIS_CALLS.items():
            if is_port_api(name, {canon}):
                axis = _arg(call, pos, "axis_name")
                mesh = _arg(call, 0, "mesh")
                what = f"{canon.rsplit('.', 1)[-1]}()"
        if axis is None:
            axis = next((k.value for k in call.keywords
                         if k.arg == "axis_name"), None)
            if axis is None:
                return []
            mesh = next((k.value for k in call.keywords
                         if k.arg == "mesh"), None)
            if mesh is None:
                mesh = next((a for a in call.args if _mesh_axes(
                    module, scope, a, project) is not None), None)
            what = f"axis_name= of {ast.unparse(call.func)}()"
        if mesh is None:
            return []
        axes = _mesh_axes(module, scope, mesh, project)
        names = _axis_literal(module, axis, project)
        if axes is None or names is None:
            return []                      # open mesh: stay quiet
        missing = sorted(names - axes)
        if not missing:
            return []
        return [self.finding(
            module, call,
            f"{what} names axis {missing} but the mesh it is given binds "
            f"only {sorted(axes)} — the shards and exchanges are laid "
            f"out over an axis that does not exist (stale axis string "
            f"after a mesh rename?)")]
