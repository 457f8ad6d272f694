"""Static launch model of the port's swept CUDA kernels: GLT017 and
GLT019 in their torch forms (cf. ``glt_tpu/analysis/kernelmodel.py``).

A kernel module that sweeps launch points declares them in a module-level
``LAUNCH_MODEL_DOMAIN`` dict, built from the same ``CANDIDATE_*`` tuples
its autotuner crosses (``ops/gather_cuda.py``, ``ops/sample_cuda.py``).
This pass resolves that dict through the project symbol table, without
importing torch, and checks every point of it before the card ever
launches one:

* **GLT017 launch-budget-exceeded** — threads a block above the card's
  limit, or dynamic shared memory above what a launch may take without
  the opt-in attribute.  The shared memory is the module's
  ``dynamic_smem_bytes`` helper (a pure int function) evaluated at every
  point of the domain, its parameters bound by name.  A domain entry or
  helper parameter the model cannot bound is itself an ERROR (declare it
  in the domain), so the check stays total.
* **GLT019 unaligned-launch-shape** — threads not a multiple of the
  warp, a vector width that is not a power of two up to the widest
  load, or lanes per row that are not a power of two up to the warp.

Domain keys read: ``threads``, ``vec_bytes``, ``lanes``; every other key
is a symbol for the helper.  Limits come from ``ops/cuda_limits.py``
through the symbol table (the same values when a lone fixture is
linted), so the kernels and this analyzer cannot disagree.
"""
from __future__ import annotations

import ast
import itertools
from typing import Dict, List, Optional, Tuple

from .report import Finding, Severity
from .rules import Rule, register
from .visitor import ModuleInfo

_DOMAIN_NAME = "LAUNCH_MODEL_DOMAIN"
_SMEM_HELPER = "dynamic_smem_bytes"
_LIMITS_SUFFIX = ".ops.cuda_limits"

# Used when ops/cuda_limits.py is not in the analyzed file set; the
# values mirror that module.
_FALLBACK_LIMITS = {
    "MAX_THREADS_PER_BLOCK": 1024,
    "WARP": 32,
    "MAX_DYNAMIC_SMEM_BYTES": 48 * 1024,
    "MAX_VECTOR_BYTES": 16,
}

_MAX_POINTS = 4096
_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
}


class Unbounded(Exception):
    """An expression the model cannot resolve to a constant."""

    def __init__(self, expr: ast.AST):
        super().__init__(ast.unparse(expr))
        self.expr = expr


def _module_consts(module: ModuleInfo) -> Dict[str, ast.expr]:
    """Module-level ``NAME = <expr>`` assignments (last one wins)."""
    out: Dict[str, ast.expr] = {}
    for stmt in module.tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value
        elif (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
              and isinstance(stmt.target, ast.Name)):
            out[stmt.target.id] = stmt.value
    return out


def _module_function(module: ModuleInfo, name: str
                     ) -> Optional[ast.FunctionDef]:
    for stmt in module.tree.body:
        if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
            return stmt
    return None


def _defining(module: ModuleInfo, name: str, project
              ) -> Tuple[ModuleInfo, str]:
    """The module and attribute a local name was imported from (itself
    when it is not an import the project holds)."""
    dotted = module.imports.alias_of(name)
    if dotted and project is not None and "." in dotted:
        mod_name, attr = dotted.rsplit(".", 1)
        m = project.modules.get(mod_name)
        if m is not None:
            return m, attr
    return module, name


def evaluate(module: ModuleInfo, expr: ast.expr, project=None,
             env: Optional[dict] = None, _depth: int = 0):
    """The constant value of ``expr``: literals, tuples, integer
    arithmetic, conditionals, module and imported constants, names bound
    in ``env``, and calls of ``min``, ``max`` and pure helpers (a
    docstring and one ``return``).  Raises :class:`Unbounded` for
    anything else."""
    env = env or {}
    if _depth > 24:
        raise Unbounded(expr)
    ev = lambda e, m=module, en=env: evaluate(  # noqa: E731
        m, e, project, en, _depth + 1)
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, (bool, int, str)):
            return expr.value
        raise Unbounded(expr)
    if isinstance(expr, (ast.Tuple, ast.List)):
        return tuple(ev(e) for e in expr.elts)
    if isinstance(expr, ast.Name):
        if expr.id in env:
            return env[expr.id]
        m, attr = _defining(module, expr.id, project)
        node = _module_consts(m).get(attr)
        if node is None:
            raise Unbounded(expr)
        return ev(node, m, {})
    if isinstance(expr, ast.BinOp) and type(expr.op) in _BINOPS:
        return _BINOPS[type(expr.op)](ev(expr.left), ev(expr.right))
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
        return -ev(expr.operand)
    if isinstance(expr, ast.IfExp):
        return ev(expr.body) if ev(expr.test) else ev(expr.orelse)
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
        args = [ev(a) for a in expr.args]
        kwargs = {k.arg: ev(k.value) for k in expr.keywords}
        if expr.func.id in ("min", "max") and not kwargs:
            return (min if expr.func.id == "min" else max)(*args)
        m, attr = _defining(module, expr.func.id, project)
        fdef = _module_function(m, attr)
        if fdef is None:
            raise Unbounded(expr)
        params = [a.arg for a in fdef.args.args]
        bound = dict(zip(params, args))
        bound.update(kwargs)
        if set(params) - set(bound):
            raise Unbounded(expr)
        return evaluate(m, _pure_return(fdef), project, bound, _depth + 1)
    raise Unbounded(expr)


def _pure_return(fdef: ast.FunctionDef) -> ast.expr:
    """The expression of a helper whose body is a docstring and one
    ``return``."""
    body = [s for s in fdef.body
            if not (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))]
    if len(body) != 1 or not isinstance(body[0], ast.Return) \
            or body[0].value is None:
        raise Unbounded(fdef)
    return body[0].value


def _limits(module: ModuleInfo, project) -> Dict[str, int]:
    out = dict(_FALLBACK_LIMITS)
    lim = None
    if project is not None:
        for name, m in project.modules.items():
            if name.endswith(_LIMITS_SUFFIX) or name == "cuda_limits":
                lim = m
                break
    if lim is not None:
        consts = _module_consts(lim)
        for key in out:
            if key in consts:
                try:
                    val = evaluate(lim, consts[key], project)
                except Unbounded:
                    continue
                if isinstance(val, int):
                    out[key] = val
    return out


class _Model:
    """One module's resolved launch domain: per entry the values it takes
    (``axes``), the entries the model could not bound (``unbounded``),
    and the helper's shared memory over every point (``smem``: value ->
    one point that gives it)."""

    def __init__(self, module: ModuleInfo, project):
        self.node: Optional[ast.Dict] = None
        self.axes: Dict[str, List[int]] = {}
        self.unbounded: List[Tuple[ast.AST, str]] = []
        self.smem: Dict[int, dict] = {}
        node = _module_consts(module).get(_DOMAIN_NAME)
        if not isinstance(node, ast.Dict):
            return
        self.node = node
        for key, value in zip(node.keys, node.values):
            try:
                name = evaluate(module, key, project)
                v = evaluate(module, value, project)
            except Unbounded as e:
                self.unbounded.append((value, f"'{e}'"))
                continue
            self.axes[str(name)] = list(v) if isinstance(v, tuple) else [v]
        fdef = _module_function(module, _SMEM_HELPER)
        if fdef is None:
            return
        params = [a.arg for a in fdef.args.args]
        missing = [p for p in params if p not in self.axes]
        if missing:
            self.unbounded.append(
                (fdef, f"{_SMEM_HELPER}'s parameter(s) "
                       f"{', '.join(repr(p) for p in missing)}"))
            return
        try:
            ret = _pure_return(fdef)
        except Unbounded:
            self.unbounded.append((fdef, f"{_SMEM_HELPER}'s body (one "
                                         f"return of an int expression)"))
            return
        for pt in itertools.islice(
                itertools.product(*(self.axes[p] for p in params)),
                _MAX_POINTS):
            env = dict(zip(params, pt))
            try:
                val = evaluate(module, ret, project, env)
            except (Unbounded, ArithmeticError, TypeError) as e:
                self.unbounded.append((fdef, f"{_SMEM_HELPER} at {env} "
                                             f"({e})"))
                return
            self.smem.setdefault(int(val), env)


def _model(module: ModuleInfo, project) -> _Model:
    key = id(project)
    cached = getattr(module, "_launch_model", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    model = _Model(module, project)
    module._launch_model = (key, model)
    return model


def _pow2(v) -> bool:
    return isinstance(v, int) and v > 0 and v & (v - 1) == 0


@register
class LaunchBudgetExceeded(Rule):
    """Threads and dynamic shared memory over every swept launch point."""
    name = "launch-budget-exceeded"
    code = "GLT017"
    severity = Severity.ERROR
    description = ("a swept launch point asks for more threads a block or "
                   "more dynamic shared memory than the card gives without "
                   "opting in (or a domain entry is not statically "
                   "boundable)")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        model = _model(module, project)
        if model.node is None:
            return []
        lim = _limits(module, project)
        findings = [self.finding(
            module, node,
            f"launch model cannot bound {what} of {_DOMAIN_NAME} — route "
            f"it through a resolvable constant or declare it in "
            f"{_DOMAIN_NAME} so every swept point is checked")
            for node, what in model.unbounded]
        over = sorted(v for v in model.axes.get("threads", [])
                      if isinstance(v, int)
                      and v > lim["MAX_THREADS_PER_BLOCK"])
        if over:
            findings.append(self.finding(
                module, model.node,
                f"launch model: threads {over} exceed the "
                f"{lim['MAX_THREADS_PER_BLOCK']}-thread block limit — the "
                f"launch would be refused; drop the point from the sweep"))
        cap = lim["MAX_DYNAMIC_SMEM_BYTES"]
        big = {v: pt for v, pt in model.smem.items() if v > cap}
        if big:
            worst = max(big)
            at = ", ".join(f"{k}={v}" for k, v in sorted(big[worst].items()))
            findings.append(self.finding(
                module, model.node,
                f"launch model: {_SMEM_HELPER} = {worst} B at {at} exceeds "
                f"the {cap} B a launch takes without "
                f"cudaFuncAttributeMaxDynamicSharedMemorySize — bound the "
                f"domain or opt the kernel in"))
        return findings


@register
class UnalignedLaunchShape(Rule):
    """Threads, vector widths and lane groups must tile the warp."""
    name = "unaligned-launch-shape"
    code = "GLT019"
    severity = Severity.ERROR
    description = ("a swept launch point whose threads are not a multiple "
                   "of the warp, whose vector width is not a power of two "
                   "up to the widest load, or whose lanes per row are not "
                   "a power of two up to the warp")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        model = _model(module, project)
        if model.node is None:
            return []
        lim = _limits(module, project)
        warp, widest = lim["WARP"], lim["MAX_VECTOR_BYTES"]
        findings = []
        bad = sorted(v for v in model.axes.get("threads", [])
                     if not isinstance(v, int) or v <= 0 or v % warp)
        if bad:
            findings.append(self.finding(
                module, model.node,
                f"threads {bad} are not a multiple of the {warp}-lane "
                f"warp — the last warp of every block runs part empty"))
        bad = sorted(v for v in model.axes.get("vec_bytes", [])
                     if not _pow2(v) or v > widest)
        if bad:
            findings.append(self.finding(
                module, model.node,
                f"vector width {bad} B is not a power of two up to "
                f"{widest} B — no single load or store moves it"))
        bad = sorted(v for v in model.axes.get("lanes", [])
                     if not _pow2(v) or v > warp)
        if bad:
            findings.append(self.finding(
                module, model.node,
                f"lanes per row {bad} are not a power of two up to the "
                f"{warp}-lane warp — a row's lanes would straddle warps "
                f"and the shuffles that share its picks"))
        return findings
