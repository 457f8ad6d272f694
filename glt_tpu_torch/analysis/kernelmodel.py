"""Static model of the port's CUDA kernels: GLT017, GLT018 and GLT019
in their torch forms (cf. ``glt_tpu/analysis/kernelmodel.py``).

A kernel module that sweeps launch points declares them in a module-level
``LAUNCH_MODEL_DOMAIN`` dict, built from the same ``CANDIDATE_*`` tuples
its autotuner crosses (``ops/gather_cuda.py``, ``ops/sample_cuda.py``).
This pass resolves that dict through the project symbol table, without
importing torch, and checks every point of it before the card ever
launches one:

* **GLT017 vmem-budget-exceeded** — threads a block above the card's
  limit, or dynamic shared memory above what a launch may take without
  the opt-in attribute.  The shared memory is the module's
  ``dynamic_smem_bytes`` helper (a pure int function) evaluated at every
  point of the domain, its parameters bound by name.  A domain entry or
  helper parameter the model cannot bound is itself an ERROR (declare it
  in the domain), so the check stays total.
* **GLT018 unbalanced-dma-ring** — the asynchronous-copy rings of the
  CUDA sources a module builds (its ``SOURCES`` tuple, read as text from
  the package's ``csrc/``, since no Python AST holds them): in every
  ``__global__`` function each commit (``cp.async.commit_group``,
  ``__pipeline_commit``, ``cuda::pipeline::producer_commit``, an
  ``mbarrier`` arrive or ``expect_tx``) needs its wait, under the same
  data-dependent guards, and a wait may leave no more groups in flight
  than the ring has slots.
* **GLT019 unaligned-tile-shape** — threads not a multiple of the
  warp, a vector width that is not a power of two up to the widest
  load, or lanes per row that are not a power of two up to the warp.

The rule names are ``glt_tpu``'s: on the card the budget of GLT017 is
the block's threads and shared memory (the counterpart of VMEM), and the
"tile" of GLT019 is the launch shape.

Domain keys read: ``threads``, ``vec_bytes``, ``lanes``; every other key
is a symbol for the helper.  Limits come from ``ops/cuda_limits.py``
through the symbol table (the same values when a lone fixture is
linted), so the kernels and this analyzer cannot disagree.
"""
from __future__ import annotations

import ast
import itertools
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


def const_value(module: ModuleInfo, expr: ast.expr, project=None):
    """:func:`evaluate`, or None where the model cannot bound ``expr``."""
    try:
        return evaluate(module, expr, project)
    except (Unbounded, ArithmeticError, TypeError, ValueError):
        return None


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
class VmemBudgetExceeded(Rule):
    """Threads and dynamic shared memory over every swept launch point."""
    name = "vmem-budget-exceeded"
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


# ---------------------------------------------------------------------------
# GLT018 unbalanced-dma-ring
# ---------------------------------------------------------------------------

_SOURCES_NAME = "SOURCES"
CUDA_SUFFIXES = (".cu", ".cuh")
# (family, commit patterns, wait patterns) of the asynchronous copies.
_RING_FAMILIES = (
    ("cp.async group",
     (r"\bcp\.async\.commit_group\b", r"\b__pipeline_commit\s*\("),
     (r"\bcp\.async\.wait_group\b", r"\bcp\.async\.wait_all\b",
      r"\b__pipeline_wait_prior\s*\(")),
    ("bulk async group",
     (r"\bcp\.async\.bulk\.commit_group\b",),
     (r"\bcp\.async\.bulk\.wait_group(?:\.read)?\b",)),
    ("cuda::pipeline",
     (r"\.producer_commit\s*\(",),
     (r"\.consumer_wait\s*\(",)),
    ("mbarrier",
     (r"\bmbarrier\.arrive\b", r"\bexpect_tx\b",
      r"\bbarrier_arrive_tx\s*\("),
     (r"\bmbarrier\.try_wait\b", r"\bmbarrier\.test_wait\b",
      r"\bmbarrier_wait\s*\(")),
)
# Waits that name how many groups may stay in flight.
_DEPTH_WAITS = (r"\bcp\.async\.wait_group\s+([^;\"]+?)\s*;",
                r"\b__pipeline_wait_prior\s*\(([^)]*)\)")
_RING_NAME = re.compile(r"STAGE|RING|DEPTH|NBUF|SLOTS", re.I)


def _strip_comments(text: str) -> str:
    """The source with comments blanked (line and column positions
    kept); string literals stay, since inline PTX lives in them."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"':
            i += 1
            while i < n and text[i] != '"':
                i += 2 if text[i] == "\\" else 1
            i += 1
        elif text.startswith("//", i):
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif text.startswith("/*", i):
            end = text.find("*/", i + 2)
            end = n if end < 0 else end + 2
            for k in range(i, end):
                if out[k] != "\n":
                    out[k] = " "
            i = end
        else:
            i += 1
    return "".join(out)


def _kernels(text: str) -> Iterator[Tuple[str, int, int]]:
    """(name, body start, body end) of every ``__global__`` function."""
    for m in re.finditer(r"\b__global__\b", text):
        paren = text.find("(", m.end())
        brace = text.find("{", m.end())
        semi = text.find(";", m.end())
        if paren < 0 or brace < 0 or (0 <= semi < brace):
            continue                       # a declaration, no body
        names = re.findall(r"([A-Za-z_]\w*)\s*$", text[m.end():paren])
        depth, i = 0, brace
        while i < len(text):
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        yield (names[0] if names else "<kernel>"), brace, i


def _guards(text: str, start: int, pos: int) -> List[str]:
    """The ``if`` conditions enclosing offset ``pos`` of the body that
    opens at ``start`` (braced blocks and a brace-less ``if`` on the
    event's own statement)."""
    stack: List[str] = []
    last = start + 1
    for i in range(start + 1, pos):
        c = text[i]
        if c == "{":
            stack.append(text[last:i])
            last = i + 1
        elif c == "}":
            if stack:
                stack.pop()
            last = i + 1
        elif c == ";":
            last = i + 1
    stack.append(text[last:pos])
    out = []
    for header in stack:
        m = re.match(r"\s*(?:else\s+)?if\s*\(", header)
        if not m:
            continue
        depth, i = 1, m.end()
        while i < len(header) and depth:
            depth += {"(": 1, ")": -1}.get(header[i], 0)
            i += 1
        out.append(" ".join(header[m.end():i - 1].split()))
    return out


def _data_dependent(cond: str) -> bool:
    """A guard that reads memory (a row predicate), not ring control."""
    return "[" in cond or "__ldg" in cond


def _int_consts(text: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for m in re.finditer(r"(?:#define\s+(\w+)\s+\(?(\d+)\)?"
                         r"|\b(?:constexpr|const)\s+(?:static\s+)?"
                         r"(?:unsigned\s+)?(?:int|long|size_t|uint32_t|"
                         r"int32_t)\s+(\w+)\s*=\s*(\d+)\s*;)", text):
        name = m.group(1) or m.group(3)
        out[name] = int(m.group(2) or m.group(4))
    return out


def _const_expr(expr: str, consts: Dict[str, int]) -> Optional[int]:
    expr = expr.strip().strip("()")
    m = re.fullmatch(r"(\w+)\s*(?:([-+])\s*(\d+))?", expr)
    if not m:
        return None
    base = (int(m.group(1)) if m.group(1).isdigit()
            else consts.get(m.group(1)))
    if base is None:
        return None
    k = int(m.group(3) or 0)
    return base - k if m.group(2) == "-" else base + k


class _RingEvent:
    __slots__ = ("kind", "line", "col", "guards")

    def __init__(self, kind: str, line: int, col: int, guards: List[str]):
        self.kind = kind
        self.line = line
        self.col = col
        self.guards = {g for g in guards if _data_dependent(g)}


def cuda_ring_findings(text: str, path: str, rule: "Rule"
                       ) -> List[Finding]:
    """GLT018 over one CUDA source's text."""
    src = _strip_comments(text)
    line_starts = [0] + [i + 1 for i, c in enumerate(src) if c == "\n"]

    def where(pos: int) -> Tuple[int, int]:
        lo, hi = 0, len(line_starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if line_starts[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo + 1, pos - line_starts[lo] + 1

    def finding(line: int, col: int, message: str) -> Finding:
        return Finding(path=path, line=line, col=col, rule=rule.name,
                       code=rule.code, severity=rule.severity,
                       message=message)

    consts = _int_consts(src)
    ring = next((v for k, v in consts.items() if _RING_NAME.search(k)),
                None)
    findings: List[Finding] = []
    for kernel, start, end in _kernels(src):
        body = src[start:end]
        for family, commits, waits in _RING_FAMILIES:
            events: List[_RingEvent] = []
            for kind, pats in (("commit", commits), ("wait", waits)):
                for pat in pats:
                    for m in re.finditer(pat, body):
                        pos = start + m.start()
                        events.append(_RingEvent(
                            kind, *where(pos), _guards(src, start, pos)))
            events.sort(key=lambda e: (e.line, e.col))
            com = [e for e in events if e.kind == "commit"]
            wai = [e for e in events if e.kind == "wait"]
            if com and not wai:
                findings.append(finding(
                    com[0].line, com[0].col,
                    f"{family} copies committed in '{kernel}' are never "
                    f"awaited — the copies dangle past the kernel's end "
                    f"and their slots are reused while in flight"))
                continue
            if wai and not com:
                findings.append(finding(
                    wai[0].line, wai[0].col,
                    f"'{kernel}' waits on {family} copies it never "
                    f"commits — the wait blocks forever on a "
                    f"never-signaled barrier"))
                continue
            g_c = set().union(*(e.guards for e in com)) if com else set()
            g_w = set().union(*(e.guards for e in wai)) if wai else set()
            for g in sorted(g_c - g_w):
                e = next(e for e in com if g in e.guards)
                findings.append(finding(
                    e.line, e.col,
                    f"{family} ring in '{kernel}': data-dependent "
                    f"predicate '{g}' guards the commit but no wait "
                    f"shares it — a row skipped at the commit leaves its "
                    f"unconditional wait on a never-signaled barrier; "
                    f"guard commit and wait with the same row predicate"))
            for g in sorted(g_w - g_c):
                e = next(e for e in wai if g in e.guards)
                findings.append(finding(
                    e.line, e.col,
                    f"{family} ring in '{kernel}': data-dependent "
                    f"predicate '{g}' guards the wait but no commit "
                    f"shares it — rows skipped at the wait leave their "
                    f"committed copies dangling on the ring slot; guard "
                    f"commit and wait with the same row predicate"))
        if ring is None:
            continue
        for pat in _DEPTH_WAITS:
            for m in re.finditer(pat, body):
                n = _const_expr(m.group(1), consts)
                if n is not None and n >= ring:
                    line, col = where(start + m.start())
                    findings.append(finding(
                        line, col,
                        f"'{kernel}' waits with {n} copy groups still in "
                        f"flight, but its ring has {ring} slots — the "
                        f"next copy refills a slot whose copy has not "
                        f"landed; wait with at most {ring - 1} pending"))
    return findings


def _module_sources(module: ModuleInfo, project) -> List[str]:
    """Paths of the CUDA sources a module builds (its ``SOURCES``)."""
    node = _module_consts(module).get(_SOURCES_NAME)
    names = const_value(module, node, project) if node is not None else None
    if not (isinstance(names, tuple)
            and all(isinstance(n, str) for n in names)):
        return []
    here = os.path.dirname(module.path)
    out = []
    for name in names:
        if not name.endswith(CUDA_SUFFIXES):
            continue
        for d in (os.path.join(os.path.dirname(here), "csrc"), here):
            cand = os.path.join(d, name)
            if os.path.isfile(cand):
                out.append(cand)
                break
    return out


@register
class UnbalancedDmaRing(Rule):
    """Asynchronous-copy commits and waits must balance in each kernel."""
    name = "unbalanced-dma-ring"
    code = "GLT018"
    severity = Severity.ERROR
    description = ("an asynchronous-copy commit (cp.async, "
                   "cuda::pipeline, mbarrier) in a __global__ function "
                   "without its wait under the same data-dependent guard, "
                   "or a wait deeper than the ring: dangling copies or "
                   "waits on never-signaled barriers")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        for path in _module_sources(module, project):
            with open(path, encoding="utf-8") as fh:
                findings.extend(cuda_ring_findings(fh.read(), path, self))
        return findings


def cuda_findings(text: str, path: str,
                  rules: Sequence[Rule]) -> List[Finding]:
    """The findings of the rules that read CUDA text (GLT018) over one
    source."""
    return [f for r in rules if isinstance(r, UnbalancedDmaRing)
            for f in cuda_ring_findings(text, path, r)]


@register
class UnalignedTileShape(Rule):
    """Threads, vector widths and lane groups must tile the warp."""
    name = "unaligned-tile-shape"
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
