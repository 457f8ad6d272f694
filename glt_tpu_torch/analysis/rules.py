"""gltlint rules for the port: the CUDA-graph, key, id, dtype,
thread, lock, wire and storage hazards (cf.
``glt_tpu/analysis/rules.py``).

Each rule is a class with a ``check(module, project=None) -> [Finding]``
method, registered in ``RULES`` by name.  Severities: ERROR findings gate
(non-zero exit), WARNINGs report but pass.  ``project`` — the
project-wide symbol table / call graph / effect summaries
(analysis/symbols.py) — is provided whenever the CLI analyzes a file
set; rules use it to follow effects through calls (GLT001/GLT002
transitive, GLT013/GLT014 one call deep; GLT008/GLT009 —
analysis/concurrency.py — are built on it).  Without a project a rule
degrades to its intraprocedural behavior.

Every code, name and severity is ``glt_tpu``'s.  The framework-free
rules keep its descriptions and messages, so the same source gives the
same findings in both linters; the rules that name JAX there (GLT001-004,
006, 010, 013, 016, 022) check the same hazard in its torch form — a
CUDA graph capture for a jitted trace, the port's threefry keys, torch
casts — and their descriptions and messages say so.  The analyses are
deliberately linear/flow-light: statements are walked in source order,
``if`` branches fork analysis state, loops are traversed once, and
unresolvable calls contribute no effects rather than worst-case guesses.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .effects import (
    ALWAYS_SYNC,
    COERCIONS,
    DISK_CALLS,
    DISK_READ_METHODS,
    HOST_SYNC_CALLS,
    MMAP_CALLS,
    SYNC_METHODS,
    is_key_call,
)
from .effects import KEY_SOURCES, NON_CONSUMING
from .report import Finding, Severity
from .symbols import FunctionSymbol
from .visitor import (
    FunctionScope,
    GraphRegion,
    ModuleInfo,
    assign_targets,
    dotted_expr,
    host_names,
    is_capture_name,
    names_loaded,
    param_names,
    traced_names,
    unwrap_capture_target,
    walk_own,
)

RULES: Dict[str, type] = {}


def register(cls):
    RULES[cls.name] = cls
    return cls


class Rule:
    """Base rule; subclasses set name/code/severity/description."""
    name: str = ""
    code: str = ""
    severity: Severity = Severity.ERROR
    description: str = ""

    def finding(self, module: ModuleInfo, node: ast.AST, message: str
                ) -> Finding:
        return Finding(path=module.path, line=node.lineno,
                       col=node.col_offset + 1, rule=self.name,
                       code=self.code, severity=self.severity,
                       message=message)

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        raise NotImplementedError


# Shared AST helpers live in visitor.py; local aliases keep this module's
# rule bodies terse.
_walk_own = walk_own
_dotted = dotted_expr
_traced_names = traced_names


def _expr_names(node: ast.AST) -> Set[str]:
    """Names + self-attribute dotted strings read inside ``node``."""
    out = names_loaded(node)
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute):
            d = _dotted(n)
            if d is not None:
                out.add(d)
    return out


def _is_epoch_driver(name: str) -> bool:
    """The epoch-driver naming convention: ``run_*epoch*`` /
    ``_run_*epoch*`` (``run_scanned_epoch``, ``run_scanned_dist_epoch``,
    ``_ColdStagePipeline.run_epoch``)."""
    return "epoch" in name and name.startswith(("run_", "_run_"))


# ---------------------------------------------------------------------------
# GLT001 host-sync-in-jit
# ---------------------------------------------------------------------------

def compute_jit_taint(module: ModuleInfo
                      ) -> Dict[FunctionScope, Set[str]]:
    """Device-value sets for every captured scope in the module.

    A captured function's parameters are the static input buffers, so
    they seed the taint; a transitively captured helper's parameters are
    tainted only where its call site passes tainted values (sizing
    helpers called with Python config stay clean).  Fixpoint so helpers
    see their caller's taint.
    """
    taint_by_scope: Dict[FunctionScope, Set[str]] = {}
    for _ in range(4):
        changed = False
        for scope in module.scopes:   # DFS order: parents first
            if not module.in_jit_context(scope):
                continue
            taint = _seed_taint(scope, taint_by_scope)
            if scope.parent in taint_by_scope:
                taint |= taint_by_scope[scope.parent]
            _propagate(scope.node, taint)
            if taint_by_scope.get(scope) != taint:
                taint_by_scope[scope] = taint
                changed = True
        if not changed:
            break
    return taint_by_scope


def _propagate(root: ast.AST, taint: Set[str]) -> None:
    """Two linear passes carry taint through assignments and loops."""
    for _ in range(2):
        for node in _walk_own(root):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if node.value is not None and (_traced_names(node.value)
                                               & taint):
                    taint |= set(assign_targets(node))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if _traced_names(node.iter) & taint:
                    taint |= names_stored(node.target)


def names_stored(target: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}


def _seed_taint(scope: FunctionScope,
                taint_by_scope: Dict[FunctionScope, Set[str]]) -> Set[str]:
    """Initial device-value set: every parameter of a capture root, only
    the device-valued-at-the-call-site parameters of a transitive one."""
    host = host_names(scope.node) | {"self", "cls"}
    if scope.transitive_call is None:
        # `self`/`cls` are bound when the capture is built, never a
        # device buffer -- counting them floods attribute reads.
        return set(scope.params) - host
    caller, call = scope.transitive_call
    caller_taint = taint_by_scope.get(caller)
    if caller_taint is None:          # a root in another module
        caller_taint = set(caller.params) - {"self", "cls"}
    params = scope.params
    # bound method call (self.f(...)): positional args bind past self
    if params[:1] == ["self"] and isinstance(call.func, ast.Attribute):
        pos = params[1:]
    else:
        pos = params
    seed: Set[str] = set()
    for i, arg in enumerate(call.args):
        if isinstance(arg, ast.Starred):
            if _traced_names(arg.value) & caller_taint:
                seed |= set(pos[i:])
            break
        if i < len(pos) and (_traced_names(arg) & caller_taint):
            seed.add(pos[i])
    for kw in call.keywords:
        if kw.arg in params and (_traced_names(kw.value) & caller_taint):
            seed.add(kw.arg)
    return seed - host


def _mentions_capture(module: ModuleInfo) -> bool:
    """A cheap pre-filter: can the module build a capture at all?"""
    return ("CapturedProgram" in module.source
            or "make_graphed_callables" in module.source)


def region_taint(module: ModuleInfo, region: GraphRegion) -> Set[str]:
    """Device values under ``with torch.cuda.graph(...)``: the enclosing
    function's parameters and what is computed from them."""
    if region.scope is None:
        return set()
    taint = set(region.scope.params) - {"self", "cls"}
    _propagate(region.scope.node, taint)
    return taint


def region_calls(region: GraphRegion) -> Iterator[ast.Call]:
    for stmt in region.node.body:
        for node in [stmt, *_walk_own(stmt)]:
            if isinstance(node, ast.Call):
                yield node


@register
class HostSyncInJit(Rule):
    """A host sync on a device value inside a CUDA graph capture.

    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``int()``/
    ``float()``/``bool()`` of a tensor, ``Tensor.nonzero``,
    ``torch.unique`` or ``torch.cuda.synchronize`` inside a captured
    body make the capture fail (``GraphCaptureError``,
    ``utils/graphs.py``); where the capture tolerates it, the replay
    does not run it, so the host never sees a new value.  Captured
    contexts: the function passed to ``CapturedProgram`` or
    ``torch.cuda.make_graphed_callables``, the block under
    ``with torch.cuda.graph(...)``, and what they call.

    With a project, the check is transitive across modules: a call from
    a captured context that passes a device value into another module's
    function whose effect summary says that parameter reaches a host
    sync (directly or through further calls) is flagged at the call
    site, with the chain in the message.
    """
    name = "host-sync-in-jit"
    code = "GLT001"
    severity = Severity.ERROR
    description = ("a host sync (.item()/.cpu()/.tolist()/.numpy(), "
                   "int()/float()/bool(), torch.cuda.synchronize) on a "
                   "device value inside a CUDA graph capture (transitive "
                   "through project calls)")

    HOST_CALLS = HOST_SYNC_CALLS
    COERCIONS = COERCIONS
    SYNC_METHODS = SYNC_METHODS

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        taint_by_scope = compute_jit_taint(module)
        for scope in module.scopes:
            if not module.in_jit_context(scope):
                continue
            taint = taint_by_scope.get(scope, set())
            where = (f"in captured context '{scope.name}' "
                     f"({scope.jit_reason})" if scope.jit_reason
                     else f"in captured context '{scope.name}'")
            for node in _walk_own(scope.node):
                if not isinstance(node, ast.Call):
                    continue
                findings.extend(self._check_call(module, node, taint,
                                                 where))
                if project is not None and taint:
                    findings.extend(self._check_cross_module(
                        module, scope, node, taint, project, scope.name))
        for region in module.graph_regions:
            taint = region_taint(module, region)
            where = (f"under torch.cuda.graph (line "
                     f"{region.node.lineno})")
            for node in region_calls(region):
                findings.extend(self._check_call(module, node, taint,
                                                 where))
                if project is not None and taint:
                    findings.extend(self._check_cross_module(
                        module, region.scope, node, taint, project,
                        "torch.cuda.graph", same_module=True))
        return findings

    def _check_cross_module(self, module: ModuleInfo,
                            scope: Optional[FunctionScope],
                            call: ast.Call, taint: Set[str], project,
                            where: str, same_module: bool = False
                            ) -> List[Finding]:
        """Follow the call into another module's effect summary."""
        sym = project.resolve_call(module, scope, call)
        if not isinstance(sym, FunctionSymbol):
            return []
        if sym.module is module and not same_module:
            return []          # same-module helpers: the pass above
        if sym.module.in_jit_context(sym.scope):
            return []          # callee's own module pass reports inside
        summary = project.effects.summary_for(sym)
        sync = summary.sync_param_map()
        if not sync:
            return []
        params = sym.scope.params
        if params[:1] == ["self"] and isinstance(call.func, ast.Attribute):
            pos = params[1:]
        else:
            pos = params
        hits = []
        for i, arg in enumerate(call.args):
            if i < len(pos) and pos[i] in sync \
                    and (_traced_names(arg) & taint):
                hits.append((pos[i], arg))
        for kw in call.keywords:
            if kw.arg in sync and (_traced_names(kw.value) & taint):
                hits.append((kw.arg, kw.value))
        out = []
        for p, arg in hits[:1]:     # one finding per call site
            site = sync[p]
            var = sorted(_traced_names(arg) & taint)[0]
            out.append(self.finding(
                module, call,
                f"device value '{var}' flows into '{sym.short}' whose "
                f"parameter '{p}' reaches {site.detail} "
                f"({sym.module.path}:{site.line}) — host sync inside "
                f"captured context '{where}'; keep the helper on the "
                f"device or hoist the call out of the capture"))
        return out

    def _check_call(self, module: ModuleInfo, call: ast.Call,
                    taint: Set[str], where: str) -> List[Finding]:
        name = module.call_name(call)
        args = list(call.args) + [kw.value for kw in call.keywords]
        touched = set().union(*[_traced_names(a) for a in args]) \
            if args else set()
        if name in ALWAYS_SYNC:
            return [self.finding(
                module, call,
                f"{name}() {where}: waits for the device, which a "
                f"capture cannot record (the capture fails); synchronize "
                f"after the replay instead")]
        if name in self.HOST_CALLS and (touched & taint):
            var = sorted(touched & taint)[0]
            return [self.finding(
                module, call,
                f"{name}() on device value '{var}' {where}: its output "
                f"size is read back to the host, a sync the capture "
                f"cannot record; keep a static-size form on the device")]
        if name in self.COERCIONS and (touched & taint):
            var = sorted(touched & taint)[0]
            return [self.finding(
                module, call,
                f"{name}() on device value '{var}' {where}: reads the "
                f"tensor back to the host (the capture fails, and a "
                f"replay would not run it); keep it a tensor or hoist "
                f"the read out of the capture")]
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in self.SYNC_METHODS
                and (_traced_names(call.func.value) & taint)):
            var = sorted(_traced_names(call.func.value) & taint)[0]
            return [self.finding(
                module, call,
                f".{call.func.attr}() on device value '{var}' {where}: "
                f"host sync point inside the captured program")]
        return []


# ---------------------------------------------------------------------------
# GLT002 prng-key-reuse
# ---------------------------------------------------------------------------

def _looks_like_key_param(name: str) -> bool:
    low = name.lower()
    return (low in ("key", "rng", "prngkey", "prng_key", "base_key")
            or low.endswith("_key") or low.endswith("_rng")
            or low.endswith("_keys"))


@register
class PrngKeyReuse(Rule):
    """The same threefry key consumed by two sampling calls.

    The port's ``random`` is counter-based, as ``jax.random`` is: one
    key passed to two draws (``random.randint``/``uniform``/``bits``, a
    ``key`` argument of ``ops.sample_neighbors`` or a sampler) yields
    *identical* randomness, which on the sampler path silently
    correlates hops and batches.  A key may be consumed once; reuse
    requires an intervening ``random.split``/``fold_in``.

    With a project, call sites resolving to project functions consult the
    callee's effect summary: only arguments bound to parameters the
    callee actually consumes as keys (directly or transitively) count as
    consumption — a helper that merely ``split``s its key argument is as
    safe as ``random.split`` itself.  Unresolvable calls keep the
    conservative behavior (any call consumes).
    """
    name = "prng-key-reuse"
    code = "GLT002"
    severity = Severity.ERROR
    description = ("a threefry key passed to two consuming calls (callee "
                   "effect summaries decide consumption) without an "
                   "intervening random.split/fold_in")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        self._project = project
        for scope in module.scopes:
            if isinstance(scope.node, ast.Lambda):
                continue
            self._scope = scope
            state: Dict[str, int] = {
                p: 0 for p in scope.params if _looks_like_key_param(p)}
            self._run(module, scope.node.body, state, findings)
        return findings

    # -- branch-aware linear interpreter ----------------------------------
    def _run(self, module: ModuleInfo, body: Sequence[ast.stmt],
             state: Dict[str, int], findings: List[Finding]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                s1, s2 = dict(state), dict(state)
                self._run(module, stmt.body, s1, findings)
                self._run(module, stmt.orelse, s2, findings)
                # conservative merge: a use must happen on *every* path to
                # count against later statements
                state.clear()
                for var in set(s1) & set(s2):
                    state[var] = min(s1[var], s2[var])
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._visit_exprs(module, stmt, state, findings,
                                  skip_body=True)
                self._run(module, stmt.body, state, findings)
                self._run(module, stmt.orelse, state, findings)
                continue
            if isinstance(stmt, ast.Try):
                self._run(module, stmt.body, state, findings)
                for h in stmt.handlers:
                    self._run(module, h.body, dict(state), findings)
                self._run(module, stmt.orelse, state, findings)
                self._run(module, stmt.finalbody, state, findings)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._visit_exprs(module, stmt, state, findings,
                                  skip_body=True)
                self._run(module, stmt.body, state, findings)
                continue
            self._visit_exprs(module, stmt, state, findings)
            if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._apply_assign(module, stmt, state)

    def _consuming_arg_ids(self, module: ModuleInfo,
                           node: ast.Call) -> Optional[Set[int]]:
        """With a resolved callee summary: the ``id()``s of the argument
        nodes bound to key-consuming parameters.  None means every
        argument consumes: the call is unresolvable, or a draw of the
        port's ``random`` (its threefry runs in a kernel, no summary
        sees it)."""
        if self._project is None or is_key_call(module.call_name(node)):
            return None
        sym = self._project.resolve_call(module, self._scope, node)
        if not isinstance(sym, FunctionSymbol):
            return None
        summary = self._project.effects.summary_for(sym)
        params = sym.scope.params
        if params[:1] == ["self"] and isinstance(node.func, ast.Attribute):
            pos = params[1:]
        else:
            pos = params
        consuming: Set[int] = set()
        for i, arg in enumerate(node.args):
            if i < len(pos) and pos[i] in summary.key_params:
                consuming.add(id(arg))
        for kw in node.keywords:
            if kw.arg in summary.key_params:
                consuming.add(id(kw.value))
        return consuming

    def _visit_exprs(self, module: ModuleInfo, stmt: ast.stmt,
                     state: Dict[str, int], findings: List[Finding],
                     skip_body: bool = False) -> None:
        nodes: List[ast.AST]
        if skip_body:
            nodes = []
            for field in ("test", "iter", "items", "target"):
                sub = getattr(stmt, field, None)
                if sub is not None:
                    for s in (sub if isinstance(sub, list) else [sub]):
                        nodes.extend(ast.walk(getattr(s, "context_expr",
                                                      s)))
        else:
            nodes = list(_walk_own(stmt))
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if module.call_name(node) in NON_CONSUMING:
                continue
            consuming = self._consuming_arg_ids(module, node)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in state:
                    if consuming is not None and id(arg) not in consuming:
                        continue     # callee provably derives, not draws
                    state[arg.id] += 1
                    if state[arg.id] == 2:
                        findings.append(self.finding(
                            module, node,
                            f"PRNG key '{arg.id}' consumed a second time "
                            f"(same randomness as its first use); derive a "
                            f"fresh key with random.split/fold_in before "
                            f"this call"))

    def _apply_assign(self, module: ModuleInfo, stmt: ast.stmt,
                      state: Dict[str, int]) -> None:
        targets = assign_targets(stmt)
        value = getattr(stmt, "value", None)
        is_key_src = (isinstance(value, ast.Call)
                      and module.call_name(value) in KEY_SOURCES)
        for t in targets:
            if is_key_src:
                state[t] = 0            # fresh key: uses reset
            elif t in state:
                del state[t]            # overwritten with a non-key value


# ---------------------------------------------------------------------------
# GLT003 recompile-hazard
# ---------------------------------------------------------------------------

@register
class RecompileHazard(Rule):
    """Python scalars closed over by a captured function.

    ``CapturedProgram(lambda x: x * n, ...)`` records ``n``'s value at
    the capture into the graph: a replay runs no Python, so after ``n``
    changes every replay silently computes with the old value (where
    ``jax.jit`` would retrace).  Copy the scalar into a static input
    buffer (``buf.fill_(n)``) that the body reads, or key the capture
    by the value (one program per value, as ``_programs[bucket]``).
    """
    name = "recompile-hazard"
    code = "GLT003"
    severity = Severity.WARNING
    description = ("a Python scalar closed over by a captured function "
                   "(a replay keeps the captured value) without a "
                   "capture keyed by it")

    _SCALAR_CALLS = {"int", "float", "len", "round", "min", "max"}

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        if not _mentions_capture(module):
            return findings
        for scope in module.scopes:
            if isinstance(scope.node, ast.Lambda):
                continue
            scalars = self._scalar_locals(module, scope)
            if not scalars:
                continue
            for node in _walk_own(scope.node):
                if not isinstance(node, ast.Call):
                    continue
                if not is_capture_name(module.call_name(node)):
                    continue
                findings.extend(
                    self._check_capture(module, scope, node, scalars))
        return findings

    def _scalar_locals(self, module: ModuleInfo, scope: FunctionScope
                       ) -> Set[str]:
        """Locals assigned from obviously-Python-scalar expressions."""
        scalars: Set[str] = set()
        for node in _walk_own(scope.node):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            if node.value is not None and self._is_scalarish(module,
                                                             node.value):
                scalars |= set(assign_targets(node))
        return scalars

    def _is_scalarish(self, module: ModuleInfo, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Constant):
            return isinstance(expr.value, (int, float)) and not isinstance(
                expr.value, bool)
        if isinstance(expr, ast.Call):
            return module.call_name(expr) in self._SCALAR_CALLS
        if isinstance(expr, ast.Attribute):
            return expr.attr in ("shape", "ndim")
        if isinstance(expr, ast.Subscript):
            return (isinstance(expr.value, ast.Attribute)
                    and expr.value.attr == "shape")
        if isinstance(expr, ast.BinOp):
            return (self._is_scalarish(module, expr.left)
                    or self._is_scalarish(module, expr.right))
        return False

    @staticmethod
    def _keyed(scope: FunctionScope, name: str) -> bool:
        """Is a capture looked up or stored by this value in the scope
        (``progs[n]``, ``progs.get(n)``): one program per value."""
        for node in _walk_own(scope.node):
            if (isinstance(node, ast.Subscript)
                    and name in names_loaded(node.slice)):
                return True
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("get", "setdefault", "pop")
                    and node.args and name in names_loaded(node.args[0])):
                return True
        return False

    def _check_capture(self, module: ModuleInfo, scope: FunctionScope,
                       call: ast.Call, scalars: Set[str]) -> List[Finding]:
        target = unwrap_capture_target(call, module.imports)
        fn_node = None
        if isinstance(target, ast.Lambda):
            fn_node = target
        elif isinstance(target, ast.Name):
            for child in module.scopes:
                if (child.parent is scope and child.name == target.id
                        and not isinstance(child.node, ast.Lambda)):
                    fn_node = child.node
                    break
        if fn_node is None:
            return []
        body = (fn_node.body if isinstance(fn_node, ast.Lambda)
                else fn_node)
        free = names_loaded(body) - set(param_names(fn_node))
        if not isinstance(fn_node, ast.Lambda):
            for node in _walk_own(fn_node):
                if isinstance(node, (ast.Assign, ast.AnnAssign,
                                     ast.AugAssign)):
                    free -= set(assign_targets(node))
        captured = sorted(c for c in free & scalars
                          if not self._keyed(scope, c))
        if not captured:
            return []
        return [self.finding(
            module, call,
            f"captured function closes over Python scalar(s) "
            f"{', '.join(repr(c) for c in captured)}: the graph records "
            f"the value at the capture, and every replay keeps it after "
            f"the scalar changes; copy it into a static input buffer, or "
            f"key the capture by the value")]


# ---------------------------------------------------------------------------
# GLT004 int64-id-truncation
# ---------------------------------------------------------------------------

_I64 = {"numpy.int64", "numpy.uint64", "torch.int64", "torch.long"}
_I64_STRINGS = {"int64", "uint64"}
_I32 = {"numpy.int32", "torch.int32", "torch.int"}
_I32_STRINGS = {"int32"}
_I32_BOUNDS = {2**31 - 1, 2**31}


def _const_int(node: ast.AST) -> Optional[int]:
    """The value of integer literal arithmetic (``2**31 - 1``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return None if v is None else -v
    if isinstance(node, ast.BinOp):
        a, b = _const_int(node.left), _const_int(node.right)
        if a is None or b is None:
            return None
        if isinstance(node.op, ast.Pow) and 0 <= b <= 64:
            return a ** b
        ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
        return ops.get(type(node.op))
    return None


@register
class Int64IdTruncation(Rule):
    """int64 ids narrowed to int32 without a range check.

    The port keeps ids int32 (``ROADMAP``: "Ids stay int32"), as
    ``glt_tpu`` does under x64-disabled JAX.  Narrowing an int64 id
    array — ``.to(torch.int32)``, ``.int()``, ``.astype(np.int32)``,
    ``torch.as_tensor(ids, dtype=torch.int32)`` — wraps every id past
    ``2**31 - 1`` negative, and a negative id is padding: the node's
    rows silently vanish (papers100M edge ids already qualify).  A
    function that narrows ids checks their range first (compares with
    ``2**31 - 1``, ``np.iinfo(np.int32).max`` or a named ``*I32_MAX``
    bound, or calls a ``require_int32_*`` helper).
    """
    name = "int64-id-truncation"
    code = "GLT004"
    severity = Severity.ERROR
    description = ("int64 ids (np.int64 / torch.long) narrowed to int32 "
                   "(.to(torch.int32), .int(), .astype(np.int32), "
                   "as_tensor(..., dtype=torch.int32)) with no range "
                   "check against 2**31 - 1 in the function")

    _PRESERVING = ("reshape", "ravel", "copy", "flatten", "squeeze",
                   "transpose", "take", "clip", "to", "cuda", "cpu",
                   "contiguous", "view", "clone", "detach", "numpy",
                   "unsqueeze", "expand", "pin_memory")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        sinks = [(n, got) for n in module._calls
                 for got in [self._narrowing(module, n)] if got]
        if not sinks:
            return findings
        module_taint = self._collect_taint(module, module.tree, set())
        seen: Dict[ast.AST, Optional[Set[str]]] = {}
        for call, (arg, how) in sorted(
                sinks, key=lambda s: (s[0].lineno, s[0].col_offset)):
            scope = module._enclosing_scope(call)
            root = scope.node if scope is not None else module.tree
            if root not in seen:      # None: the function checks the range
                seen[root] = (None if self._has_range_check(module, root)
                              else self._collect_taint(
                                  module, root, set(module_taint)))
            taint = seen[root]
            if taint is None:
                continue
            hit = self._is_int64_expr(module, arg)
            tainted = (sorted(_expr_names(arg) & taint)
                       if self._propagates(module, arg, taint) else [])
            if hit or tainted:
                what = (f"'{tainted[0]}'" if tainted
                        else "an int64 expression")
                findings.append(self.finding(
                    module, call,
                    f"int64 ids ({what}) narrowed to int32 by {how} with "
                    f"no range check against 2**31 - 1 in this function: "
                    f"ids past int32 wrap negative and read as padding; "
                    f"check the range first (or relabel into int32 "
                    f"range)"))
        return findings

    # -- where int64 comes from and how it flows ---------------------------
    def _collect_taint(self, module: ModuleInfo, root: ast.AST,
                       seed: Set[str]) -> Set[str]:
        taint = set(seed)
        for _ in range(2):
            for node in _walk_own(root):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                if node.value is None:
                    continue
                if (self._is_int64_expr(module, node.value)
                        or self._propagates(module, node.value, taint)):
                    taint |= set(assign_targets(node))
                    tgts = (node.targets if isinstance(node, ast.Assign)
                            else [node.target])
                    for t in tgts:
                        d = _dotted(t)
                        if d is not None and "." in d:
                            taint.add(d)
        return taint

    def _is_dtype(self, module: ModuleInfo, expr: ast.expr,
                  names: Set[str], strings: Set[str]) -> bool:
        return (module.imports.resolve(expr) in names
                or (isinstance(expr, ast.Constant)
                    and expr.value in strings))

    def _dtype_args(self, call: ast.Call) -> List[ast.expr]:
        return list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "dtype"]

    def _is_int64_expr(self, module: ModuleInfo, expr: ast.expr) -> bool:
        """Does the expression *introduce* int64-ness?"""
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute) \
                    and module.imports.resolve(node) in _I64:
                return True
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "long" and not node.args):
                    return True
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("astype", "to", "type")
                        and any(self._is_dtype(module, a, _I64,
                                               _I64_STRINGS)
                                for a in self._dtype_args(node))):
                    return True
                for kw in node.keywords:
                    if kw.arg == "dtype" and self._is_dtype(
                            module, kw.value, _I64, _I64_STRINGS):
                        return True
        return False

    def _narrowing(self, module: ModuleInfo, call: ast.Call
                   ) -> Optional[Tuple[ast.expr, str]]:
        """(the narrowed operand, how) when ``call`` narrows to int32."""
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr == "int" and not call.args and not call.keywords:
                return func.value, ".int()"
            if func.attr in ("to", "type", "astype") and any(
                    self._is_dtype(module, a, _I32, _I32_STRINGS)
                    for a in self._dtype_args(call)):
                return func.value, f".{func.attr}(int32)"
        name = module.call_name(call) or ""
        if name.startswith(("torch.", "numpy.")) and call.args and any(
                self._is_dtype(module, a, _I32, _I32_STRINGS)
                for a in list(call.args[1:]) + [
                    kw.value for kw in call.keywords if kw.arg == "dtype"]):
            return call.args[0], f"{name}(..., int32)"
        return None

    def _propagates(self, module: ModuleInfo, expr: ast.expr,
                    taint: Set[str]) -> bool:
        """Does int64-ness flow from a tainted name into this value?

        Structural operations (copies, indexing, arithmetic, ``np.*`` and
        ``torch.*`` calls without a dtype, device moves and reshapes on
        tainted values) keep the dtype; results of arbitrary user
        functions do not inherit it, and a narrowing ends it.
        Comparisons/boolean ops yield bools, never ids.
        """
        if isinstance(expr, (ast.Name, ast.Attribute)):
            d = _dotted(expr)
            return d in taint if d is not None else False
        if isinstance(expr, ast.Subscript):
            return self._propagates(module, expr.value, taint)
        if isinstance(expr, ast.BinOp):
            return (self._propagates(module, expr.left, taint)
                    or self._propagates(module, expr.right, taint))
        if isinstance(expr, ast.UnaryOp):
            return self._propagates(module, expr.operand, taint)
        if isinstance(expr, ast.IfExp):
            return (self._propagates(module, expr.body, taint)
                    or self._propagates(module, expr.orelse, taint))
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._propagates(module, el, taint)
                       for el in expr.elts)
        if isinstance(expr, ast.Starred):
            return self._propagates(module, expr.value, taint)
        if isinstance(expr, ast.Call):
            if self._narrowing(module, expr) is not None or any(
                    kw.arg == "dtype" for kw in expr.keywords):
                return False
            name = module.call_name(expr) or ""
            args = list(expr.args) + [kw.value for kw in expr.keywords]
            if name.startswith(("numpy.", "torch.")) and not name.startswith(
                    ("numpy.random.", "torch.random.")):
                return any(self._propagates(module, a, taint)
                           for a in args)
            if (isinstance(expr.func, ast.Attribute)
                    and expr.func.attr in self._PRESERVING):
                return self._propagates(module, expr.func.value, taint)
        return False

    # -- the range check ------------------------------------------------------
    def _is_bound(self, module: ModuleInfo, expr: ast.AST) -> bool:
        for node in ast.walk(expr):
            if isinstance(node, ast.Constant) and node.value in _I32_BOUNDS:
                return True
            if isinstance(node, ast.BinOp) \
                    and _const_int(node) in _I32_BOUNDS:
                return True
            if isinstance(node, (ast.Name, ast.Attribute)):
                last = (node.id if isinstance(node, ast.Name)
                        else node.attr).upper()
                if "I32_MAX" in last or "INT32_MAX" in last \
                        or "I32_MIN" in last or "INT32_MIN" in last:
                    return True
            if (isinstance(node, ast.Attribute)
                    and node.attr in ("max", "min")
                    and isinstance(node.value, ast.Call)
                    and (module.call_name(node.value) or "").endswith(
                        ".iinfo")):
                return True
        return False

    def _has_range_check(self, module: ModuleInfo, root: ast.AST) -> bool:
        for node in _walk_own(root):
            if isinstance(node, ast.Compare) and self._is_bound(module,
                                                                node):
                return True
            if isinstance(node, ast.Call):
                last = (module.call_name(node) or "").rsplit(".", 1)[-1]
                if "int32" in last and last.startswith(("require",
                                                        "check")):
                    return True
        return False


# ---------------------------------------------------------------------------
# GLT005 nondeterministic-default-rng
# ---------------------------------------------------------------------------

@register
class NondeterministicDefaultRng(Rule):
    """Unseeded ``np.random.default_rng()`` in library code.

    OS-entropy seeding makes sampling unreproducible across runs and
    *divergent across processes*: "identical" ranks of a multi-process
    run sample different subgraphs and their exchanges drift.  Always
    seed from configuration (and fold in the epoch/rank index).
    """
    name = "nondeterministic-default-rng"
    code = "GLT005"
    severity = Severity.WARNING
    description = "np.random.default_rng() with no seed argument"

    _RNG = {"numpy.random.default_rng", "numpy.random.Generator",
            "numpy.random.RandomState"}

    def check(self, module: ModuleInfo, project=None
              ) -> List[Finding]:
        findings: List[Finding] = []
        # fresh-generator-inline-draw: default_rng(seed).permutation(x)
        # where `seed` is a parameter of the enclosing function replays
        # the identical stream on every call — the repeated-permutation-
        # across-epochs bug class (a constant literal seed is a one-shot
        # deterministic fixture; a per-call-varying seed expression is a
        # deliberate stream; a bare parameter is the same value every
        # call of this function).
        for scope in module.scopes:
            params = set(scope.params)
            for node in _walk_own(scope.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Call)
                        and module.call_name(node.func.value) in self._RNG
                        and node.func.value.args):
                    continue
                seed_arg = node.func.value.args[0]
                if (isinstance(seed_arg, ast.Name)
                        and seed_arg.id in params):
                    findings.append(self.finding(
                        module, node,
                        f"fresh Generator from parameter "
                        f"'{seed_arg.id}' drawn inline "
                        f"(.{node.func.attr}()): every call of "
                        f"'{scope.name}' replays the identical stream — "
                        f"across epochs that repeats the exact "
                        f"permutation; thread a stateful Generator "
                        f"through instead"))
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = module.call_name(node)
            if name not in self._RNG:
                continue
            unseeded = not node.args and not node.keywords
            if not unseeded and node.args:
                a = node.args[0]
                unseeded = isinstance(a, ast.Constant) and a.value is None
            if unseeded:
                findings.append(self.finding(
                    module, node,
                    f"{name}() without a seed: draws from OS entropy — "
                    f"unreproducible, and divergent across pod hosts; "
                    f"thread a seeded Generator through instead"))
        return findings


# ---------------------------------------------------------------------------
# GLT006 shadowed-jit-donation
# ---------------------------------------------------------------------------

@register
class ShadowedJitDonation(Rule):
    """A captured program's output read after a later call rewrote it.

    ``CapturedProgram`` hands back the same static output tensors on
    every call: each replay rewrites them in place (``utils/graphs.py``),
    as ``donate_argnums`` hands a buffer to XLA.  An output held across
    a later call or ``replay()`` of the same program silently holds the
    later call's values — the first result is gone, with no error on any
    backend.  Likewise a tensor of ``prog.inputs`` (refilled by each
    call).  ``.clone()`` the output before calling the program again, or
    consume it first.
    """
    name = "shadowed-jit-donation"
    code = "GLT006"
    severity = Severity.ERROR
    description = ("a CapturedProgram output (or input buffer) read "
                   "after a later call or replay of the same program "
                   "rewrote it in place, with no .clone() in between")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if not _mentions_capture(module):
            return []
        programs = self._collect_programs(module)
        if not programs:
            return []
        findings: List[Finding] = []
        for scope in module.scopes:
            if isinstance(scope.node, ast.Lambda):
                continue
            self._run(module, scope.node.body, programs, {}, {}, findings)
        self._run(module, module.tree.body, programs, {}, {}, findings)
        return findings

    @staticmethod
    def _collect_programs(module: ModuleInfo) -> Set[str]:
        """Names (plain or ``self.x``) assigned a captured program."""
        out: Set[str] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = getattr(node, "value", None)
            if not (isinstance(value, ast.Call)
                    and is_capture_name(module.call_name(value))):
                continue
            tgts = (node.targets if isinstance(node, ast.Assign)
                    else [node.target])
            for t in tgts:
                d = _dotted(t)
                if d is not None:
                    out.add(d)
        return out

    @staticmethod
    def _program_of(node: ast.AST, programs: Set[str]) -> Optional[str]:
        """The program a call runs: ``prog(...)`` or ``prog.replay()``."""
        if not isinstance(node, ast.Call):
            return None
        d = _dotted(node.func)
        if d in programs:
            return d
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "replay":
            d = _dotted(node.func.value)
            if d in programs:
                return d
        return None

    def _held_from(self, value: Optional[ast.expr],
                   programs: Set[str]) -> Optional[str]:
        """The program whose storage an assigned value aliases: a call's
        result, or ``prog.inputs``/``prog.outputs`` (indexed or not)."""
        if value is None:
            return None
        got = self._program_of(value, programs)
        if got is not None:
            return got
        cur = value
        while isinstance(cur, ast.Subscript):
            cur = cur.value
        if isinstance(cur, ast.Attribute) and cur.attr in ("inputs",
                                                           "outputs"):
            d = _dotted(cur.value)
            if d in programs:
                return d
        return None

    def _run(self, module: ModuleInfo, body: Sequence[ast.stmt],
             programs: Set[str], live: Dict[str, Tuple[str, int]],
             stale: Dict[str, Tuple[int, str, int]],
             findings: List[Finding]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                l1, l2 = dict(live), dict(live)
                s1, s2 = dict(stale), dict(stale)
                self._run(module, stmt.body, programs, l1, s1, findings)
                self._run(module, stmt.orelse, programs, l2, s2, findings)
                live.clear()
                live.update(l1)
                live.update(l2)
                stale.clear()
                stale.update(s1)
                stale.update(s2)     # rewritten on either path counts
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While,
                                 ast.With, ast.AsyncWith, ast.Try)):
                for part in ("body", "orelse"):
                    for sub in (getattr(stmt, part, []) or []):
                        self._run(module, [sub], programs, live, stale,
                                  findings)
                for h in getattr(stmt, "handlers", ()) or ():
                    self._run(module, h.body, programs, dict(live),
                              dict(stale), findings)
                for sub in (getattr(stmt, "finalbody", []) or []):
                    self._run(module, [sub], programs, live, stale,
                              findings)
                continue
            # 1) reads of outputs a call after them rewrote
            for node in _walk_own(stmt):
                if (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)
                        and node.id in stale):
                    made, prog, again = stale.pop(node.id)
                    findings.append(self.finding(
                        module, node,
                        f"'{node.id}' holds the output of captured program "
                        f"'{prog}' (line {made}), rewritten in place by "
                        f"its call at line {again}: it now holds that "
                        f"call's values; .clone() the output before "
                        f"calling the program again"))
            # 2) this statement's calls rewrite every held output
            ran = {p for p in (self._program_of(n, programs)
                               for n in _walk_own(stmt)) if p}
            ran |= {p for p in [self._program_of(stmt, programs)] if p}
            targets = set(assign_targets(stmt)) if isinstance(
                stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)) else set()
            for name, (prog, made) in list(live.items()):
                if prog in ran and name not in targets:
                    del live[name]
                    stale[name] = (made, prog, stmt.lineno)
            # 3) assignments: a direct result is held, anything else frees
            for t in targets:
                live.pop(t, None)
                stale.pop(t, None)
            held = self._held_from(getattr(stmt, "value", None), programs)
            if held is not None:
                for t in targets:
                    live[t] = (held, stmt.lineno)


# ---------------------------------------------------------------------------
# GLT007 unbounded-blocking-get
# ---------------------------------------------------------------------------

@register
class UnboundedBlockingGet(Rule):
    """``queue.Queue.get()`` / ``Thread.join()`` that can block forever.

    The distributed hang class: a consumer blocked in a no-timeout
    ``.get()`` waits forever once its producer thread/process dies between
    its last put and the get — nothing will ever arrive, and nothing
    raises.  Same shape for a no-timeout ``.join()`` on a thread wedged on
    a bounded queue.  Library code must either bound the wait (``timeout=``)
    or recheck liveness while polling (``channel.base.bounded_get``); a
    wait proven bounded by construction takes a justified suppression.
    """
    name = "unbounded-blocking-get"
    code = "GLT007"
    severity = Severity.ERROR
    description = ("a blocking .get()/.join() call with no timeout and no "
                   "liveness recheck in the enclosing function")

    # Zero-argument spellings only: dict.get(key), "".join(parts),
    # thread.join(5) all carry arguments and are not the blocking form.
    _BLOCKING = {"get", "join"}
    # A scope that probes peer liveness is running the timeout-and-recheck
    # pattern; its waits are bounded by the recheck loop.
    _LIVENESS = {"is_alive", "is_set", "poll"}

    def check(self, module: ModuleInfo, project=None
              ) -> List[Finding]:
        findings: List[Finding] = []
        regions = [module.tree] + [
            s.node for s in module.scopes
            if not isinstance(s.node, ast.Lambda)]
        for node in regions:
            calls = [n for n in _walk_own(node)
                     if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute)]
            if any(c.func.attr in self._LIVENESS for c in calls):
                continue
            for call in calls:
                if (call.func.attr in self._BLOCKING
                        and not call.args and not call.keywords):
                    findings.append(self.finding(
                        module, call,
                        f".{call.func.attr}() with no timeout and no "
                        f"liveness check in scope: blocks forever if the "
                        f"producer/thread died — pass timeout= in a "
                        f"recheck loop (see channel.base.bounded_get), or "
                        f"suppress with a bounded-wait justification"))
        return findings


# ---------------------------------------------------------------------------
# GLT010 span-in-traced-code
# ---------------------------------------------------------------------------

@register
class SpanInTracedCode(Rule):
    """``glt_tpu_torch.obs`` span/metric host calls inside a capture.

    The obs library is host-side: a ``span()`` / ``Counter.inc()``
    inside a captured function runs ONCE, at the capture, and a replay
    runs no Python — the span measures the capture, the counter counts
    captures, and both stop moving as soon as the graph is replayed.
    Instrument around the ``replay()`` call (loaders, epoch drivers,
    dispatch wrappers) and fence device work with ``span.fence(out)``.

    Flagged spellings, inside any captured context (a capture root, what
    it calls, the block under ``torch.cuda.graph``):

      * any call resolving (through the import map) into
        ``glt_tpu_torch.obs`` — ``span(...)``, ``obs.span(...)``,
        ``metrics.counter(...)``;
      * ``.inc()/.observe()/.set()/.time()/.fence()`` on a name assigned
        from an obs factory in this module (module-level ``_M = ...`` or
        ``self._m = ...`` instruments) or chained directly off one
        (``metrics.counter("x").inc()``).

    Other receivers never match: the receiver must trace back to an obs
    import or an obs-built name.
    """
    name = "span-in-traced-code"
    code = "GLT010"
    severity = Severity.ERROR
    description = ("glt_tpu_torch.obs span/metric call inside a captured "
                   "function (it runs once, at the capture; a replay runs "
                   "no Python)")

    _OBS_PREFIX = "glt_tpu_torch.obs"
    _METHODS = {"inc", "observe", "set", "time", "fence"}

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        calls: List[ast.Call] = []
        for scope in module.scopes:
            if module.in_jit_context(scope):
                calls.extend(n for n in _walk_own(scope.node)
                             if isinstance(n, ast.Call))
        for region in module.graph_regions:
            calls.extend(region_calls(region))
        if not calls:
            return findings
        instruments = self._instrument_names(module)
        for node in calls:
            message = self._obs_call(module, node, instruments)
            if message:
                findings.append(self.finding(module, node, message))
        return findings

    def _is_obs_path(self, dotted: Optional[str]) -> bool:
        return bool(dotted) and (
            dotted == self._OBS_PREFIX
            or dotted.startswith(self._OBS_PREFIX + "."))

    def _instrument_names(self, module: ModuleInfo) -> Set[str]:
        """Names (plain or ``self.x`` dotted) assigned from an obs
        factory call anywhere in the module."""
        out: Set[str] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            value = node.value
            if not (isinstance(value, ast.Call)
                    and self._is_obs_path(module.call_name(value))):
                continue
            out |= set(assign_targets(node))
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                d = _dotted(t)
                if d:
                    out.add(d)
        return out

    def _obs_call(self, module: ModuleInfo, call: ast.Call,
                  instruments: Set[str]) -> Optional[str]:
        resolved = module.call_name(call)
        if self._is_obs_path(resolved):
            return (f"{resolved}() inside a captured function: the host "
                    f"call runs once, at the capture, and no replay runs "
                    f"it — instrument around the replay() call instead "
                    f"(span.fence(out) observes device time)")
        func = call.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in self._METHODS):
            return None
        receiver = _dotted(func.value)
        if receiver is not None and receiver in instruments:
            return (f".{func.attr}() on obs instrument {receiver!r} "
                    f"inside a captured function: it moves once, at the "
                    f"capture — move it around the replay")
        inner = func.value
        while isinstance(inner, ast.Attribute):
            inner = inner.value
        if (isinstance(inner, ast.Call)
                and self._is_obs_path(module.call_name(inner))):
            return (f".{func.attr}() chained off an obs factory inside a "
                    f"captured function: it moves once, at the capture — "
                    f"move it around the replay")
        return None


# ---------------------------------------------------------------------------
# GLT011 non-atomic-state-publish
# ---------------------------------------------------------------------------

@register
class NonAtomicStatePublish(Rule):
    """``open(path, "w")`` publishing state without tmp + ``os.replace``.

    The durable-state discipline (glt_tpu_torch.ckpt.store,
    channel/native.py):
    anything another process may read — checkpoints, manifests, trace
    exports, bench/report artifacts — is written fully under a private
    tmp name and published with ONE atomic rename.  A direct write to
    the final path is a torn-read window: a reader (or a crash) midway
    through the write observes a half-written file that parses as
    garbage or, worse, parses cleanly as truncated state.

    Flagged: ``open()`` in write/create mode (``w``/``x``/``a`` modes)
    on a path that is not visibly a tmp name (no ``tmp``/``temp`` in the
    path expression), in an enclosing function that never publishes via
    ``os.replace``/``os.rename``/``shutil.move``.  A function that does
    rename-publish is trusted for all its writes (the tmp file it writes
    may be named by any expression); genuinely process-private files
    take a tmp-ish name or a justified suppression.
    """
    name = "non-atomic-state-publish"
    code = "GLT011"
    severity = Severity.ERROR
    description = ("direct open(path, 'w') write without the tmp + "
                   "os.replace atomic-publish discipline")

    _PUBLISH = {"os.replace", "os.rename", "shutil.move"}
    _WRITE_MODES = ("w", "x", "a")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        regions = [module.tree] + [
            s.node for s in module.scopes
            if not isinstance(s.node, ast.Lambda)]
        for region in regions:
            calls = [n for n in _walk_own(region)
                     if isinstance(n, ast.Call)]
            if any((module.call_name(c) or _dotted(c.func))
                   in self._PUBLISH for c in calls):
                continue
            for call in calls:
                mode = self._write_mode(call)
                if mode is None:
                    continue
                path_src = ast.unparse(call.args[0]) if call.args else ""
                low = path_src.lower()
                if "tmp" in low or "temp" in low:
                    continue
                findings.append(self.finding(
                    module, call,
                    f"open({path_src}, {mode!r}) writes the final path "
                    f"directly: a reader (or this process, killed "
                    f"mid-write) can observe a torn file — write to a "
                    f".tmp- sibling and publish with one os.replace "
                    f"(the glt_tpu.ckpt.store discipline), or name the "
                    f"path tmp-ish if it is truly process-private"))
        return findings

    def _write_mode(self, call: ast.Call) -> Optional[str]:
        if not (isinstance(call.func, ast.Name)
                and call.func.id == "open" and call.args):
            return None
        mode = None
        if len(call.args) >= 2:
            mode = call.args[1]
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)):
            return None
        return (mode.value if any(ch in mode.value
                                  for ch in self._WRITE_MODES) else None)


# ---------------------------------------------------------------------------
# GLT012 unbounded-queue-put
# ---------------------------------------------------------------------------

@register
class UnboundedQueuePut(Rule):
    """``queue.Queue()`` built without a ``maxsize`` bound.

    The backpressure hole the serving/server paths must not have: an
    unbounded queue between a fast producer (accepting connections,
    admitting requests) and a slower consumer grows until the process
    OOMs — under overload the correct behavior is a bounded queue whose
    ``put_nowait``/``Full`` turns into a structured ``Overloaded``
    rejection (glt_tpu_torch.serving.front) or a stop-aware
    ``bounded_put``
    (channel.base).  Flags ``queue.Queue()`` / ``LifoQueue`` /
    ``PriorityQueue`` constructed with no ``maxsize`` (or an explicit
    ``maxsize<=0``, which stdlib treats as infinite), and
    ``queue.SimpleQueue()`` (unboundable by design).  Multiprocessing
    queues are out of scope: they are sized by their pipe buffers and
    used as small task queues here.
    """
    name = "unbounded-queue-put"
    code = "GLT012"
    severity = Severity.ERROR
    description = ("queue.Queue() constructed without a positive maxsize "
                   "bound (unbounded growth under backpressure)")

    _BOUNDED_CLASSES = {"queue.Queue", "queue.LifoQueue",
                        "queue.PriorityQueue"}
    _UNBOUNDABLE = {"queue.SimpleQueue"}

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = module.call_name(node)
            if name in self._UNBOUNDABLE:
                findings.append(self.finding(
                    module, node,
                    f"{name}() cannot be bounded: under backpressure it "
                    f"grows without limit — use queue.Queue(maxsize=N) "
                    f"with put_nowait -> structured rejection instead"))
                continue
            if name not in self._BOUNDED_CLASSES:
                continue
            size = None
            if node.args:
                size = node.args[0]
            for kw in node.keywords:
                if kw.arg == "maxsize":
                    size = kw.value
            if size is None:
                findings.append(self.finding(
                    module, node,
                    f"{name}() without maxsize is unbounded: a stalled "
                    f"consumer lets it grow until OOM — pass "
                    f"maxsize=<bound> and handle queue.Full as "
                    f"backpressure (reject/drop), or justify with a "
                    f"suppression"))
            elif (isinstance(size, ast.Constant)
                    and isinstance(size.value, int) and size.value <= 0):
                findings.append(self.finding(
                    module, node,
                    f"{name}(maxsize={size.value}) is the unbounded "
                    f"spelling (stdlib treats <=0 as infinite); pass a "
                    f"positive bound"))
        return findings


# ---------------------------------------------------------------------------
# GLT013 dispatch-in-epoch-loop
# ---------------------------------------------------------------------------

@register
class DispatchInEpochLoop(Rule):
    """Per-batch host round-trips inside an epoch driver's batch loop.

    The scanned-epoch contract (``models/train.py`` ``run_scanned_epoch``):
    an epoch driver replays its captured blocks and fetches device values
    ONCE at the epoch boundary — a device->host fetch (``.item()`` /
    ``.cpu()`` / ``.tolist()`` / ``.numpy()``, ``int()``/``float()``
    coercions, ``torch.cuda.synchronize``) inside the per-batch loop
    waits for the card on every batch and serializes the host's next
    launch behind it.  This is the static guard that keeps the scanned
    route from regressing to per-batch latency.

    Scope: ``for``/``while`` bodies of functions named ``run_*epoch*``.
    Direct fetches are always flagged; with a project, calls into
    helpers whose effect summary reaches a host sync are flagged too
    (the round trip hidden one call deep).  Deliberate syncs — a
    checkpoint hook that must capture post-block state — carry a
    justified suppression.
    """
    name = "dispatch-in-epoch-loop"
    code = "GLT013"
    severity = Severity.ERROR
    description = ("device->host fetch inside an epoch driver's batch "
                   "loop (the host waits for the card every batch)")

    _FETCH_CALLS = HOST_SYNC_CALLS

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        for scope in module.scopes:
            if not _is_epoch_driver(scope.name):
                continue
            for loop in _walk_own(scope.node):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for node in ast.walk(loop):
                    if isinstance(node, ast.Call):
                        f = self._check_call(module, scope, node, project)
                        if f is not None:
                            findings.append(f)
        return findings

    def _check_call(self, module: ModuleInfo, scope, call: ast.Call,
                    project) -> Optional[Finding]:
        name = module.call_name(call)
        if name in self._FETCH_CALLS:
            return self.finding(
                module, call,
                f"'{name}' inside the batch loop of epoch driver "
                f"'{scope.name}' waits for the card every batch — keep "
                f"device values on the device and fetch ONCE after the "
                f"loop (one cat + one host read), or justify with a "
                f"suppression")
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in SYNC_METHODS):
            return self.finding(
                module, call,
                f".{call.func.attr}() inside the batch loop of epoch "
                f"driver '{scope.name}' is a per-batch device sync — "
                f"hoist the fetch out of the loop or justify with a "
                f"suppression")
        if name in COERCIONS and call.args \
                and _traced_names(call.args[0]) - {"len"}:
            return self.finding(
                module, call,
                f"'{name}(...)' inside the batch loop of epoch driver "
                f"'{scope.name}': coercing a device value is a blocking "
                f"fetch per batch — keep losses as device tensors and "
                f"reduce once after the loop")
        # One call deep: a helper whose effect summary reaches a host
        # sync (project-wide pass only).
        if project is not None:
            sym = project.resolve_call(module, scope, call)
            if isinstance(sym, FunctionSymbol):
                summary = project.effects.summary_for(sym)
                sync = summary.sync_param_map()
                if sync:
                    p, site = next(iter(sorted(sync.items())))
                    return self.finding(
                        module, call,
                        f"'{sym.short}' called in the batch loop of "
                        f"epoch driver '{scope.name}' reaches a host "
                        f"sync through parameter '{p}' "
                        f"({sym.module.path}:{site.line}) — a hidden "
                        f"per-batch round trip; fetch after the epoch "
                        f"instead")
        return None


# ---------------------------------------------------------------------------
# GLT014 blocking-io-in-epoch-loop
# ---------------------------------------------------------------------------

@register
class BlockingIOInEpochLoop(Rule):
    """Synchronous disk reads inside an epoch driver's batch loop.

    The disk tier's contract: storage I/O belongs on the DRAM stager's
    background threads, hinted ahead of the sampler —
    a synchronous read (``np.load``/``np.fromfile``, slicing a
    ``np.memmap``, a file object's ``.read()``) inside the per-batch
    loop of a ``run_*epoch*`` driver puts device-idle milliseconds on
    every batch: the demand-fault path the stage-ahead hook exists to
    avoid.  Staging threads are out of scope by construction — they are
    not epoch drivers.

    Direct reads are always flagged; with a project, calls into helpers
    whose effect summary reaches a disk read (``DiskFeatureStore.
    gather_into`` -> ``_read_chunk`` -> memmap slice) are flagged one
    call deep.  Deliberate synchronous reads — the degraded fallback a
    failed stage leaves behind — carry a justified suppression.
    """
    name = "blocking-io-in-epoch-loop"
    code = "GLT014"
    severity = Severity.ERROR
    description = ("synchronous disk read inside an epoch driver's "
                   "batch loop (device idles behind storage; stage "
                   "ahead on the DRAM stager's threads instead)")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        for scope in module.scopes:
            if not _is_epoch_driver(scope.name):
                continue
            mapped = self._mmap_names(module, scope)
            for loop in _walk_own(scope.node):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                for node in ast.walk(loop):
                    f = self._check_node(module, scope, node, mapped,
                                         project)
                    if f is not None:
                        findings.append(f)
        return findings

    @staticmethod
    def _mmap_names(module: ModuleInfo, scope) -> set:
        """Names assigned from mmap constructors anywhere in the scope
        (the constructor is usually hoisted above the loop; the reads
        are the slices inside it)."""
        mapped = set()
        for node in _walk_own(scope.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if (isinstance(value, ast.Call)
                        and module.call_name(value) in MMAP_CALLS):
                    mapped.update(assign_targets(node))
        return mapped

    def _check_node(self, module: ModuleInfo, scope, node: ast.AST,
                    mapped: set, project) -> Optional[Finding]:
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in mapped):
            return self.finding(
                module, node,
                f"slicing memmap '{node.value.id}' inside the batch "
                f"loop of epoch driver '{scope.name}' page-faults to "
                f"storage per batch — stage the rows ahead "
                f"(DramStager.stage_ahead) or justify with a "
                f"suppression")
        if not isinstance(node, ast.Call):
            return None
        name = module.call_name(node)
        if name in DISK_CALLS:
            return self.finding(
                module, node,
                f"'{name}' inside the batch loop of epoch driver "
                f"'{scope.name}' reads storage on the dispatch thread "
                f"every batch — stage ahead on the DRAM stager's "
                f"threads, or justify with a suppression")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in DISK_READ_METHODS):
            return self.finding(
                module, node,
                f".{node.func.attr}() inside the batch loop of epoch "
                f"driver '{scope.name}' is a synchronous file read per "
                f"batch — move it to a staging thread or justify with "
                f"a suppression")
        # One call deep: a helper whose effect summary reaches a disk
        # read (project-wide pass only).
        if project is not None:
            sym = project.resolve_call(module, scope, node)
            if isinstance(sym, FunctionSymbol):
                summary = project.effects.summary_for(sym)
                if summary.disk:
                    d = summary.disk[0]
                    return self.finding(
                        module, node,
                        f"'{sym.short}' called in the batch loop of "
                        f"epoch driver '{scope.name}' reaches a disk "
                        f"read ({d.detail}, {sym.module.path}:{d.line})"
                        f" — a synchronous storage hit per batch; "
                        f"stage ahead instead")
        return None


@register
class WallClockDuration(Rule):
    """Durations measured by differencing ``time.time()`` readings.

    ``time.time()`` is the WALL clock: NTP slews/steps it, a VM
    migration jumps it, and a leap smear stretches it — a duration
    computed as the difference of two wall readings can come out
    negative or wildly wrong, and these numbers feed SLO histograms
    and retry backoffs.  Durations belong on ``time.monotonic()`` /
    ``time.perf_counter()`` (the convention everywhere in this tree).

    Flagged: a ``-`` expression whose BOTH operands are wall readings —
    direct ``time.time()`` calls or names/attributes assigned from one
    in the same scope.  Subtracting a wall reading from a wall-derived
    *timestamp* (``time.time() - os.path.getmtime(p)``, checkpoint
    mtimes, event ``ts`` fields) is NOT flagged: comparing two wall
    timestamps is what the wall clock is for; only a wall-vs-wall
    *interval* pretends to be a stopwatch.
    """
    name = "wall-clock-duration"
    code = "GLT015"
    severity = Severity.ERROR
    description = ("duration computed from two time.time() readings "
                   "(wall clock steps under NTP/migration; use "
                   "time.monotonic() or time.perf_counter())")

    _WALL = "time.time"

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        for scope in module.scopes:
            wall = self._wall_names(module, scope)
            for node in _walk_own(scope.node):
                if (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.Sub)
                        and self._is_wall(module, node.left, wall)
                        and self._is_wall(module, node.right, wall)):
                    findings.append(self.finding(
                        module, node,
                        f"duration from two time.time() readings in "
                        f"'{scope.name}' — the wall clock slews and "
                        f"steps; time a span with time.monotonic() or "
                        f"time.perf_counter(), or justify with a "
                        f"suppression"))
        return findings

    def _wall_names(self, module: ModuleInfo, scope) -> Set[str]:
        """Names / self-attributes assigned from ``time.time()`` in the
        scope (the ``t0 = time.time()`` half of the anti-pattern)."""
        wall: Set[str] = set()
        for node in _walk_own(scope.node):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = getattr(node, "value", None)
                if (isinstance(value, ast.Call)
                        and module.call_name(value) == self._WALL):
                    wall.update(assign_targets(node))
        return wall

    def _is_wall(self, module: ModuleInfo, node: ast.expr,
                 wall: Set[str]) -> bool:
        if (isinstance(node, ast.Call)
                and module.call_name(node) == self._WALL):
            return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            d = _dotted(node)
            return d is not None and d in wall
        return False


# ---------------------------------------------------------------------------
# GLT016 unbalanced-profiler-capture
# ---------------------------------------------------------------------------

@register
class UnbalancedProfilerCapture(Rule):
    """A ``torch.profiler`` capture started without a guaranteed stop.

    A profiler left running skews every measurement after it, keeps
    CUPTI's activity buffers growing until process exit, and — on an
    exception between start and stop — loses the trace exactly when the
    run is most worth tracing.  The stop must be UNCONDITIONAL — in a
    ``finally`` block — or the capture should go through a ``with``
    block (``with torch.profiler.profile(...)``,
    :func:`glt_tpu_torch.obs.profiler.capture`,
    :func:`glt_tpu_torch.utils.profile.trace`).

    Starts: ``torch.cuda.profiler.start()``, and ``.start()`` /
    ``.__enter__()`` on a ``torch.profiler.profile(...)`` (chained, or a
    name assigned from one in the same scope), stopped by
    ``torch.cuda.profiler.stop()`` and by that name's ``.stop()`` /
    ``.__exit__(...)``.  Accepted shapes:

    * the start inside a ``try`` whose ``finally`` stops, and
    * the start before a ``try`` in the same statement list whose
      ``finally`` stops (the contextmanager idiom of
      ``obs/profiler.py``: ``prof.__enter__(); try: yield; finally:
      prof.__exit__(None, None, None)``).
    """
    name = "unbalanced-profiler-capture"
    code = "GLT016"
    severity = Severity.ERROR
    description = ("torch.profiler / torch.cuda.profiler start without "
                   "the matching stop in a finally (use try/finally or "
                   "a with block)")

    _PROFILES = {"torch.profiler.profile", "torch.autograd.profiler.profile"}

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        if "profiler" not in module.source:
            return findings
        # module.scopes holds only function scopes; a module-level bare
        # start (scripts, __main__ blocks) leaks the same way.
        roots = [(module.tree, "<module>")] + [
            (s.node, s.name) for s in module.scopes]
        for root, scope_name in roots:
            profs = self._profile_names(module, root)
            starts: Dict[int, Tuple[ast.Call, str, Optional[str]]] = {}
            trys: List[ast.Try] = []
            for node in _walk_own(root):
                if isinstance(node, ast.Call):
                    got = self._start(module, node, profs)
                    if got is not None:
                        starts[id(node)] = (node, *got)
                elif isinstance(node, ast.Try):
                    trys.append(node)
            if not starts:
                continue
            balanced: Set[int] = set()
            # Shape 1: start inside a try whose finally has the stop.
            for t in trys:
                stops = self._final_stops(module, t, profs)
                if not stops:
                    continue
                for part in (t.body, t.handlers, t.orelse):
                    for stmt in part:
                        for n in ast.walk(stmt):
                            if id(n) in starts and \
                                    starts[id(n)][2] in stops:
                                balanced.add(id(n))
            # Shape 2: start before a try (same statement list) whose
            # finally has the stop — the contextmanager idiom.
            for holder in [root, *_walk_own(root)]:
                for field in ("body", "orelse", "finalbody"):
                    stmts = getattr(holder, field, None)
                    if isinstance(stmts, list):
                        self._scan_block(module, stmts, starts, balanced,
                                         profs)
            for key, (n, what, stop) in starts.items():
                if key in balanced:
                    continue
                needed = (f"{stop.rsplit('.', 1)[-1]}()" if stop
                          else "a stop")
                findings.append(self.finding(
                    module, n,
                    f"{what} in '{scope_name}' without {needed} in a "
                    f"finally — an exception leaks the capture; wrap in "
                    f"try/finally or a with block "
                    f"(glt_tpu_torch.obs.profiler.capture())"))
        return findings

    def _profile_names(self, module: ModuleInfo, root: ast.AST) -> Set[str]:
        out: Set[str] = set()
        for node in _walk_own(root):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and module.call_name(node.value) in self._PROFILES):
                for t in node.targets:
                    d = _dotted(t)
                    if d is not None:
                        out.add(d)
        return out

    def _start(self, module: ModuleInfo, call: ast.Call, profs: Set[str]
               ) -> Optional[Tuple[str, Optional[str]]]:
        """(what started, the stop that balances it) for a start call."""
        name = module.call_name(call)
        if name == "torch.cuda.profiler.start":
            return f"{name}()", "torch.cuda.profiler.stop"
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in ("start",
                                                             "__enter__"):
            recv = func.value
            if (isinstance(recv, ast.Call)
                    and module.call_name(recv) in self._PROFILES):
                return f"{module.call_name(recv)}(...).{func.attr}()", None
            d = _dotted(recv)
            if d is not None and d in profs:
                return f"{d}.{func.attr}()", f"{d}.stop"
        return None

    def _stop(self, module: ModuleInfo, call: ast.Call, profs: Set[str]
              ) -> Optional[str]:
        name = module.call_name(call)
        if name == "torch.cuda.profiler.stop":
            return name
        func = call.func
        if isinstance(func, ast.Attribute) and func.attr in ("stop",
                                                             "__exit__"):
            d = _dotted(func.value)
            if d is not None and d in profs:
                return f"{d}.stop"
        return None

    def _final_stops(self, module: ModuleInfo, t: ast.Try,
                     profs: Set[str]) -> Set[str]:
        stops: Set[str] = set()
        for stmt in t.finalbody:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    got = self._stop(module, n, profs)
                    if got is not None:
                        stops.add(got)
        return stops

    def _scan_block(self, module: ModuleInfo, stmts: List[ast.stmt],
                    starts, balanced: Set[int], profs: Set[str]) -> None:
        for i, stmt in enumerate(stmts):
            pending = [n for n in ast.walk(stmt)
                       if id(n) in starts and id(n) not in balanced]
            if not pending:
                continue
            later_stops: Set[str] = set()
            for nxt in stmts[i + 1:]:
                if isinstance(nxt, ast.Try):
                    later_stops |= self._final_stops(module, nxt, profs)
            for n in pending:
                if starts[id(n)][2] in later_stops:
                    balanced.add(id(n))


# ---------------------------------------------------------------------------
# GLT022 lossy-dtype-narrowing
# ---------------------------------------------------------------------------

@register
class LossyDtypeNarrowing(Rule):
    """Narrowing casts on feature-path arrays outside the codec module.

    Feature compression is centralized in ``glt_tpu_torch/store/quant.py``:
    its codecs carry per-column scale/zero metadata in the store
    manifest and meet a bounded-error contract, and the gather kernels
    (B4, B5) widen back to the logical dtype on the card.  A bare
    ``x.astype(np.float16)`` / ``t.to(torch.bfloat16)`` / ``t.half()`` /
    ``.astype("int8")`` elsewhere silently discards precision with no
    metadata to undo it.  Route narrowing through a quant codec (or keep
    it inside ``store/quant.py`` where the contract is tested).

    Flagged: ``.astype``, ``.to``, ``.type`` to a sub-f32 float or a
    sub-i32 int (numpy, torch or string spelling), and ``.half()`` /
    ``.bfloat16()`` / ``.char()`` / ``.byte()`` / ``.short()``.  A cast
    to a dtype held in a variable is not resolved, as in ``glt_tpu``:
    the models' bf16 compute casts (``x.to(dtype)``, ``models/conv.py``)
    are out of the rule's scope, their precision set by the caller's
    ``dtype=``.
    """
    name = "lossy-dtype-narrowing"
    code = "GLT022"
    severity = Severity.ERROR
    description = ("bare narrowing cast (.astype/.to/.type to a sub-f32 "
                   "float or sub-i32 int, .half()/.bfloat16()) outside "
                   "store/quant.py (precision silently discarded with no "
                   "codec metadata to dequantize)")

    # Sub-f32 floats and sub-i32 ints: casts that drop mantissa or
    # range.  int32 itself stays legal — ids are relabeled into int32
    # range deliberately (GLT004 owns that hazard).
    _NARROW = {
        "numpy.float16", "numpy.half", "ml_dtypes.bfloat16",
        "numpy.int8", "numpy.uint8", "numpy.int16", "numpy.uint16",
        "ml_dtypes.float8_e4m3fn", "ml_dtypes.float8_e5m2",
        "torch.float16", "torch.half", "torch.bfloat16",
        "torch.int8", "torch.uint8", "torch.int16", "torch.short",
        "torch.uint16", "torch.float8_e4m3fn", "torch.float8_e5m2",
    }
    _NARROW_STRINGS = {
        "float16", "bfloat16", "int8", "uint8", "int16", "uint16",
        "float8_e4m3fn", "float8_e5m2",
    }
    _NARROW_METHODS = {"half": "float16", "bfloat16": "bfloat16",
                       "char": "int8", "byte": "uint8", "short": "int16"}

    def _narrow_target(self, module: ModuleInfo,
                       arg: ast.expr) -> Optional[str]:
        resolved = module.imports.resolve(arg)
        if resolved in self._NARROW:
            return resolved
        if (isinstance(arg, ast.Constant)
                and arg.value in self._NARROW_STRINGS):
            return str(arg.value)
        # np.dtype("float16") wrappers
        if isinstance(arg, ast.Call):
            name = module.call_name(arg) or ""
            if name == "numpy.dtype" and arg.args:
                return self._narrow_target(module, arg.args[0])
        return None

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        path = module.path.replace("\\", "/")
        if path.endswith("store/quant.py") or module.name.endswith(
                "store.quant"):
            return []
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            target = None
            if attr in self._NARROW_METHODS and not node.args \
                    and not node.keywords:
                target = self._NARROW_METHODS[attr]
            elif attr in ("astype", "to", "type"):
                for a in list(node.args) + [kw.value for kw in node.keywords
                                            if kw.arg == "dtype"]:
                    target = target or self._narrow_target(module, a)
            if target is None:
                continue
            findings.append(self.finding(
                module, node,
                f"narrowing cast .{attr}({target}) outside "
                f"store/quant.py: precision is dropped with no codec "
                f"metadata to dequantize — encode through a "
                f"glt_tpu_torch.store.quant codec instead"))
        return findings


# ---------------------------------------------------------------------------
# GLT023 unjittered-retry-loop
# ---------------------------------------------------------------------------

@register
class UnjitteredRetryLoop(Rule):
    """Constant-duration sleep inside a network retry loop.

    A retry loop that catches transport errors and then sleeps a fixed
    constant re-synchronizes every client that failed together: when a
    replica dies, all of its in-flight callers observe the reset within
    milliseconds of each other, all sleep exactly X seconds, and all
    hammer the successor in the same instant — a retry storm that turns
    one failure into rolling overload.  Every retry path in this tree
    (``subgraph_with_retry``, ``RemoteServerConnection``,
    ``FleetRouter`` failover) paces as
    ``min(cap, base * 2**attempt) * (0.5 + 0.5 * rng.random())`` —
    exponential backoff with full-range jitter — so a failed cohort
    decorrelates instead of marching in lockstep.

    Flagged: a ``time.sleep(X)`` or ``<event>.wait(X)`` whose duration
    is a compile-time constant (literals and arithmetic over literals),
    inside a ``while``/``for`` loop that also catches a transport-class
    exception (the ``OSError``/``ConnectionError`` family,
    ``TimeoutError``, ``EOFError``, ``socket.*``, ``*ProtocolError``).
    A duration with any computed component — a name, an attribute, a
    call — is clean: that computation is exactly where backoff and
    jitter live.  Loops that catch only ``Exception`` (heartbeat/poll
    loops pacing themselves, not re-contacting a failed peer) are not
    retry loops and stay clean.
    """
    name = "unjittered-retry-loop"
    code = "GLT023"
    severity = Severity.ERROR
    description = ("constant-duration sleep in a network retry loop "
                   "(failed cohort retries in lockstep — use jittered "
                   "exponential backoff)")

    _NETWORK_EXCS = {
        "OSError", "IOError", "ConnectionError", "ConnectionResetError",
        "ConnectionRefusedError", "ConnectionAbortedError",
        "BrokenPipeError", "TimeoutError", "EOFError",
        "socket.timeout", "socket.error", "socket.gaierror",
        "socket.herror",
    }

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        findings: List[Finding] = []
        flagged: Set[int] = set()
        roots = [module.tree] + [s.node for s in module.scopes]
        for root in roots:
            for node in _walk_own(root):
                if not isinstance(node, (ast.While, ast.For)):
                    continue
                if not self._has_network_handler(module, node):
                    continue
                for call in _walk_own(node):
                    if (isinstance(call, ast.Call)
                            and id(call) not in flagged
                            and self._is_const_sleep(module, call)):
                        flagged.add(id(call))
                        findings.append(self.finding(
                            module, call,
                            f"constant sleep in a loop retrying "
                            f"transport errors — every caller that "
                            f"failed together retries together; pace "
                            f"with jittered exponential backoff "
                            f"(min(cap, base * 2**attempt) * random "
                            f"jitter)"))
        return findings

    # -- helpers ----------------------------------------------------------
    def _has_network_handler(self, module: ModuleInfo,
                             loop: ast.AST) -> bool:
        for node in _walk_own(loop):
            if not isinstance(node, ast.ExceptHandler):
                continue
            types = node.type
            if types is None:
                continue    # bare except: a poll loop, not a retry loop
            elts = types.elts if isinstance(types, ast.Tuple) else [types]
            if any(self._is_network_exc(module, e) for e in elts):
                return True
        return False

    def _is_network_exc(self, module: ModuleInfo, expr: ast.expr) -> bool:
        d = _dotted(expr)
        if d is None:
            return False
        resolved = module.imports.resolve(expr) or d
        if d in self._NETWORK_EXCS or resolved in self._NETWORK_EXCS:
            return True
        return d.split(".")[-1].endswith("ProtocolError")

    def _is_const_sleep(self, module: ModuleInfo, call: ast.Call) -> bool:
        if not call.args or call.keywords:
            return False
        name = module.call_name(call)
        is_sleep = name == "time.sleep"
        is_wait = (isinstance(call.func, ast.Attribute)
                   and call.func.attr == "wait")
        if not (is_sleep or is_wait):
            return False
        return self._const_duration(call.args[0])

    def _const_duration(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool)
        if isinstance(node, ast.UnaryOp):
            return self._const_duration(node.operand)
        if isinstance(node, ast.BinOp):
            return (self._const_duration(node.left)
                    and self._const_duration(node.right))
        return False


def all_rules() -> List[Rule]:
    return [cls() for cls in RULES.values()]


# The concurrency rules (GLT008/GLT009), the launch model and the
# asynchronous-copy rings (GLT017-019, kernelmodel.py), the collectives
# of the processes (GLT020/021, spmd.py), the wire-protocol verification
# (GLT024-026, protocol.py) and the thread-safety pass (GLT027,
# threads.py) live in their own modules but register into the same
# RULES table; importing here completes the registry for every entry
# point (cli, tests, programmatic use).
from . import concurrency  # noqa: E402,F401  (registration side effect)
from . import kernelmodel  # noqa: E402,F401  (registration side effect)
from . import spmd  # noqa: E402,F401  (registration side effect)
from . import protocol  # noqa: E402,F401  (registration side effect)
from . import threads  # noqa: E402,F401  (registration side effect)
