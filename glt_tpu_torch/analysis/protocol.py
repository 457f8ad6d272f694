"""Wire-protocol verification (GLT024-026): the static **op table**
(cf. ``glt_tpu/analysis/protocol.py``).

The distributed tier speaks a hand-rolled framed RPC: JSON control
requests carrying an ``"op"`` key, dispatched server-side by a chain of
``if op == "...":`` branches (``dist_server.DistServer._handle`` /
``_serve_conn``), answered with JSON dicts or binary frames, and failed
with structured ``{"error":..., "code":...}`` objects that the client
classifies into typed/retryable/fatal.  Nothing ties the two endpoints
together at build time — exactly the drift surface this pass closes.

``extract_op_table`` recovers the contract statically from both sides:

* **server branches** — every function with two or more
  ``op == "<str>"`` (or ``req["op"] == "<str>"``) equality tests is a
  dispatch function; each branch contributes the op name, the union of
  returned dict-literal keys (response keys), and the reply frame kind
  (a branch that mentions a ``_KIND_MSG``/``_KIND_SUB`` constant
  answers with that binary frame instead of JSON);
* **client sites** — every ``*.request(op="<str>", ...)`` call and
  every dict literal containing a constant ``"op"`` key (the
  ``request(**req)`` / raw ``_exchange`` spellings), contributing the
  request key set;
* **protocol versions** — the dispatch branch returning a constant
  ``"protocol"`` key is the hello handshake and fixes the current
  protocol number; a module-level ``POST_HELLO_OPS`` frozenset beside
  the dispatch declares which ops only a current-protocol server
  understands (``min_protocol = 1``; everything else is 0).

Three rules read the table:

* **GLT024 unmatched-wire-op** — a client op with no server branch, or
  a server branch no in-tree client ever sends (endpoint drift);
* **GLT025 unclassified-error-code** — an error ``code`` constructed in
  a dispatch module that no client-side classifier recognizes (an
  explicit ``== "<code>"`` comparison, an ``*_CODES`` set literal, or
  an exception class's ``code`` attribute) — such a code silently falls
  into the generic-fatal path and breaks the exactly-once failover
  discipline, which distinguishes retryable transport from structured
  server verdicts;
* **GLT026 missing-mixed-version-fallback** — a client call site of a
  ``POST_HELLO_OPS`` op outside a ``try`` that catches the unknown-op
  fatal answer (``RuntimeError``) — the house contract degrades those
  to ``None`` / a legacy pin instead of surfacing a new failure mode
  against an older server.

``--format=optable`` dumps the extracted table as a markdown matrix.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .report import Finding
from .rules import Rule, register
from .visitor import ModuleInfo, dotted_expr

# Reserved request keys that ride along every op (trace propagation)
# rather than belonging to one op's schema.
_WIRE_META_PREFIX = "#"

_FRAME_BY_KIND_NAME = {"_KIND_MSG": "msg", "_KIND_SUB": "sub"}


@dataclass
class ClientSite:
    """One place a request for ``op`` is constructed client-side."""
    module: ModuleInfo
    node: ast.AST                  # the call or the dict literal
    scope_node: Optional[ast.AST]  # enclosing function def (for GLT026)
    keys: Set[str] = field(default_factory=set)


@dataclass
class ServerBranch:
    """One ``op == "..."`` dispatch branch."""
    module: ModuleInfo
    node: ast.AST                  # the comparison's If (or the Compare)
    frame: str = "json"
    response_keys: Set[str] = field(default_factory=set)
    response_open: bool = False    # a return spreads **something


@dataclass
class WireOp:
    """One op's merged two-endpoint contract."""
    op: str
    client_sites: List[ClientSite] = field(default_factory=list)
    server: Optional[ServerBranch] = None
    min_protocol: int = 0

    @property
    def frame(self) -> str:
        return self.server.frame if self.server is not None else "json"

    @property
    def request_keys(self) -> Set[str]:
        out: Set[str] = set()
        for site in self.client_sites:
            out |= site.keys
        return out

    @property
    def response_keys(self) -> Set[str]:
        return set(self.server.response_keys) if self.server else set()


@dataclass
class OpTable:
    """The whole extracted protocol, plus the error-code inventory."""
    ops: Dict[str, WireOp] = field(default_factory=dict)
    protocol: int = 0              # current version, from the hello reply
    server_modules: List[ModuleInfo] = field(default_factory=list)
    # error codes: where each server-side code string is constructed,
    # and the set of codes any client-side classifier recognizes
    constructed_codes: List[Tuple[str, ModuleInfo, ast.AST]] = field(
        default_factory=list)
    recognized_codes: Set[str] = field(default_factory=set)

    def wire_op(self, name: str) -> WireOp:
        if name not in self.ops:
            self.ops[name] = WireOp(name)
        return self.ops[name]


# -- extraction -------------------------------------------------------------

def _op_compare_str(node: ast.AST) -> Optional[str]:
    """The string constant of an ``op == "<str>"`` / ``req["op"] ==
    "<str>"`` equality test, else None."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.ops[0], ast.Eq)):
        return None
    left, right = node.left, node.comparators[0]
    if (isinstance(left, ast.Constant)
            and isinstance(left.value, str)):
        left, right = right, left
    if not (isinstance(right, ast.Constant)
            and isinstance(right.value, str)):
        return None
    if isinstance(left, ast.Name) and left.id == "op":
        return right.value
    if (isinstance(left, ast.Subscript)
            and isinstance(left.slice, ast.Constant)
            and left.slice.value == "op"):
        return right.value
    return None


def _const_dict_keys(d: ast.Dict) -> Tuple[Set[str], bool]:
    """(constant string keys, has-dynamic-or-spread-entries)."""
    keys: Set[str] = set()
    open_ended = False
    for k in d.keys:
        if k is None:                       # **spread
            open_ended = True
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            if not k.value.startswith(_WIRE_META_PREFIX):
                keys.add(k.value)
        else:
            open_ended = True
    return keys, open_ended


def _branch_facts(branch_body: List[ast.stmt]) -> ServerBranch:
    """Frame kind + response keys of one dispatch branch body (the
    statements dominated by the ``op == ...`` test)."""
    facts = ServerBranch(module=None, node=None)  # filled by caller
    for stmt in branch_body:
        for node in ast.walk(stmt):
            if (isinstance(node, ast.Name)
                    and node.id in _FRAME_BY_KIND_NAME):
                facts.frame = _FRAME_BY_KIND_NAME[node.id]
            if isinstance(node, ast.Return) and isinstance(
                    node.value, ast.Dict):
                keys, open_ended = _const_dict_keys(node.value)
                facts.response_keys |= keys
                facts.response_open |= open_ended
    return facts


def _dispatch_branches(fn: ast.AST) -> List[Tuple[str, ast.If]]:
    """All ``op == "<str>"`` branch tests inside one function body."""
    out: List[Tuple[str, ast.If]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            opname = _op_compare_str(node.test)
            if opname is not None:
                out.append((opname, node))
    return out


def _scan_server(module: ModuleInfo, table: OpTable) -> None:
    is_server = False
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        branches = _dispatch_branches(fn)
        if len(branches) < 2:
            continue
        is_server = True
        for opname, if_node in branches:
            facts = _branch_facts(if_node.body)
            facts.module, facts.node = module, if_node
            wire = table.wire_op(opname)
            if wire.server is None:
                wire.server = facts
            else:                           # split across functions
                wire.server.response_keys |= facts.response_keys
                if facts.frame != "json":
                    wire.server.frame = facts.frame
            if "protocol" in facts.response_keys:
                table.protocol = max(
                    table.protocol, _const_protocol(if_node) or 0)
    if is_server:
        table.server_modules.append(module)


def _const_protocol(if_node: ast.If) -> Optional[int]:
    """The constant value returned under a ``"protocol"`` key."""
    for node in ast.walk(if_node):
        if not (isinstance(node, ast.Return)
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if (isinstance(k, ast.Constant) and k.value == "protocol"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, int)):
                return v.value
    return None


def _scan_clients(module: ModuleInfo, table: OpTable) -> None:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            opname, keys = _request_call_op(node)
        elif isinstance(node, ast.Dict):
            opname, keys = _dict_literal_op(node)
        else:
            continue
        if opname is None:
            continue
        site = ClientSite(module, node, _enclosing_def(module, node),
                          keys=keys)
        table.wire_op(opname).client_sites.append(site)


def _request_call_op(call: ast.Call
                     ) -> Tuple[Optional[str], Set[str]]:
    """``*.request(op="<str>", key=..., _opt=...)`` spellings."""
    fname = (call.func.attr if isinstance(call.func, ast.Attribute)
             else call.func.id if isinstance(call.func, ast.Name)
             else None)
    if fname != "request":
        return None, set()
    opname = None
    keys: Set[str] = set()
    for kw in call.keywords:
        if kw.arg is None:
            continue                        # **req — dict literal scan
        if kw.arg == "op":
            if (isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)):
                opname = kw.value.value
        elif not kw.arg.startswith("_"):
            keys.add(kw.arg)
    return opname, keys


def _dict_literal_op(d: ast.Dict) -> Tuple[Optional[str], Set[str]]:
    """A request built as a dict literal: ``{"op": "<str>", ...}``."""
    opname = None
    for k, v in zip(d.keys, d.values):
        if (isinstance(k, ast.Constant) and k.value == "op"
                and isinstance(v, ast.Constant)
                and isinstance(v.value, str)):
            opname = v.value
    if opname is None:
        return None, set()
    keys, _open = _const_dict_keys(d)
    keys.discard("op")
    return opname, {k for k in keys if not k.startswith("_")}


def _enclosing_def(module: ModuleInfo,
                   node: ast.AST) -> Optional[ast.AST]:
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = module.parents.get(cur)
    return None


def _post_hello_ops(table: OpTable) -> Set[str]:
    """The declared ``POST_HELLO_OPS`` frozenset of the server module:
    ops only a current-protocol server answers (older servers reply
    with the unknown-op fatal error)."""
    gated: Set[str] = set()
    for module in table.server_modules:
        for stmt in ast.iter_child_nodes(module.tree):
            if not isinstance(stmt, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name)
                       and t.id == "POST_HELLO_OPS"
                       for t in stmt.targets):
                continue
            for sub in ast.walk(stmt.value):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    gated.add(sub.value)
    return gated


# -- error-code inventory ----------------------------------------------------

def _mentions_code(expr: ast.AST) -> bool:
    """Does this expression read an error code?  ``code``,
    ``resp.get("code")``, ``e.code``, ``resp["code"]``."""
    if isinstance(expr, ast.Name):
        return expr.id == "code"
    if isinstance(expr, ast.Attribute):
        return expr.attr == "code"
    if isinstance(expr, ast.Subscript):
        return (isinstance(expr.slice, ast.Constant)
                and expr.slice.value == "code")
    if isinstance(expr, ast.Call):
        return (isinstance(expr.func, ast.Attribute)
                and expr.func.attr == "get"
                and bool(expr.args)
                and isinstance(expr.args[0], ast.Constant)
                and expr.args[0].value == "code")
    return False


def _scan_recognized_codes(module: ModuleInfo, table: OpTable) -> None:
    for node in ast.walk(module.tree):
        # 1. explicit comparison / membership against a code expression
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            left, right = node.left, node.comparators[0]
            if _mentions_code(left):
                if (isinstance(node.ops[0], (ast.Eq, ast.NotEq))
                        and isinstance(right, ast.Constant)
                        and isinstance(right.value, str)):
                    table.recognized_codes.add(right.value)
            elif (_mentions_code(right)
                  and isinstance(node.ops[0], (ast.Eq, ast.NotEq))
                  and isinstance(left, ast.Constant)
                  and isinstance(left.value, str)):
                table.recognized_codes.add(left.value)
        # 2. *_CODES set/frozenset literals (FATAL_CODES and friends)
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id.endswith("_CODES")
                for t in node.targets):
            for sub in ast.walk(node.value):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    table.recognized_codes.add(sub.value)
        # 3. exception classes carrying a class-level ``code`` attr
        #    (serving.errors: SERVING_CODES is built from these)
        if isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if (isinstance(stmt, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "code"
                                for t in stmt.targets)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)):
                    table.recognized_codes.add(stmt.value.value)


def _scan_constructed_codes(module: ModuleInfo, table: OpTable) -> None:
    """Server-side code constructions: ``code="<str>"`` kwargs,
    assignments to a bare ``code`` name, and ``"code": "<str>"`` dict
    entries — only inside dispatch modules."""
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "code":
                    for c in _str_constants(kw.value):
                        table.constructed_codes.append(
                            (c, module, kw.value))
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "code"
                   for t in node.targets):
                for c in _str_constants(node.value):
                    table.constructed_codes.append((c, module, node))
        elif isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "code"):
                    for c in _str_constants(v):
                        table.constructed_codes.append((c, module, v))


def _str_constants(expr: ast.AST) -> List[str]:
    """String constants that can flow into a code value.  The
    attribute-name argument of ``getattr(e, "code", default)`` is a
    field selector, not a code — only the default can flow."""
    skip: Set[int] = set()
    for n in ast.walk(expr):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "getattr" and len(n.args) >= 2):
            skip.add(id(n.args[1]))
    return [n.value for n in ast.walk(expr)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in skip]


def extract_op_table(project) -> OpTable:
    """Build (and memoize on the project) the two-endpoint op table."""
    cached = getattr(project, "_wire_op_table", None)
    if cached is not None:
        return cached
    table = OpTable()
    for name in sorted(project.modules):
        _scan_server(project.modules[name], table)
    for name in sorted(project.modules):
        module = project.modules[name]
        _scan_clients(module, table)
        _scan_recognized_codes(module, table)
    for module in table.server_modules:
        _scan_constructed_codes(module, table)
    gated = _post_hello_ops(table)
    for opname in gated:
        wire = table.wire_op(opname)
        wire.min_protocol = max(table.protocol, 1)
    project._wire_op_table = table
    return table


def format_op_table(table: OpTable) -> str:
    """The op table as a markdown matrix, one row an op."""
    lines = [
        "| op | frame | min protocol | request keys | response keys |",
        "|---|---|---|---|---|",
    ]
    for opname in sorted(table.ops):
        wire = table.ops[opname]
        req = ", ".join(sorted(wire.request_keys)) or "—"
        resp = ", ".join(sorted(wire.response_keys))
        if wire.server is not None and wire.server.response_open:
            resp = resp + ", …" if resp else "…"
        if wire.frame != "json" and not resp:
            resp = f"({wire.frame} frame)"
        lines.append(
            f"| `{opname}` | {wire.frame} | {wire.min_protocol} "
            f"| {req} | {resp or '—'} |")
    return "\n".join(lines)


# -- the rules ---------------------------------------------------------------

@register
class UnmatchedWireOp(Rule):
    name = "unmatched-wire-op"
    code = "GLT024"
    description = ("a wire op constructed on one endpoint with no "
                   "counterpart on the other (client/server drift)")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        table = extract_op_table(project)
        if not table.server_modules:
            return []                      # no dispatch in this file set
        any_client = any(w.client_sites for w in table.ops.values())
        out: List[Finding] = []
        for opname in sorted(table.ops):
            wire = table.ops[opname]
            if wire.server is None:
                for site in wire.client_sites:
                    if site.module is module:
                        out.append(self.finding(
                            module, site.node,
                            f"client sends op '{opname}' but no server "
                            f"dispatch branch handles it — a current "
                            f"server answers with the unknown-op fatal "
                            f"error"))
            elif not wire.client_sites and any_client:
                if wire.server.module is module:
                    out.append(self.finding(
                        module, wire.server.node,
                        f"server handles op '{opname}' but no in-tree "
                        f"client ever sends it — dead dispatch branch "
                        f"or an endpoint that drifted"))
        return out


@register
class UnclassifiedErrorCode(Rule):
    name = "unclassified-error-code"
    code = "GLT025"
    description = ("a server-side error code no client classifier "
                   "recognizes (falls into the generic-fatal path)")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        table = extract_op_table(project)
        out: List[Finding] = []
        seen: Set[Tuple[str, int]] = set()
        for codename, mod, node in table.constructed_codes:
            if mod is not module:
                continue
            if codename in table.recognized_codes:
                continue
            key = (codename, getattr(node, "lineno", 0))
            if key in seen:
                continue
            seen.add(key)
            out.append(self.finding(
                module, node,
                f"error code '{codename}' is constructed here but no "
                f"client classifier recognizes it (no typed mapping, "
                f"no *_CODES membership, no explicit comparison) — it "
                f"degrades to an opaque RuntimeError and the failover "
                f"discipline cannot tell it from a transport fault"))
        return out


@register
class MissingMixedVersionFallback(Rule):
    name = "missing-mixed-version-fallback"
    code = "GLT026"
    description = ("a post-hello op sent without handling the "
                   "unknown-op fatal answer of an older server")

    def check(self, module: ModuleInfo, project=None) -> List[Finding]:
        if project is None:
            return []
        table = extract_op_table(project)
        out: List[Finding] = []
        for opname in sorted(table.ops):
            wire = table.ops[opname]
            if wire.min_protocol < 1:
                continue
            for site in wire.client_sites:
                if site.module is not module:
                    continue
                if self._degrades(module, site):
                    continue
                out.append(self.finding(
                    module, site.node,
                    f"op '{opname}' requires protocol "
                    f">= {wire.min_protocol}, but this send does not "
                    f"handle the unknown-op fatal answer of an older "
                    f"server (wrap it in try/except RuntimeError and "
                    f"degrade to None or pin the peer legacy)"))
        return out

    def _degrades(self, module: ModuleInfo, site: ClientSite) -> bool:
        if _inside_runtime_try(module, site.node):
            return True
        # A request dict built outside the try and sent via
        # ``request(**req)`` / ``_exchange(...)`` inside it: accept the
        # fallback if any send call in the same function is guarded.
        if isinstance(site.node, ast.Dict) and site.scope_node is not None:
            for node in ast.walk(site.scope_node):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("request", "_exchange")
                        and _inside_runtime_try(module, node)):
                    return True
        return False


_RUNTIME_NAMES = {"RuntimeError", "Exception", "BaseException"}


def _inside_runtime_try(module: ModuleInfo, node: ast.AST) -> bool:
    """Is ``node`` inside the body of a ``try`` whose handlers catch
    ``RuntimeError`` (directly, via a tuple, or as ``Exception``)?"""
    cur = node
    parent = module.parents.get(cur)
    while parent is not None:
        if isinstance(parent, ast.Try) and _in_try_body(parent, cur):
            for handler in parent.handlers:
                if _handler_catches_runtime(handler):
                    return True
        cur, parent = parent, module.parents.get(parent)
    return False


def _in_try_body(try_node: ast.Try, child: ast.AST) -> bool:
    return any(child is stmt for stmt in try_node.body)


def _handler_catches_runtime(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                        # bare except
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in types:
        name = e.id if isinstance(e, ast.Name) else (
            dotted_expr(e) or "").rsplit(".", 1)[-1]
        if name in _RUNTIME_NAMES:
            return True
    return False
