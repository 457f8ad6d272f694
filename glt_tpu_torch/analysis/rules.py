"""gltlint rules for the port: the thread, lock, wire and storage
hazards (cf. ``glt_tpu/analysis/rules.py``).

Each rule is a class with a ``check(module, project=None) -> [Finding]``
method, registered in ``RULES`` by name.  Severities: ERROR findings gate
(non-zero exit), WARNINGs report but pass.  ``project`` — the
project-wide symbol table / call graph / effect summaries
(analysis/symbols.py) — is provided whenever the CLI analyzes a file
set; rules use it to follow effects through calls (GLT014 one call deep;
GLT008/GLT009 — analysis/concurrency.py — are built on it).  Without a
project a rule degrades to its intraprocedural behavior.

These are the JAX linter's framework-free rules, with its codes, names,
severities and messages, so the same source gives the same findings in
both linters.  The analyses are deliberately linear/flow-light:
statements are walked in source order, ``if`` branches fork analysis
state, loops are traversed once, and unresolvable calls contribute no
effects rather than worst-case guesses.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .effects import DISK_CALLS, DISK_READ_METHODS, MMAP_CALLS
from .report import Finding, Severity
from .symbols import FunctionSymbol
from .visitor import ModuleInfo, assign_targets, dotted_expr, walk_own

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


def _is_epoch_driver(name: str) -> bool:
    """The epoch-driver naming convention: ``run_*epoch*`` /
    ``_run_*epoch*`` (``run_scanned_epoch``, ``run_scanned_dist_epoch``,
    ``_ColdStagePipeline.run_epoch``)."""
    return "epoch" in name and name.startswith(("run_", "_run_"))


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


# The concurrency rules (GLT008/GLT009), the launch model (GLT017/GLT019,
# kernelmodel.py), the wire-protocol verification (GLT024-026,
# protocol.py) and the thread-safety pass (GLT027, threads.py) live in
# their own modules but register into the same RULES table; importing
# here completes the registry for every entry point (cli, tests,
# programmatic use).
from . import concurrency  # noqa: E402,F401  (registration side effect)
from . import kernelmodel  # noqa: E402,F401  (registration side effect)
from . import protocol  # noqa: E402,F401  (registration side effect)
from . import threads  # noqa: E402,F401  (registration side effect)
