"""The port's gltlint (``glt_tpu_torch.analysis``) against ``glt_tpu``'s.

Each of the 13 framework-free rules has fixtures that fire and fixtures
that stay clean, their sources taken from the matching
``tests/test_analysis`` classes; both linters must give equal findings
(path, line, column, rule, code, severity and message) over those codes.
The registry holds every code ``glt_tpu`` lists, GLT001-GLT027, with its
name and severity; the 12 rules that name JAX there check their torch
forms (``tests/test_torch_lint_jaxrules.py``).  The launch model's two
rules (GLT017, GLT019: torch forms of ``glt_tpu``'s VMEM and tile rules)
fire on their fixtures and stay silent on the port's swept kernels.
Over the whole port both give equal findings on the 13 codes (also with
the suppressions off, where the justified ones show), the torch-form
rules' justified sites are the ones ROADMAP's C4 records, and the port's
gate ``python -m glt_tpu_torch.analysis glt_tpu_torch chip_smoke.py``
exits 0.  Suppression parsing, the baseline round trip, the symbol table
and effect engine, the op table (with the server's ``POST_HELLO_OPS``)
and the CLI's flags match too.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import glt_tpu.analysis as jlint
import glt_tpu_torch.analysis as tlint
from glt_tpu.analysis import report as jreport
from glt_tpu.analysis.cli import build_project as jbuild
from glt_tpu.analysis.protocol import extract_op_table as jop_table
from glt_tpu.analysis.protocol import format_op_table as jformat_table
from glt_tpu.analysis.symbols import Project as JProject
from glt_tpu.analysis.visitor import ModuleInfo as JModuleInfo
from glt_tpu_torch.analysis import report as treport
from glt_tpu_torch.analysis.cli import build_project as tbuild
from glt_tpu_torch.analysis.effects import MAX_CHAIN_DEPTH
from glt_tpu_torch.analysis.protocol import extract_op_table as top_table
from glt_tpu_torch.analysis.protocol import format_op_table as tformat_table
from glt_tpu_torch.analysis.symbols import Project as TProject
from glt_tpu_torch.analysis.visitor import ModuleInfo as TModuleInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

PORTED = ("GLT005", "GLT007", "GLT008", "GLT009", "GLT011", "GLT012",
          "GLT014", "GLT015", "GLT023", "GLT024", "GLT025", "GLT026",
          "GLT027")
# The launch model's rules: the codes of glt_tpu's kernel-model rules,
# checked against the H100's launch limits instead of VMEM and tiles.
LAUNCH = ("GLT017", "GLT019")


def _key(f):
    return (f.path, f.line, f.col, f.rule, f.code, str(f.severity),
            f.message)


def _ported(findings):
    return sorted(_key(f) for f in findings if f.code in PORTED)


def _project(modinfo, project_cls, sources):
    return project_cls([
        modinfo(name.replace(".", "/") + ".py", textwrap.dedent(src),
                module_name=name)
        for name, src in sources.items()])


def both_findings(sources):
    """Equal findings of both linters over ``sources`` (one source: the
    single-module ``analyze_source``; a dict ``{module: source}``: one
    project), returned as sorted tuples."""
    if isinstance(sources, str):
        src = textwrap.dedent(sources)
        want = _ported(jlint.analyze_source(src, "fixture.py"))
        got = _ported(tlint.analyze_source(src, "fixture.py"))
    else:
        want = _ported(jlint.analyze_project(
            _project(JModuleInfo, JProject, sources)))
        got = _ported(tlint.analyze_project(
            _project(TModuleInfo, TProject, sources)))
    assert got == want
    return got


# -- fixtures, from tests/test_analysis.py -----------------------------------

RNG_UNSEEDED = """
import numpy as np

def shuffle(ids):
    return np.random.default_rng().permutation(ids)
"""
RNG_NONE = """
import numpy as np

rng = np.random.default_rng(None)
"""
RNG_FRESH_PER_CALL = """
import numpy as np

def split(ids, seed=0):
    return np.random.default_rng(seed).permutation(ids)
"""
RNG_CLEAN = """
import numpy as np

FIXTURE = np.random.default_rng(0).permutation(16)   # one-shot

def split(ids, rng: np.random.Generator):
    return rng.permutation(ids)                      # threaded

def per_step(ids, step):
    return np.random.default_rng(step * 7 + 1).permutation(ids)
"""

GET_BARE = """
import queue

def consume(q):
    item = q.get()          # blocks forever if producer died
    return item
"""
JOIN_BARE = """
import threading

def stop(worker):
    worker.stop_flag = True
    worker.thread.join()    # thread may be wedged on a queue
"""
GET_TIMEOUT = """
def consume(q):
    return q.get(timeout=0.5)

def stop(t):
    t.join(5)
"""
GET_LIVENESS = """
import queue

def consume(q, thread):
    while True:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            if not thread.is_alive():
                raise RuntimeError("producer died")
"""
GET_ARGFUL = """
import os

def lookup(d, parts):
    root = os.environ.get("ROOT")
    return d.get(root), ",".join(parts)
"""
GET_SUPPRESSED = """
def worker_loop(tasks):
    while True:
        # Parent owns this worker's lifetime; wait is bounded.
        # gltlint: disable-next=unbounded-blocking-get
        cmd = tasks.get()
        if cmd is None:
            return
"""

LOCKS_INVERTED = """
import threading

class S:
    def __init__(self):
        self.a = threading.Lock()
        self.b = threading.Lock()

    def f(self):
        with self.a:
            with self.b:
                pass

    def g(self):
        with self.b:
            with self.a:
                pass
"""
LOCKS_CROSS_MODULE = {
    "pkg.locks": """
        import threading

        LOCK_A = threading.Lock()
        LOCK_B = threading.Lock()

        def take_b():
            with LOCK_B:
                pass

        def path1():
            with LOCK_A:
                take_b()
    """,
    "pkg.other": """
        from pkg.locks import LOCK_A, LOCK_B

        def take_a():
            with LOCK_A:
                pass

        def path2():
            with LOCK_B:
                take_a()
    """,
}
LOCKS_CONSISTENT = LOCKS_INVERTED.replace(
    "        with self.b:\n            with self.a:",
    "        with self.a:\n            with self.b:")
LOCKS_REENTRY = """
import threading

class S:
    def __init__(self):
        self.a = threading.Lock()

    def f(self):
        with self.a:
            pass

    def g(self):
        with self.a:
            pass
"""

RECV_UNDER_LOCK = """
import socket
import threading

class Conn:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = socket.socket()

    def fetch(self):
        with self._lock:
            return self.sock.recv(4096)
"""
HELPER_UNDER_LOCK = """
import threading

def drain(q):
    return q.get()

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def fetch(self, q):
        with self._lock:
            return drain(q)
"""
SLEEP_UNDER_MODULE_LOCK = """
import threading
import time

_LOCK = threading.Lock()

def slow():
    with _LOCK:
        time.sleep(1.0)
"""
RECV_OUTSIDE_LOCK = """
import socket
import threading

class Conn:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = socket.socket()

    def fetch(self):
        with self._lock:
            n = 4096
        return self.sock.recv(n)
"""
POLL_HELPER_UNDER_LOCK = """
import queue
import threading

def bounded(q, thread):
    while True:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            if not thread.is_alive():
                raise RuntimeError("source died")

class C:
    def __init__(self):
        self._lock = threading.Lock()

    def fetch(self, q, thread):
        with self._lock:
            return bounded(q, thread)
"""
CONDITION_MONITOR = """
import threading

class C:
    def __init__(self):
        self._cv = threading.Condition()

    def wait_ready(self):
        with self._cv:
            self._cv.wait()
"""
TWO_BLOCKS_ONE_LOCK = """
import socket
import threading
import time

class Conn:
    def __init__(self):
        self._lock = threading.Lock()
        self.sock = socket.socket()

    def fetch(self):
        with self._lock:
            time.sleep(0.1)
            return self.sock.recv(4096)
"""
RECV_SUPPRESSED = RECV_UNDER_LOCK.replace(
    "            return self.sock.recv(4096)",
    "            # gltlint: disable-next=blocking-call-while-holding-lock\n"
    "            return self.sock.recv(4096)")
TYPED_ATTR_UNDER_LOCK = {"pkg.svc": """
    import socket
    import threading

    class Conn:
        def __init__(self):
            self.sock = socket.socket()

        def roundtrip(self):
            return self.sock.recv(64)

    class Owner:
        def __init__(self):
            self._lock = threading.Lock()
            self.conn = Conn()

        def locked_io(self):
            with self._lock:
                return self.conn.roundtrip()
"""}

WRITE_FINAL = """
import json

def save_manifest(path, obj):
    with open(path, "w") as fh:
        json.dump(obj, fh)
"""
WRITE_APPEND_KW = """
def log_artifact(report_path, line):
    with open(report_path, mode="a") as fh:
        fh.write(line)
"""
WRITE_MODULE_LEVEL = """
import json
with open("artifacts/results.json", "w") as fh:
    json.dump({}, fh)
"""
WRITE_TMP_REPLACE = """
import json
import os

def publish(path, obj):
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)
"""
WRITE_TMP_NAMED = """
def scratch(obj):
    with open("/tmp/debug-dump.txt", "w") as fh:
        fh.write(str(obj))
"""
READ_MODES = """
import json

def load(path):
    with open(path) as fh:
        return json.load(fh)

def load_binary(path):
    with open(path, "rb") as fh:
        return fh.read()
"""
WRITE_SHUTIL_MOVE = """
import shutil
import tempfile

def publish(path, text):
    fd, tmp = tempfile.mkstemp()
    with open(tmp, "w") as fh:
        fh.write(text)
    shutil.move(tmp, path)
"""

QUEUE_BARE = """
import queue

def make_buffer():
    return queue.Queue()
"""
QUEUE_ZERO = """
from queue import Queue

buf = Queue(maxsize=0)
lifo = Queue(0)
"""
QUEUE_SIMPLE = """
import queue

q = queue.SimpleQueue()
"""
QUEUE_BOUNDED = """
import queue
from queue import Queue

a = queue.Queue(maxsize=8)
b = Queue(16)
c = queue.LifoQueue(maxsize=4)
d = queue.Queue(maxsize=capacity)   # dynamic bound: trusted
"""
QUEUE_MP = """
import multiprocessing as mp

def make_task_queue(ctx):
    return ctx.Queue()

q = mp.Queue()
"""
QUEUE_SUPPRESSED = """
import queue

q = queue.Queue()  # gltlint: disable=unbounded-queue-put
"""

IO_NP_LOAD = """
import numpy as np

def run_scanned_epoch(step, state, paths):
    for p in paths:
        rows = np.load(p)
        state = step(state, rows)
    return state
"""
IO_MEMMAP = """
import numpy as np

def run_epoch(step, state, batches, path):
    mm = np.memmap(path, dtype=np.float32, mode="r")
    for b in batches:
        state = step(state, mm[b])
    return state
"""
IO_FILE_READ = """
def run_stream_epoch(step, state, fh, n):
    while n > 0:
        raw = fh.read(4096)
        state = step(state, raw)
        n -= 1
    return state
"""
IO_NOT_EPOCH = """
import numpy as np

def _stage(store, ids, out):
    for lo in range(0, len(ids), 1024):
        out[lo:lo + 1024] = np.load(store)[ids[lo:lo + 1024]]
"""
IO_OUTSIDE_LOOP = """
import numpy as np

def run_scanned_epoch(step, state, path, batches):
    rows = np.load(path)      # once, at the epoch boundary
    for b in batches:
        state = step(state, rows[b])
    return state
"""
IO_TRANSITIVE = {
    "pkg.store": """
        import numpy as np

        def load_rows(path, ids):
            return np.load(path)[ids]
    """,
    "pkg.driver": """
        from pkg.store import load_rows

        def run_scanned_epoch(step, state, path, batches):
            for b in batches:
                state = step(state, load_rows(path, b))
            return state
    """,
}
IO_SUPPRESSED = """
import numpy as np

def run_epoch(step, state, path, batches):
    for b in batches:
        # gltlint: disable-next=blocking-io-in-epoch-loop
        rows = np.load(path)
        state = step(state, rows[b])
    return state
"""

WALL_STOPWATCH = """
import time

def measure(fn):
    t0 = time.time()
    fn()
    return time.time() - t0
"""
WALL_NAMED = """
import time

def measure(fn):
    t0 = time.time()
    fn()
    t1 = time.time()
    return t1 - t0
"""
WALL_TIMESTAMP = """
import os
import time

def age_seconds(path):
    return time.time() - os.path.getmtime(path)
"""
WALL_PERF_COUNTER = """
import time

def measure(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0
"""
WALL_SUPPRESSED = """
import time

def measure(fn):
    t0 = time.time()
    fn()
    # gltlint: disable-next=wall-clock-duration
    return time.time() - t0
"""

RETRY_CONST = """
import socket
import time

def fetch(conn):
    while True:
        try:
            return conn.request()
        except (ConnectionResetError, socket.timeout):
            time.sleep(0.5)
"""
RETRY_WAIT_ARITH = """
import time

def fetch(ev, conn):
    for _ in range(5):
        try:
            return conn.request()
        except EOFError:
            ev.wait(2 * 0.25)

def fetch2(conn):
    while True:
        try:
            return conn.request()
        except OSError:
            time.sleep(1 + 0.5)
"""
RETRY_JITTERED = """
import time

def fetch(conn, rng):
    attempt = 0
    while True:
        try:
            return conn.request()
        except OSError:
            attempt += 1
            time.sleep(min(0.5, 0.05 * 2 ** attempt)
                       * (0.5 + 0.5 * rng.random()))

def fetch2(conn, backoff):
    while True:
        try:
            return conn.request()
        except ConnectionError:
            time.sleep(backoff)
"""
RETRY_NOT_NETWORK = """
import time

def heartbeat(stop, probe):
    while not stop.is_set():
        try:
            probe()
        except Exception:
            pass
        stop.wait(1.0)

def spin(work):
    for item in work:
        time.sleep(0.01)

def key_retry(fn):
    while True:
        try:
            return fn()
        except KeyError:
            time.sleep(0.1)
"""
RETRY_SUPPRESSED = """
import time

def fetch(conn):
    while True:
        try:
            return conn.request()
        except OSError:
            time.sleep(0.5)  # gltlint: disable=GLT023
"""

PROTO_SERVER = """
POST_HELLO_OPS = frozenset({"flight_dump"})
_KIND_MSG = 1

def handle(req, conn):
    op = req["op"]
    if op == "ping":
        return {"ok": True, "protocol": 1}
    if op == "flight_dump":
        return {"flight": []}
    if op == "fetch":
        conn.send_frame(_KIND_MSG, b"payload")
        return None
    raise ValueError(op)
"""
PROTO_CLIENT = """
def run(conn):
    conn.request(op="ping", peer="me")
    conn.request(op="fetch", producer_id=1)
    try:
        return conn.request(op="flight_dump")
    except RuntimeError:
        return None
"""
PROTO_CLIENT_NO_FETCH = """
def run(conn):
    conn.request(op="ping", peer="me")
    try:
        conn.request(op="flight_dump")
    except RuntimeError:
        pass
"""
PROTO_DRIFTED = PROTO_CLIENT + """
def drifted(conn):
    try:
        conn.request(op="flight_dumpp")   # renamed server-side
    except RuntimeError:
        pass
"""
PROTO_SERVER_SUPPRESSED = PROTO_SERVER.replace(
    '    if op == "fetch":',
    '    # out-of-tree caller (operator tooling)\n'
    '    # gltlint: disable-next=unmatched-wire-op\n'
    '    if op == "fetch":')
PROTO_SERVER_CODE = PROTO_SERVER + """
def fail(conn, e):
    conn.send({"error": str(e), "code": "weird_fault"})
"""
PROTO_SERVER_GETATTR = PROTO_SERVER + """
def fail(conn, e):
    conn.send({"error": str(e),
               "code": getattr(e, "code", "io_failed")})
"""
PROTO_BARE_GATED = """
def run(conn):
    conn.request(op="ping", peer="me")
    return conn.request(op="flight_dump")   # no fallback
"""
PROTO_DICT_OUTSIDE_TRY = """
def run(conn, millis):
    req = {"op": "flight_dump", "millis": millis}
    try:
        return conn.request(**req)
    except RuntimeError:
        return None
"""
PROTO_PING_ONLY = """
def run(conn):
    return conn.request(op="ping", peer="me")
"""

FIELD_RMW_MISSES_LOCK = """
import threading

class Front:
    def __init__(self):
        self._stats_lock = threading.Lock()
        self._ewma = 0.0
        self._t = threading.Thread(target=self._loop)
        self._t.start()

    def _loop(self):
        while True:
            self._ewma += 0.1

    def stats(self):
        with self._stats_lock:
            return {"ewma": self._ewma}
"""
FIELD_INCONSISTENT = """
import threading

class W:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0
        threading.Thread(target=self._loop).start()

    def _loop(self):
        while True:
            with self._lock:
                self._n += 1

    def bump(self):
        self._n += 1
"""
FIELD_MULTI_DOMAIN = """
import threading

class W:
    def __init__(self):
        self._n = 0
        threading.Thread(target=self._loop).start()

    def _loop(self):
        while True:
            self._n += 1

    def bump(self):
        self._n += 1
"""
FIELD_PUBLISH = """
import threading

class W:
    def __init__(self):
        self._frac = 0.0
        threading.Thread(target=self._loop).start()

    def set_frac(self, f):
        self._frac = float(f)

    def _loop(self):
        while True:
            print(self._frac)
"""
FIELD_COUNTER = """
import threading

class W:
    def __init__(self):
        self.sent = 0
        threading.Thread(target=self._loop).start()

    def _loop(self):
        while True:
            self.sent += 1

    def read(self):
        return self.sent
"""
FIELD_QUEUE = """
import queue
import threading

class W:
    def __init__(self):
        self._q = queue.Queue(maxsize=8)
        threading.Thread(target=self._loop).start()

    def _loop(self):
        while True:
            self._q.put(1, timeout=1.0)

    def drain(self):
        return self._q.get(timeout=1.0)
"""
FIELD_COMMON_LOCK = FIELD_INCONSISTENT.replace(
    "    def bump(self):\n        self._n += 1",
    "    def bump(self):\n        with self._lock:\n            self._n += 1")
FIELD_NO_THREADS = """
class W:
    def __init__(self):
        self._n = 0

    def bump(self):
        self._n += 1
"""
FIELD_SUPPRESSED = FIELD_MULTI_DOMAIN.replace(
    "        while True:\n            self._n += 1",
    "        while True:\n"
    "            # gltlint: disable-next=unguarded-shared-field\n"
    "            self._n += 1")


def _proto(client, server=PROTO_SERVER):
    return {"pkg.server": server, "pkg.client": client}


# (case id, rule code, expected number of that rule's findings, sources)
CASES = [
    ("rng_unseeded", "GLT005", 1, RNG_UNSEEDED),
    ("rng_none", "GLT005", 1, RNG_NONE),
    ("rng_fresh_per_call", "GLT005", 1, RNG_FRESH_PER_CALL),
    ("rng_clean", "GLT005", 0, RNG_CLEAN),
    ("get_bare", "GLT007", 1, GET_BARE),
    ("join_bare", "GLT007", 1, JOIN_BARE),
    ("get_timeout", "GLT007", 0, GET_TIMEOUT),
    ("get_liveness", "GLT007", 0, GET_LIVENESS),
    ("get_argful", "GLT007", 0, GET_ARGFUL),
    ("get_suppressed", "GLT007", 0, GET_SUPPRESSED),
    ("locks_inverted", "GLT008", 1, LOCKS_INVERTED),
    ("locks_cross_module", "GLT008", 1, LOCKS_CROSS_MODULE),
    ("locks_consistent", "GLT008", 0, LOCKS_CONSISTENT),
    ("locks_reentry", "GLT008", 0, LOCKS_REENTRY),
    ("recv_under_lock", "GLT009", 1, RECV_UNDER_LOCK),
    ("helper_under_lock", "GLT009", 1, HELPER_UNDER_LOCK),
    ("sleep_under_module_lock", "GLT009", 1, SLEEP_UNDER_MODULE_LOCK),
    ("typed_attr_under_lock", "GLT009", 1, TYPED_ATTR_UNDER_LOCK),
    ("two_blocks_one_lock", "GLT009", 1, TWO_BLOCKS_ONE_LOCK),
    ("recv_outside_lock", "GLT009", 0, RECV_OUTSIDE_LOCK),
    ("poll_helper_under_lock", "GLT009", 0, POLL_HELPER_UNDER_LOCK),
    ("condition_monitor", "GLT009", 0, CONDITION_MONITOR),
    ("recv_suppressed", "GLT009", 0, RECV_SUPPRESSED),
    ("write_final", "GLT011", 1, WRITE_FINAL),
    ("write_append_kw", "GLT011", 1, WRITE_APPEND_KW),
    ("write_module_level", "GLT011", 1, WRITE_MODULE_LEVEL),
    ("write_tmp_replace", "GLT011", 0, WRITE_TMP_REPLACE),
    ("write_tmp_named", "GLT011", 0, WRITE_TMP_NAMED),
    ("read_modes", "GLT011", 0, READ_MODES),
    ("write_shutil_move", "GLT011", 0, WRITE_SHUTIL_MOVE),
    ("queue_bare", "GLT012", 1, QUEUE_BARE),
    ("queue_zero", "GLT012", 2, QUEUE_ZERO),
    ("queue_simple", "GLT012", 1, QUEUE_SIMPLE),
    ("queue_bounded", "GLT012", 0, QUEUE_BOUNDED),
    ("queue_mp", "GLT012", 0, QUEUE_MP),
    ("queue_suppressed", "GLT012", 0, QUEUE_SUPPRESSED),
    ("io_np_load", "GLT014", 1, IO_NP_LOAD),
    ("io_memmap", "GLT014", 1, IO_MEMMAP),
    ("io_file_read", "GLT014", 1, IO_FILE_READ),
    ("io_transitive", "GLT014", 1, IO_TRANSITIVE),
    ("io_not_epoch", "GLT014", 0, IO_NOT_EPOCH),
    ("io_outside_loop", "GLT014", 0, IO_OUTSIDE_LOOP),
    ("io_suppressed", "GLT014", 0, IO_SUPPRESSED),
    ("wall_stopwatch", "GLT015", 1, WALL_STOPWATCH),
    ("wall_named", "GLT015", 1, WALL_NAMED),
    ("wall_timestamp", "GLT015", 0, WALL_TIMESTAMP),
    ("wall_perf_counter", "GLT015", 0, WALL_PERF_COUNTER),
    ("wall_suppressed", "GLT015", 0, WALL_SUPPRESSED),
    ("retry_const", "GLT023", 1, RETRY_CONST),
    ("retry_wait_arith", "GLT023", 2, RETRY_WAIT_ARITH),
    ("retry_jittered", "GLT023", 0, RETRY_JITTERED),
    ("retry_not_network", "GLT023", 0, RETRY_NOT_NETWORK),
    ("retry_suppressed", "GLT023", 0, RETRY_SUPPRESSED),
    ("op_drifted", "GLT024", 1, _proto(PROTO_DRIFTED)),
    ("op_dead_branch", "GLT024", 1, _proto(PROTO_CLIENT_NO_FETCH)),
    ("op_matched", "GLT024", 0, _proto(PROTO_CLIENT)),
    ("op_client_only", "GLT024", 0, {"pkg.client": PROTO_CLIENT}),
    ("op_suppressed", "GLT024", 0,
     _proto(PROTO_CLIENT_NO_FETCH, PROTO_SERVER_SUPPRESSED)),
    ("code_unrecognized", "GLT025", 1, _proto(PROTO_CLIENT,
                                              PROTO_SERVER_CODE)),
    ("code_set_member", "GLT025", 0, _proto(
        PROTO_CLIENT + '\nFATAL_CODES = frozenset({"weird_fault"})\n',
        PROTO_SERVER_CODE)),
    ("code_typed_exception", "GLT025", 0, _proto(
        PROTO_CLIENT + '\nclass WeirdFault(RuntimeError):\n'
                       '    code = "weird_fault"\n', PROTO_SERVER_CODE)),
    ("code_compared", "GLT025", 0, _proto(
        PROTO_CLIENT + '\ndef classify(resp):\n'
                       '    if resp.get("code") == "weird_fault":\n'
                       '        raise RuntimeError("weird")\n',
        PROTO_SERVER_CODE)),
    ("code_getattr_selector", "GLT025", 0, _proto(
        PROTO_CLIENT + '\nIO_CODES = ("io_failed",)\n',
        PROTO_SERVER_GETATTR)),
    ("gated_bare", "GLT026", 1, _proto(PROTO_BARE_GATED)),
    ("gated_guarded", "GLT026", 0, _proto(PROTO_CLIENT)),
    ("gated_dict_outside_try", "GLT026", 0, _proto(PROTO_DICT_OUTSIDE_TRY)),
    ("gated_protocol0", "GLT026", 0, _proto(PROTO_PING_ONLY)),
    ("field_rmw_misses_lock", "GLT027", 1, {"pkg.front":
                                            FIELD_RMW_MISSES_LOCK}),
    ("field_inconsistent", "GLT027", 1, {"pkg.w": FIELD_INCONSISTENT}),
    ("field_multi_domain", "GLT027", 1, {"pkg.w": FIELD_MULTI_DOMAIN}),
    ("field_publish", "GLT027", 0, {"pkg.w": FIELD_PUBLISH}),
    ("field_counter", "GLT027", 0, {"pkg.w": FIELD_COUNTER}),
    ("field_queue", "GLT027", 0, {"pkg.w": FIELD_QUEUE}),
    ("field_common_lock", "GLT027", 0, {"pkg.w": FIELD_COMMON_LOCK}),
    ("field_no_threads", "GLT027", 0, {"pkg.w": FIELD_NO_THREADS}),
    ("field_suppressed", "GLT027", 0, {"pkg.w": FIELD_SUPPRESSED}),
]


@pytest.mark.parametrize("code,hits,sources", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_rule_fixture_matches_jax(code, hits, sources):
    got = both_findings(sources)
    assert sum(1 for f in got if f[4] == code) == hits, got


def test_every_ported_rule_fires_and_stays_clean():
    for code in PORTED:
        counts = {c[2] for c in CASES if c[1] == code}
        assert 0 in counts and any(n > 0 for n in counts), code


def test_rule_registry_is_the_ported_subset():
    """The registry has every ``glt_tpu`` code, GLT001-GLT027, with its
    name and severity; the 13 framework-free rules keep its description,
    and the others describe their torch forms."""
    jrules = {r.code: r for r in jlint.all_rules()}
    trules = {r.code: r for r in tlint.all_rules()}
    assert sorted(trules) == sorted(jrules) == [
        f"GLT{i:03d}" for i in range(1, 28)]
    for code, j in jrules.items():
        r = trules[code]
        assert (r.name, str(r.severity)) == (j.name, str(j.severity)), code
        if code in PORTED:
            assert r.description == j.description, code
        else:
            assert not any(w in r.description for w in (
                "jax", "jit", "Pallas", "VMEM", "shard_map")), code


SUPPRESSION_SOURCES = [
    "import numpy as np\n\na = np.random.default_rng()  "
    "# gltlint: disable=nondeterministic-default-rng\n",
    "import numpy as np\n\n# gltlint: disable-next=GLT005 -- entropy wanted\n"
    "a = np.random.default_rng()\n",
    "# gltlint: disable-file=nondeterministic-default-rng\nimport numpy as np"
    "\n\na = np.random.default_rng()\nb = np.random.default_rng()\n",
    "x = 1  # gltlint: disable=all\ny = 2  # gltlint: disable = GLT007 , "
    "glt011\n# gltlint: disable-next=a,b,c\nz = 3\n",
    "def f(:\n    pass  # gltlint: disable=GLT007\n",
    "s = '''# gltlint: disable=GLT007'''\n",
]


@pytest.mark.parametrize("i", range(len(SUPPRESSION_SOURCES)))
def test_suppressions_parse_like_jax(i):
    src = SUPPRESSION_SOURCES[i]
    j = jreport.Suppressions.from_source(src)
    t = treport.Suppressions.from_source(src)
    assert (t.by_line, t.whole_file) == (j.by_line, j.whole_file)
    both_findings(src)


def test_parse_error_is_a_finding():
    bad = "def f(:\n    pass\n"
    (got,) = tlint.analyze_source(bad, "broken.py")
    (want,) = jlint.analyze_source(bad, "broken.py")
    assert _key(got) == _key(want) and got.rule == "parse-error"


def test_baseline_round_trip_matches_jax(tmp_path):
    findings = []
    for i, (mod, rep) in enumerate(((jlint, jreport), (tlint, treport))):
        fs = mod.analyze_source(textwrap.dedent(WALL_STOPWATCH + GET_BARE),
                                "a.py")
        findings.append(fs)
        rep.write_baseline(str(tmp_path / f"b{i}.json"), fs)
    assert [_key(f) for f in findings[0]] == [_key(f) for f in findings[1]]
    assert (tmp_path / "b0.json").read_text() == \
        (tmp_path / "b1.json").read_text()
    assert treport.load_baseline(str(tmp_path / "b0.json")) == \
        jreport.load_baseline(str(tmp_path / "b1.json"))
    assert [treport.finding_key(f) for f in findings[1]] == \
        [jreport.finding_key(f) for f in findings[0]]
    fresh, hidden = treport.split_by_baseline(
        findings[1], treport.load_baseline(str(tmp_path / "b1.json")))
    assert fresh == [] and hidden == len(findings[1]) == 2
    (tmp_path / "bad.json").write_text("[]")
    for rep in (jreport, treport):
        with pytest.raises(ValueError, match="not a gltlint baseline"):
            rep.load_baseline(str(tmp_path / "bad.json"))


def test_report_formats_match_jax():
    fs_j = jlint.analyze_source(textwrap.dedent(RETRY_CONST + QUEUE_BARE),
                                "x.py")
    fs_t = tlint.analyze_source(textwrap.dedent(RETRY_CONST + QUEUE_BARE),
                                "x.py")
    for name in ("format_report", "format_json", "format_github"):
        assert getattr(treport, name)(fs_t) == getattr(jreport, name)(fs_j)


def test_effect_engine_matches_jax():
    """Cycles terminate, reachability stops at its depth, a blocking
    effect deeper than MAX_CHAIN_DEPTH is cut off, as in glt_tpu."""
    from glt_tpu.analysis.effects import MAX_CHAIN_DEPTH as JAX_DEPTH

    assert MAX_CHAIN_DEPTH == JAX_DEPTH
    n = MAX_CHAIN_DEPTH + 3
    deep = "\n\n".join(["import time", "def g0():\n    time.sleep(1)"]
                       + [f"def g{i}():\n    g{i - 1}()" for i in range(1, n)])
    chain = "\n\n".join([f"def f{i}(x):\n    return f{i + 1}(x)"
                         for i in range(5)] + ["def f5(x):\n    return x"])
    cyc = """
        import time

        def a(n):
            if n > 0:
                b(n - 1)
            time.sleep(0.1)

        def b(n):
            a(n)
    """
    srcs = {"pkg.deep": deep, "pkg.chain": chain, "pkg.cyc": cyc,
            **LOCKS_CROSS_MODULE, **TYPED_ATTR_UNDER_LOCK}
    je = _project(JModuleInfo, JProject, srcs).effects
    te = _project(TModuleInfo, TProject, srcs).effects
    assert sorted(te.summaries) == sorted(je.summaries)
    for fid, s in je.summaries.items():
        t = te.summaries[fid]
        assert [tuple(vars(b).values()) for b in t.blocking] == \
            [tuple(vars(b).values()) for b in s.blocking], fid
        assert (t.acquires, t.liveness) == (s.acquires, s.liveness), fid
    assert {k: tuple(vars(v).values()) for k, v in te.pairs.items()} == \
        {k: tuple(vars(v).values()) for k, v in je.pairs.items()}
    assert te.graph.sccs() == je.graph.sccs()
    assert te.graph.reachable("pkg.chain.f0", max_depth=2) == {
        "pkg.chain.f0": 0, "pkg.chain.f1": 1, "pkg.chain.f2": 2}
    assert te.summaries["pkg.deep.g0"].blocking
    assert not te.summaries[f"pkg.deep.g{n - 1}"].blocking
    for fid in ("pkg.cyc.a", "pkg.cyc.b"):
        assert te.summaries[fid].blocking


def test_op_table_matches_jax():
    srcs = _proto(PROTO_CLIENT + PROTO_DICT_OUTSIDE_TRY.replace(
        "def run(", "def run2("))
    jt = jop_table(_project(JModuleInfo, JProject, srcs))
    tt = top_table(_project(TModuleInfo, TProject, srcs))
    assert sorted(tt.ops) == sorted(jt.ops) == ["fetch", "flight_dump",
                                                "ping"]
    assert tt.protocol == jt.protocol == 1
    for op in jt.ops:
        j, t = jt.ops[op], tt.ops[op]
        assert (t.min_protocol, t.frame, t.request_keys, t.response_keys) \
            == (j.min_protocol, j.frame, j.request_keys, j.response_keys)
    assert tformat_table(tt) == jformat_table(jt)


# -- the whole port -----------------------------------------------------------

def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def port_projects():
    """Each linter's project of the port and the smoke, built once."""
    paths = [os.path.join(REPO, "glt_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    jp, jerr = jbuild(paths)
    tp, terr = tbuild(paths)
    assert jerr == [] and terr == []
    return jp, tp


def test_whole_port_unsuppressed_matches_jax(port_projects):
    """With the suppressions off, both linters report the same justified
    sites over the port and the smoke."""
    jp, tp = port_projects
    jrules = [r for r in jlint.all_rules() if r.code in PORTED]
    want = _ported(jlint.analyze_project(jp, jrules, suppress=False))
    got = _ported(tlint.analyze_project(tp, suppress=False))
    assert got == want
    codes = {f[4] for f in got}
    assert {"GLT007", "GLT009", "GLT024"} <= codes, got


def test_whole_port_cli_matches_jax():
    """``python -m glt_tpu.analysis glt_tpu_torch --select=<13 codes>``
    and the port's CLI over ``glt_tpu_torch`` give equal findings."""
    want = _cli("glt_tpu.analysis", "glt_tpu_torch",
                "--select=" + ",".join(PORTED), "--format", "json")
    got = _cli("glt_tpu_torch.analysis", "glt_tpu_torch", "--format", "json")
    assert json.loads(got.stdout) == json.loads(want.stdout)
    assert got.returncode == want.returncode


# ROADMAP queue C, C4: the torch-form rules' first findings over the port
# and the smoke that carry a justified suppression (the repaired ones are
# gone), as (path, line, code).
C4_JUSTIFIED = sorted([
    ("chip_smoke.py", 894, "GLT004"),
    ("chip_smoke.py", 906, "GLT004"),
    ("chip_smoke.py", 956, "GLT022"),
    ("chip_smoke.py", 1580, "GLT002"),
    ("chip_smoke.py", 2784, "GLT002"),
    ("chip_smoke.py", 5083, "GLT002"),
    ("chip_smoke.py", 5203, "GLT002"),
    ("chip_smoke.py", 7397, "GLT004"),
    ("chip_smoke.py", 7410, "GLT022"),
    ("glt_tpu_torch/examples/datasets.py", 38, "GLT004"),
    ("glt_tpu_torch/examples/datasets.py", 38, "GLT004"),
    ("glt_tpu_torch/examples/datasets.py", 60, "GLT004"),
    ("glt_tpu_torch/examples/datasets.py", 60, "GLT004"),
    ("glt_tpu_torch/models/train.py", 227, "GLT004"),
    ("glt_tpu_torch/models/train.py", 896, "GLT013"),
    ("glt_tpu_torch/ops/fused_frontier.py", 64, "GLT004"),
    ("glt_tpu_torch/ops/subgraph.py", 60, "GLT004"),
    ("glt_tpu_torch/parallel/dist_train.py", 579, "GLT013"),
    ("glt_tpu_torch/parallel/sharding.py", 94, "GLT004"),
    ("glt_tpu_torch/partition/dist_random_partitioner.py", 33, "GLT004"),
    ("glt_tpu_torch/serving/engine.py", 145, "GLT004"),
])
TORCH_FORMS = ("GLT001", "GLT002", "GLT003", "GLT004", "GLT006", "GLT010",
               "GLT013", "GLT016", "GLT018", "GLT020", "GLT021", "GLT022",
               "GLT026")


def test_c4_findings_are_the_recorded_ones(port_projects):
    """With the suppressions off, the torch-form rules (and GLT026, now
    that the server declares ``POST_HELLO_OPS``) find over the port and
    the smoke exactly the sites C4 records as justified."""
    _, tp = port_projects
    got = sorted((os.path.relpath(f.path, REPO).replace(os.sep, "/"),
                  f.line, f.code)
                 for f in tlint.analyze_project(tp, suppress=False)
                 if f.code in TORCH_FORMS)
    assert got == C4_JUSTIFIED


def test_port_gate_is_clean():
    """The gate: the port and the smoke lint clean."""
    proc = _cli("glt_tpu_torch.analysis", "glt_tpu_torch", "chip_smoke.py")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gltlint: 0 error(s), 0 warning(s)" in proc.stdout


# -- the CLI's flags ----------------------------------------------------------

def test_cli_flags_a_violation_in_each_format(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GET_BARE))
    proc = _cli("glt_tpu_torch.analysis", str(bad))
    assert proc.returncode == 1 and "GLT007" in proc.stdout
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--format=json")
    (f,) = json.loads(proc.stdout)["findings"]
    assert f["code"] == "GLT007" and f["severity"] == "error"
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--format=github")
    assert "::error file=" in proc.stdout and "title=GLT007" in proc.stdout
    assert _cli("glt_tpu_torch.analysis", str(bad),
                "--ignore=GLT007").returncode == 0


def test_cli_warnings_pass_unless_strict(tmp_path):
    warn = tmp_path / "warn.py"
    warn.write_text(textwrap.dedent(RNG_UNSEEDED))
    proc = _cli("glt_tpu_torch.analysis", str(warn))
    assert proc.returncode == 0 and "1 warning(s)" in proc.stdout
    assert _cli("glt_tpu_torch.analysis", str(warn),
                "--strict").returncode == 1


def test_cli_list_rules_and_single_rule_mode(tmp_path):
    proc = _cli("glt_tpu_torch.analysis", "--list-rules")
    assert proc.returncode == 0
    for code in PORTED:
        assert code in proc.stdout
    for code in LAUNCH:
        assert code in proc.stdout
    for code in ("GLT001", "GLT018", "GLT022"):
        assert code in proc.stdout
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GET_BARE + WALL_STOPWATCH))
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--rule=GLT015",
                "--profile")
    assert proc.returncode == 1 and "GLT015" in proc.stdout
    assert "GLT007" not in proc.stdout and "total" in proc.stderr
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--rule=GLT007,GLT015")
    assert proc.returncode == 2 and "exactly one rule" in proc.stderr
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--rule=GLT007",
                "--select=GLT015")
    assert proc.returncode == 2 and "mutually exclusive" in proc.stderr
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--select=GLT001")
    assert proc.returncode == 0 and "0 error(s)" in proc.stdout
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--select=GLT099")
    assert proc.returncode != 0 and "unknown rule" in proc.stderr
    proc = _cli("glt_tpu.analysis", str(bad), "--select=GLT099")
    assert proc.returncode != 0 and "unknown rule" in proc.stderr


def test_cli_baseline(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GET_BARE))
    baseline = tmp_path / "baseline.json"
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--write-baseline",
                str(baseline))
    assert proc.returncode == 0 and baseline.exists()
    bad.write_text("UNRELATED = 1\n\n" + textwrap.dedent(GET_BARE))
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--baseline",
                str(baseline))
    assert proc.returncode == 0, proc.stdout
    assert "baselined finding(s) hidden" in proc.stdout
    bad.write_text(bad.read_text() + textwrap.dedent(WALL_STOPWATCH))
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--baseline",
                str(baseline))
    assert proc.returncode == 1 and "GLT015" in proc.stdout
    assert "GLT007" not in proc.stdout
    proc = _cli("glt_tpu_torch.analysis", str(bad), "--baseline",
                str(tmp_path / "nope.json"))
    assert proc.returncode == 2


def test_cli_changed_mode_slices_to_dirty_files(tmp_path):
    def git(*args):
        subprocess.run(["git", "-c", "user.name=t",
                        "-c", "user.email=t@t.invalid", *args],
                       cwd=tmp_path, check=True, capture_output=True)

    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(GET_BARE))
    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    (tmp_path / "clean.py").write_text("x = 1\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "glt_tpu_torch.analysis", str(bad),
             str(tmp_path / "clean.py"), *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=300)

    proc = run()
    assert proc.returncode == 1 and "GLT007" in proc.stdout
    proc = run("--changed", "--profile")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "incremental slice: 1 changed file(s)" in proc.stderr
    bad.write_text(bad.read_text() + "\n# touched\n")
    proc = run("--since=HEAD")
    assert proc.returncode == 1 and "GLT007" in proc.stdout


def test_cli_optable_lists_the_port_wire_ops(port_projects):
    jp, tp = port_projects
    got = _cli("glt_tpu_torch.analysis", "glt_tpu_torch", "chip_smoke.py",
               "--format=optable")
    assert got.returncode == 0
    assert got.stdout.strip() == tformat_table(top_table(tp)) == \
        jformat_table(jop_table(jp))
    for op in ("fetch_one_sampled_message", "subgraph_request",
               "fleet_shed", "heartbeat"):
        assert f"`{op}`" in got.stdout, op


def test_optable_gates_the_post_hello_ops_like_jax(port_projects):
    """The server declares ``POST_HELLO_OPS``: the port's op table gives
    the four gated ops the minimum protocol ``glt_tpu``'s gives them over
    ``glt_tpu``."""
    from glt_tpu_torch.distributed import dist_server

    _, tp = port_projects
    jp, jerr = jbuild([os.path.join(REPO, "glt_tpu")])
    assert jerr == []
    jt, tt = jop_table(jp), top_table(tp)
    gated = sorted(dist_server.POST_HELLO_OPS)
    assert gated == ["fleet_hello", "fleet_shed", "flight_dump",
                     "profile_capture"]
    for op in gated:
        assert tt.ops[op].min_protocol == jt.ops[op].min_protocol == 1, op
    assert {op for op, e in tt.ops.items() if e.min_protocol > 0} == \
        set(gated)


def test_bare_fleet_shed_fires_against_the_real_server():
    """A client that sends ``fleet_shed`` outside the unknown-op ``try``
    fires GLT026 against the port's own server module."""
    server = os.path.join(REPO, "glt_tpu_torch", "distributed",
                          "dist_server.py")
    client = textwrap.dedent("""
        def shed(conn, alert):
            conn.request(op="heartbeat", peer="me")
            return conn.request(op="fleet_shed", alert=alert)  # no fallback


        def guarded(conn, alert):
            try:
                return conn.request(op="fleet_shed", alert=alert)
            except RuntimeError:
                return None
    """)
    project = TProject([
        TModuleInfo(server, open(server, encoding="utf-8").read(),
                    module_name="glt_tpu_torch.distributed.dist_server"),
        TModuleInfo("pkg/client.py", client, module_name="pkg.client")])
    got = [(f.path, f.line) for f in tlint.analyze_project(project)
           if f.code == "GLT026"]
    assert got == [("pkg/client.py", 4)]


# -- the launch model (GLT017, GLT019) ------------------------------------------
LAUNCH_CLEAN = """
CANDIDATE_THREADS = (128, 256, 512)
LAUNCH_MODEL_DOMAIN = {
    "threads": CANDIDATE_THREADS,
    "blocks_per_sm": (8, 16),
    "vec_bytes": (4, 8, 16),
}
"""
LAUNCH_B1 = """
KEY_BYTES = 8
MAX_FANOUT = {fanout}
LAUNCH_MODEL_DOMAIN = {{
    "threads": (256,),
    "lanes": (1, 2, 4, 8, 16, 32),
    "fanout": MAX_FANOUT,
    "replace": (False, True),
    "by_id": (False, True),
}}


def dynamic_smem_bytes(fanout, replace, by_id):
    \"\"\"Step keys in shared memory.\"\"\"
    return 0 if by_id else KEY_BYTES * (2 if replace else 2 * fanout)
"""
LAUNCH_CASES = [
    # (id, source, GLT017 hits, GLT019 hits, a word of the message)
    ("clean", LAUNCH_CLEAN, 0, 0, None),
    ("threads_2048", LAUNCH_CLEAN.replace("512)", "2048)"), 1, 0, "2048"),
    ("vector_32_bytes", LAUNCH_CLEAN.replace("16),\n}", "32),\n}"), 0, 1,
     "[32]"),
    ("threads_off_warp", LAUNCH_CLEAN.replace("128,", "100,"), 0, 1,
     "[100]"),
    ("b1_fanout_2048", LAUNCH_B1.format(fanout=2048), 0, 0, None),
    ("b1_fanout_8192", LAUNCH_B1.format(fanout=8192), 1, 0, "131072"),
    ("lanes_48", LAUNCH_B1.format(fanout=64).replace("32)", "48)"), 0, 1,
     "[48]"),
    ("unbounded_entry", LAUNCH_CLEAN.replace("(8, 16)", "per_sm()"), 1, 0,
     "cannot bound"),
    ("unbounded_helper_param", LAUNCH_B1.format(fanout=64).replace(
        '    "by_id": (False, True),\n', ""), 1, 0, "by_id"),
    ("no_domain", "THREADS = 4096\n", 0, 0, None),
]


@pytest.mark.parametrize("src,n17,n19,word",
                         [c[1:] for c in LAUNCH_CASES],
                         ids=[c[0] for c in LAUNCH_CASES])
def test_launch_model_fixtures(src, n17, n19, word):
    got = tlint.analyze_source(textwrap.dedent(src), "kern.py")
    codes = [f.code for f in got]
    assert codes.count("GLT017") == n17 and codes.count("GLT019") == n19, \
        got
    assert len(got) == n17 + n19, got
    if word is not None:
        assert any(word in f.message for f in got), got


def test_launch_model_reads_the_limits_module():
    """A limit edited in ops/cuda_limits.py re-checks every point."""
    lim = "MAX_THREADS_PER_BLOCK = 256\nWARP = 32\n"
    project = TProject([
        TModuleInfo("pkg/ops/cuda_limits.py", lim,
                    module_name="pkg.ops.cuda_limits"),
        TModuleInfo("pkg/ops/kern.py", textwrap.dedent(LAUNCH_CLEAN),
                    module_name="pkg.ops.kern")])
    got = tlint.analyze_project(project)
    assert [f.code for f in got] == ["GLT017"], got
    assert "[512]" in got[0].message


def test_launch_model_resolves_the_port_domains(port_projects):
    """The port's swept modules resolve whole: every axis bounded, B1's
    shared memory evaluated at every mode, and no finding."""
    from glt_tpu_torch.analysis import kernelmodel
    from glt_tpu_torch.ops import gather_cuda, sample_cuda

    _, tp = port_projects
    for mod in (gather_cuda, sample_cuda):
        m = kernelmodel._model(tp.modules[mod.__name__], tp)
        assert m.unbounded == []
        assert {k: tuple(v) for k, v in m.axes.items()} == {
            k: v if isinstance(v, tuple) else (v,)
            for k, v in mod.LAUNCH_MODEL_DOMAIN.items()}
    m = kernelmodel._model(tp.modules[sample_cuda.__name__], tp)
    assert sorted(m.smem) == sorted({sample_cuda.dynamic_smem_bytes(
        sample_cuda.MODEL_MAX_FANOUT, r, i) for r in (False, True)
        for i in (False, True)}) == [0, 16, 32768]
    got = [f for f in tlint.analyze_project(tp, suppress=False)
           if f.code in LAUNCH]
    assert got == []
