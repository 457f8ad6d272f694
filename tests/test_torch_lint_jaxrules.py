"""gltlint's JAX-named rules in their torch forms, held to ``glt_tpu``'s.

Each of the 12 codes that name JAX, Pallas or shard_map in ``glt_tpu``
(GLT001-004, 006, 010, 013, 016, 018, 020-022) has positive and
calibrated-negative cases taken from ``tests/test_analysis.py``: the JAX
source beside its torch spelling, laid out line for line, so that
``glt_tpu.analysis.analyze_source`` on the one and
``glt_tpu_torch.analysis.analyze_source`` on the other give equal
``(code, name, severity, line)`` lists.  GLT018's torch spelling is CUDA
text (the port's rings live in ``csrc/``).  Each code also has cases of
the shapes only the torch form has (``with torch.cuda.graph``, a class
that hands its argument to a capture, ``.to(torch.int32)``, a
``torch.profiler`` object, ``mbarrier`` rings, rank-local predicates),
whose lines are asserted directly.  The four hazard programs of
``chip_smoke.py`` phase 20 (``glt_tpu_torch/analysis/hazards.py``) are
flagged with their codes at their marked lines.
"""
import textwrap

import pytest

import glt_tpu.analysis as jlint
import glt_tpu_torch.analysis as tlint
from glt_tpu_torch.analysis import hazards
from glt_tpu_torch.analysis.symbols import Project as TProject
from glt_tpu_torch.analysis.visitor import ModuleInfo as TModuleInfo

JAX_RULES = ("GLT001", "GLT002", "GLT003", "GLT004", "GLT006", "GLT010",
             "GLT013", "GLT016", "GLT018", "GLT020", "GLT021", "GLT022")

PALLAS_HEADER = """
        import jax
        import jax.numpy as jnp
        from jax import lax
        from jax.experimental import pallas as pl
        from jax.experimental.pallas import tpu as pltpu
"""
DMA_POS = PALLAS_HEADER + """
        def make_kernel(nbuf):
            def kernel(idx_ref, x_ref, o_ref, buf, sems):
                def dma(j):
                    return pltpu.make_async_copy(
                        x_ref.at[pl.ds(j, 1)], buf.at[pl.ds(j, 1)],
                        sems.at[lax.rem(j, nbuf)])

                def body(j, c):
                    @pl.when(idx_ref[j] >= 0)
                    def _():
                        dma(j).start()

                    dma(j).wait()
                    return c

                lax.fori_loop(0, 8, body, None)
            return kernel
    """
# Line for line with DMA_POS: the guarded commit on line 18, the
# unguarded wait on line 20.
CUDA_POS = """
        // A ring of cp.async copies, one row a stage.
        #include <cuda_pipeline.h>
        constexpr int RING = 2;




        __global__ void gather_ring(const int* idx, const float* x,
                                    float* out) {
            __shared__ float buf[RING][128];
            int t = threadIdx.x;


            for (int j = 0; j < 8; ++j) {
                if (idx[j] >= 0) {
                    __pipeline_memcpy_async(&buf[j % RING][t], &x[j * 128 + t], 4);
                    __pipeline_commit();
                }
                __pipeline_wait_prior(0);
                out[j * 128 + t] = buf[j % RING][t];
            }
        }
    """
CUDA_SYMMETRIC = CUDA_POS.replace(
    "                __pipeline_wait_prior(0);",
    "                if (idx[j] >= 0) { __pipeline_wait_prior(0); }")
DMA_NO_WAIT = PALLAS_HEADER + """
        def make_kernel(nbuf):
            def kernel(x_ref, o_ref, buf, sems):
                def dma(j):
                    return pltpu.make_async_copy(
                        x_ref.at[pl.ds(j, 1)], buf.at[pl.ds(j, 1)],
                        sems.at[j])

                dma(0).start()
                o_ref[...] = buf[...]
            return kernel
    """
CUDA_NO_WAIT = """
        #include <cuda_pipeline.h>
        // cp.async without a wait: the commit on line 15.




        __global__ void fill(const float* x, float* out) {
            __shared__ float buf[128];
            int t = threadIdx.x;
            __pipeline_memcpy_async(&buf[t], &x[t], 4);



            __pipeline_commit();
            out[t] = buf[t];
        }
    """

# (id, code, JAX source, torch source)
PAIRS = [
    # -- GLT001 host-sync-in-jit ------------------------------------------
    ("glt001_asarray_on_traced", "GLT001", """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            return np.asarray(x) + 1
        """, """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def f(x):
            return x.cpu() + 1
        PROG = CapturedProgram(f, [torch.zeros(4)])
        """),
    ("glt001_item_in_wrapped_method", "GLT001", """
        import jax

        class S:
            def __init__(self):
                self._fn = jax.jit(self._impl)

            def _impl(self, ids):
                return ids.sum().item()
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        class S:
            def __init__(self, buf):
                self._fn = CapturedProgram(self._impl, [buf])

            def _impl(self, ids):
                return ids.sum().item()
        """),
    ("glt001_int_on_traced_param", "GLT001", """
        import jax

        @jax.jit
        def f(x):
            n = int(x)
            return n
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def f(x):
            n = int(x)
            return n
        PROG = CapturedProgram(f, [BUF])
        """),
    ("glt001_host_side_and_static", "GLT001", """
        import jax
        import numpy as np

        def host_stage(ids):
            return np.asarray(ids)          # not a jit context

        @jax.jit
        def f(x):
            b = int(x.shape[0])             # .shape is static under jit
            return x * b

        @jax.jit
        def g(x, n):
            return x + np.float32(1.0)      # constant, no traced operand
        """, """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def host_stage(ids):
            return ids.cpu()                # not a captured context


        def f(x):
            b = int(x.shape[0])             # .shape is a host int
            return x * b
        F = CapturedProgram(f, [torch.zeros(4)])

        def g(x, n):
            return x + float(1.0)           # constant, no device operand
        G = CapturedProgram(g, [torch.zeros(4), torch.zeros(1)])
        """),
    ("glt001_helper_with_static_args", "GLT001", """
        import jax

        def cap(width, load):
            return int(round(load * width))

        @jax.jit
        def f(x):
            c = cap(4, 2.0)
            return x[:c]
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def cap(width, load):
            return int(round(load * width))


        def f(x):
            c = cap(4, 2.0)
            return x[:c]
        PROG = CapturedProgram(f, [BUF])
        """),
    ("glt001_helper_with_traced_arg", "GLT001", """
        import jax
        import numpy as np

        def helper(v):
            return np.asarray(v)

        @jax.jit
        def f(x):
            return helper(x * 2)
        """, """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def helper(v):
            return v.tolist()


        def f(x):
            return helper(x * 2)
        PROG = CapturedProgram(f, [torch.zeros(4)])
        """),
    # -- GLT002 prng-key-reuse --------------------------------------------
    ("glt002_double_draw", "GLT002", """
        import jax

        def sample(key):
            a = jax.random.uniform(key, (4,))
            b = jax.random.normal(key, (4,))
            return a + b
        """, """
        from glt_tpu_torch import random

        def sample(key):
            a = random.uniform(key, (4,))
            b = random.randint(key, (4,), 0, 9)
            return a + b
        """),
    ("glt002_reuse_after_local_key", "GLT002", """
        import jax

        def sample(x):
            k = jax.random.PRNGKey(0)
            a = jax.random.uniform(k, (4,))
            b = jax.random.uniform(k, (4,))
            return a + b
        """, """
        from glt_tpu_torch import random

        def sample(x):
            k = random.PRNGKey(0)
            a = random.uniform(k, (4,))
            b = random.uniform(k, (4,))
            return a + b
        """),
    ("glt002_split_and_fold_in", "GLT002", """
        import jax

        def sample(key):
            k1, k2 = jax.random.split(key)
            a = jax.random.uniform(k1, (4,))
            b = jax.random.normal(k2, (4,))
            for i in range(3):
                ki = jax.random.fold_in(key, i)   # deriving is fine
                b = b + jax.random.uniform(ki, (4,))
            return a + b
        """, """
        from glt_tpu_torch import random

        def sample(key):
            k1, k2 = random.split(key)
            a = random.uniform(k1, (4,))
            b = random.randint(k2, (4,), 0, 9)
            for i in range(3):
                ki = random.fold_in(key, i)       # deriving is fine
                b = b + random.uniform(ki, (4,))
            return a + b
        """),
    ("glt002_branches_use_once_each", "GLT002", """
        import jax

        def sample(key, flag):
            if flag:
                return jax.random.uniform(key, (4,))
            else:
                return jax.random.normal(key, (4,))
        """, """
        from glt_tpu_torch import random

        def sample(key, flag):
            if flag:
                return random.uniform(key, (4,))
            else:
                return random.bits(key, (4,))
        """),
    ("glt002_reassignment_resets", "GLT002", """
        import jax

        def sample(key):
            a = jax.random.uniform(key, (4,))
            key = jax.random.fold_in(key, 1)
            b = jax.random.uniform(key, (4,))
            return a + b
        """, """
        from glt_tpu_torch import random

        def sample(key):
            a = random.uniform(key, (4,))
            key = random.fold_in(key, 1)
            b = random.uniform(key, (4,))
            return a + b
        """),
    # -- GLT003 recompile-hazard ------------------------------------------
    ("glt003_closure_over_scalar", "GLT003", """
        import jax

        def build(x):
            n = x.shape[0]
            fn = jax.jit(lambda a: a * n)
            return fn
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def build(x):
            n = x.shape[0]
            fn = CapturedProgram(lambda a: a * n, [x])
            return fn
        """),
    ("glt003_nested_def_capture", "GLT003", """
        import jax

        def build(batches):
            width = len(batches)

            def body(a):
                return a + width

            return jax.jit(body)
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def build(batches):
            width = len(batches)

            def body(a):
                return a + width

            return CapturedProgram(body, [batches[0]])
        """),
    ("glt003_static_or_keyed", "GLT003", """
        import jax

        def build(x):
            n = x.shape[0]
            fn = jax.jit(lambda a, m: a * m, static_argnums=(1,))
            return fn, n
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def build(x, progs):
            n = x.shape[0]
            fn = progs[n] = CapturedProgram(lambda a: a * n, [x])
            return fn, n
        """),
    ("glt003_no_scalar_capture", "GLT003", """
        import jax
        import jax.numpy as jnp

        def build(rows):
            table = jnp.asarray(rows, jnp.float32)   # array capture: fine
            return jax.jit(lambda ids: table[ids])
        """, """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def build(rows, ids):
            table = torch.as_tensor(rows)            # tensor capture: fine
            return CapturedProgram(lambda i: table[i], [ids])
        """),
    # -- GLT004 int64-id-truncation ---------------------------------------
    ("glt004_astype_flow", "GLT004", """
        import numpy as np
        import jax.numpy as jnp

        def load(ids):
            ids64 = np.asarray(ids).astype(np.int64)
            return jnp.asarray(ids64)
        """, """
        import numpy as np
        import torch

        def load(ids):
            ids64 = np.asarray(ids).astype(np.int64)
            return torch.from_numpy(ids64).to(torch.int32)
        """),
    ("glt004_dtype_kwarg_source", "GLT004", """
        import numpy as np
        import jax.numpy as jnp

        def load(n):
            eids = np.arange(n, dtype=np.int64)
            return jnp.array(eids)
        """, """
        import numpy as np
        import torch

        def load(n):
            eids = np.arange(n, dtype=np.int64)
            return torch.as_tensor(eids, dtype=torch.int32)
        """),
    ("glt004_explicit_dtype_or_checked", "GLT004", """
        import numpy as np
        import jax.numpy as jnp

        def load(ids):
            ids64 = np.asarray(ids).astype(np.int64)
            a = jnp.asarray(ids64, jnp.int32)        # positional dtype
            b = jnp.asarray(ids64, dtype=jnp.int32)  # keyword dtype
            mask = ids64 >= 0                        # bool, not ids
            return a, b, jnp.asarray(mask)
        """, """
        import numpy as np
        import torch

        def load(ids):
            ids64 = np.asarray(ids).astype(np.int64)
            if ids64.size and ids64.max() > 2**31 - 1:
                raise ValueError("ids past int32")   # the range check
            a = ids64.astype(np.int32)
            return a, torch.from_numpy(ids64).int()
        """),
    # -- GLT006 shadowed-jit-donation -------------------------------------
    ("glt006_use_after_rewrite", "GLT006", """
        import jax

        step = jax.jit(lambda s, b: s + b, donate_argnums=(0,))

        def train(state, batch):
            out = step(state, batch)
            return out + state.sum()     # state's buffer is gone
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        step = CapturedProgram(lambda s, b: s + b, BUFFERS)

        def train(state, batch):
            out = step(state, batch); nxt = step(batch, state)
            return out + nxt.sum()       # out was rewritten by nxt's call
        """),
    ("glt006_decorated_or_replay", "GLT006", """
        from functools import partial
        import jax

        @partial(jax.jit, donate_argnums=(1,))
        def step(state, scratch):
            return state + scratch

        def loop(state, scratch):
            state = step(state, scratch)
            return state, scratch.shape  # read after donate
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def make(table, ids):
            return CapturedProgram(lambda i: table[i], [ids])


        def loop(table, ids):
            prog = CapturedProgram(lambda i: table[i], [ids]); rows = prog()
            prog.replay(); return rows   # read after a replay
        """),
    ("glt006_reassigned_from_result", "GLT006", """
        import jax

        step = jax.jit(lambda s, b: s + b, donate_argnums=(0,))

        def train(state, batches):
            for b in batches:
                state = step(state, b)   # donated then rebound
            return state
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        step = CapturedProgram(lambda s, b: s + b, BUFFERS)

        def train(state, batches):
            for b in batches:
                state = step(state, b)   # called then rebound
            return state
        """),
    ("glt006_cloned_or_consumed", "GLT006", """
        import jax

        step = jax.jit(lambda s, b: s + b, donate_argnums=(0,))

        def train(state, batch):
            out = step(state, batch)
            return out + batch.sum()     # batch was not donated
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram

        step = CapturedProgram(lambda s, b: s + b, BUFFERS)

        def train(state, batch):
            out = step(state, batch).clone(); step(batch, state)
            return out + batch.sum()     # a clone is the caller's own
        """),
    # -- GLT010 span-in-traced-code ---------------------------------------
    ("glt010_span_and_counter", "GLT010", """
        import jax
        from glt_tpu.obs.trace import span
        from glt_tpu.obs import metrics

        _M_STEPS = metrics.counter("glt.x.steps", "steps")

        @jax.jit
        def step(x):
            with span("step"):            # vanishes under trace
                _M_STEPS.inc()            # counts compilations, not calls
                return x + 1
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram
        from glt_tpu_torch.obs.trace import span
        from glt_tpu_torch.obs import metrics

        _M_STEPS = metrics.counter("glt.x.steps", "steps")


        def step(x):
            with span("step"):            # runs once, at the capture
                _M_STEPS.inc()            # counts captures, not calls
                return x + 1
        PROG = CapturedProgram(step, [BUF])
        """),
    ("glt010_nested_def", "GLT010", """
        import jax
        from glt_tpu.obs.trace import span

        @jax.jit
        def outer(x):
            def body(y):
                with span("inner"):
                    return y + 1
            return body(x)
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram
        from glt_tpu_torch.obs.trace import span


        def outer(x):
            def body(y):
                with span("inner"):
                    return y + 1
            return body(x)
        PROG = CapturedProgram(outer, [BUF])
        """),
    ("glt010_host_loop", "GLT010", """
        import jax
        from glt_tpu.obs.trace import span
        from glt_tpu.obs import metrics

        _M_STEPS = metrics.counter("glt.x.steps", "steps")

        @jax.jit
        def step(x):
            return x + 1

        def epoch(batches):
            for b in batches:             # host loop: the right boundary
                with span("step") as sp:
                    out = step(b)
                    sp.fence(out)
                _M_STEPS.inc()
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram
        from glt_tpu_torch.obs.trace import span
        from glt_tpu_torch.obs import metrics

        _M_STEPS = metrics.counter("glt.x.steps", "steps")


        def step(x):
            return x + 1
        PROG = CapturedProgram(step, [BUF])

        def epoch(batches):
            for b in batches:             # host loop: the right boundary
                with span("step") as sp:
                    out = PROG(b)
                    sp.fence(out)
                _M_STEPS.inc()
        """),
    ("glt010_non_obs_receiver", "GLT010", """
        import jax

        @jax.jit
        def step(counter, x):
            counter.inc()                 # unknown receiver: not flagged
            return x
        """, """
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def step(counter, x):
            counter.inc()                 # unknown receiver: not flagged
            return x
        PROG = CapturedProgram(step, [BUF, BUF])
        """),
    # -- GLT013 dispatch-in-epoch-loop ------------------------------------
    ("glt013_fetch_in_loop", "GLT013", """
        import jax

        def run_scanned_epoch(step, state, blocks):
            losses = []
            for blk in blocks:
                state, loss = step(state, blk)
                losses.append(float(jax.device_get(loss)))
            return state, losses
        """, """
        import torch

        def run_scanned_epoch(step, state, blocks):
            losses = []
            for blk in blocks:
                state, loss = step(state, blk)
                losses.append(float(loss.cpu()))
            return state, losses
        """),
    ("glt013_asarray_and_item", "GLT013", """
        import numpy as np

        def _run_epoch(step, state, batches):
            out = []
            for b in batches:
                state, loss = step(state, b)
                out.append(np.asarray(loss))
                print(loss.item())
            return out
        """, """
        import torch

        def _run_epoch(step, state, batches):
            out = []
            for b in batches:
                state, loss = step(state, b)
                out.append(loss.numpy())
                print(loss.item())
            return out
        """),
    ("glt013_block_until_ready_in_while", "GLT013", """
        import jax

        def run_pipelined_epoch(step, state, it):
            while True:
                b = next(it, None)
                if b is None:
                    break
                state, loss = step(state, b)
                jax.block_until_ready(loss)
            return state
        """, """
        import torch

        def run_pipelined_epoch(step, state, it):
            while True:
                b = next(it, None)
                if b is None:
                    break
                state, loss = step(state, b)
                torch.cuda.synchronize()
            return state
        """),
    ("glt013_fetch_after_loop", "GLT013", """
        import jax
        import jax.numpy as jnp
        import numpy as np

        def run_scanned_epoch(step, state, blocks):
            losses = []
            for blk in blocks:
                state, loss = step(state, blk)
                losses.append(loss)
            return state, np.asarray(jax.device_get(
                jnp.concatenate(losses)))
        """, """
        import torch


        def run_scanned_epoch(step, state, blocks):
            losses = []
            for blk in blocks:
                state, loss = step(state, blk)
                losses.append(loss)
            return state, torch.cat(losses).cpu().numpy()
        """),
    ("glt013_non_epoch_function", "GLT013", """
        import numpy as np

        def collect_all(step, state, batches):
            out = []
            for b in batches:
                state, loss = step(state, b)
                out.append(np.asarray(loss))
            return out
        """, """
        import torch

        def collect_all(step, state, batches):
            out = []
            for b in batches:
                state, loss = step(state, b)
                out.append(loss.cpu())
            return out
        """),
    # -- GLT016 unbalanced-profiler-capture -------------------------------
    ("glt016_bare_start", "GLT016", """
        import jax

        def profile_epoch(run, d):
            jax.profiler.start_trace(d)
            run()
            jax.profiler.stop_trace()
        """, """
        import torch

        def profile_epoch(run, d):
            torch.cuda.profiler.start()
            run()
            torch.cuda.profiler.stop()
        """),
    ("glt016_stop_only_in_except", "GLT016", """
        import jax

        def profile_epoch(run, d):
            jax.profiler.start_trace(d)
            try:
                run()
            except ValueError:
                jax.profiler.stop_trace()
        """, """
        import torch

        def profile_epoch(run, d):
            torch.cuda.profiler.start()
            try:
                run()
            except ValueError:
                torch.cuda.profiler.stop()
        """),
    ("glt016_start_then_try_finally", "GLT016", """
        import jax

        def profile_epoch(run, d):
            jax.profiler.start_trace(d)
            try:
                run()
            finally:
                jax.profiler.stop_trace()
        """, """
        import torch

        def profile_epoch(run, d):
            torch.cuda.profiler.start()
            try:
                run()
            finally:
                torch.cuda.profiler.stop()
        """),
    ("glt016_start_inside_try", "GLT016", """
        import jax

        def profile_epoch(run, d):
            try:
                jax.profiler.start_trace(d)
                run()
            finally:
                jax.profiler.stop_trace()
        """, """
        import torch

        def profile_epoch(run, d):
            try:
                torch.cuda.profiler.start()
                run()
            finally:
                torch.cuda.profiler.stop()
        """),
    ("glt016_nested_scopes_independent", "GLT016", """
        import jax

        jax.profiler.start_trace("/tmp/t")

        def ok(run, d):
            jax.profiler.start_trace(d)
            try:
                run()
            finally:
                jax.profiler.stop_trace()
        """, """
        import torch

        torch.cuda.profiler.start()

        def ok(run, d):
            torch.cuda.profiler.start()
            try:
                run()
            finally:
                torch.cuda.profiler.stop()
        """),
    # -- GLT018 unbalanced-dma-ring (torch side: CUDA text) ---------------
    ("glt018_guard_on_one_side", "GLT018", DMA_POS, CUDA_POS),
    ("glt018_symmetric_guards", "GLT018", DMA_POS.replace(
        "dma(j).wait()",
        "@pl.when(idx_ref[j] >= 0)\n"
        "                    def _w():\n"
        "                        dma(j).wait()"), CUDA_SYMMETRIC),
    ("glt018_start_without_wait", "GLT018", DMA_NO_WAIT, CUDA_NO_WAIT),
    # -- GLT020 divergent-collective --------------------------------------
    ("glt020_branch_on_rank", "GLT020", """
        from jax import lax

        def body(x):
            r = lax.axis_index("shard")
            return lax.cond(r > 0,
                            lambda v: lax.psum(v, "shard"),
                            lambda v: v, x)
        """, """
        from glt_tpu_torch.parallel import multihost

        def body(x, fleet):
            r = multihost.process_index()
            if r > 0:
                x = fleet.all_reduce(x)
            return x
        """),
    ("glt020_taint_through_assignments", "GLT020", """
        from jax import lax

        def body(x):
            me = lax.axis_index("shard")
            is_leader = me == 0
            if is_leader:
                x = lax.all_to_all(x, "shard", 0, 0)
            return x
        """, """
        import torch.distributed as dist

        def body(x):
            me = dist.get_rank()
            is_leader = me == 0
            if is_leader:
                dist.all_to_all_single(x, x)
            return x
        """),
    ("glt020_agreed_predicate", "GLT020", """
        import jax.numpy as jnp
        from jax import lax

        def body(seeds, state):
            me = lax.axis_index("shard")
            nvalid = lax.psum(jnp.sum((seeds >= 0) + me * 0), "shard")
            return lax.cond(nvalid > 0,
                            lambda s: lax.pmean(s, "shard"),
                            lambda s: s, state)
        """, """
        from glt_tpu_torch.parallel import multihost

        def body(seeds, state, fleet, mesh):
            me = mesh.local
            nvalid = multihost.agree_max(int((seeds >= 0).sum()) + len(me))
            if nvalid > 0:
                state = fleet.all_reduce(state)
            return state
        """),
    ("glt020_branch_without_collective", "GLT020", """
        from jax import lax

        def body(x):
            r = lax.axis_index("shard")
            return lax.cond(r > 0, lambda v: v + 1, lambda v: v, x)
        """, """
        from glt_tpu_torch.parallel import multihost

        def body(x):
            r = multihost.process_index()
            return x + 1 if r > 0 else x
        """),
    # -- GLT021 unknown-axis-name -----------------------------------------
    ("glt021_stale_axis_string", "GLT021", """
        import jax
        import numpy as np
        from jax.sharding import Mesh, PartitionSpec as P

        def run(xs):
            mesh = Mesh(np.array(jax.devices()), ("data",))

            def body(x):
                return jax.lax.psum(x, "shard")

            return jax.shard_map(body, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"))(xs)
        """, """
        from glt_tpu_torch.parallel.multihost import (
            Mesh, local_shard_range)


        def run(xs):
            mesh = Mesh(["cpu"], ("data",))

            def body(x):
                return local_shard_range(mesh, "shard")

            return body(xs)

        """),
    ("glt021_parametric_mesh", "GLT021", """
        import jax
        import numpy as np
        from jax.sharding import Mesh, PartitionSpec as P

        def global_mesh(axis_name="shard"):
            return Mesh(np.array(jax.devices()), (axis_name,))

        def run(xs):
            mesh = global_mesh()

            def body(x):
                return jax.lax.psum(x, "anything")

            return jax.shard_map(body, mesh=mesh, in_specs=P("shard"),
                                 out_specs=P("shard"))(xs)
        """, """
        from glt_tpu_torch.parallel.multihost import (
            Mesh, resolve_mesh_axes)

        def make_mesh(axis_name="shard"):
            return Mesh(["cpu"], (axis_name,))

        def run(xs, names):
            mesh = Mesh(["cpu"], names)

            def body(x):
                return resolve_mesh_axes(mesh, "anything")

            return body(xs)
        """),
    ("glt021_matching_axes", "GLT021", """
        import jax
        import numpy as np
        from jax.sharding import Mesh, PartitionSpec as P

        def run(xs):
            mesh = Mesh(np.array(jax.devices()), ("host", "chip"))

            def body(x):
                x = jax.lax.psum(x, "host")
                return jax.lax.all_gather(x, "chip")

            return jax.shard_map(body, mesh=mesh, in_specs=P("host"),
                                 out_specs=P("host"))(xs)
        """, """
        from glt_tpu_torch.parallel.multihost import (
            global_mesh_2d, mesh_axis_sizes, resolve_mesh_axes)

        def run(xs):
            mesh = global_mesh_2d(["cpu"] * 4, num_hosts=2)

            def body(x):
                x = resolve_mesh_axes(mesh, "host")
                return mesh_axis_sizes(mesh, ("host", "chip"))

            return body(xs)
        """),
    # -- GLT022 lossy-dtype-narrowing -------------------------------------
    ("glt022_narrow_casts", "GLT022", """
        import numpy as np
        import jax.numpy as jnp
        import ml_dtypes

        def stage(rows):
            a = rows.astype(np.float16)
            b = rows.astype(jnp.bfloat16)
            c = rows.astype(ml_dtypes.bfloat16)
            d = rows.astype("int8")
            e = rows.astype(np.dtype("uint8"))
            return a, b, c, d, e
        """, """
        import numpy as np
        import torch


        def stage(rows):
            a = rows.astype(np.float16)
            b = rows.to(torch.bfloat16)
            c = rows.half()
            d = rows.astype("int8")
            e = rows.to(dtype=torch.uint8)
            return a, b, c, d, e
        """),
    ("glt022_widening_and_id_casts", "GLT022", """
        import numpy as np
        import jax.numpy as jnp

        def stage(rows, ids):
            a = rows.astype(np.float32)        # widening / identity
            b = rows.astype(jnp.float64)
            c = ids.astype(np.int32)           # GLT004's territory
            d = rows.astype(rows.dtype)        # dynamic target
            e = rows.astype(a.dtype)
            return a, b, c, d, e
        """, """
        import numpy as np
        import torch

        def stage(rows, ids):
            a = rows.to(torch.float32)         # widening / identity
            b = rows.double()
            c = ids.to(torch.int32)            # GLT004's territory
            d = rows.to(rows.dtype)            # dynamic target
            e = rows.to("cuda")                # a device, not a dtype
            return a, b, c, d, e
        """),
]


def _sig(findings, code):
    return sorted((f.code, f.rule, str(f.severity), f.line)
                  for f in findings if f.code == code)


def _torch(src, code):
    path = "fixture.cu" if code == "GLT018" else "fixture.py"
    return tlint.analyze_source(textwrap.dedent(src), path)


@pytest.mark.parametrize("code,jax_src,torch_src",
                         [p[1:] for p in PAIRS], ids=[p[0] for p in PAIRS])
def test_torch_form_matches_jax(code, jax_src, torch_src):
    want = _sig(jlint.analyze_source(textwrap.dedent(jax_src),
                                     "fixture.py"), code)
    got = _sig(_torch(torch_src, code), code)
    assert got == want


def test_every_code_has_a_positive_and_a_negative_pair():
    for code in JAX_RULES:
        hits = set()
        for _, c, jax_src, _ in [p for p in PAIRS if p[1] == code]:
            hits.add(bool(_sig(jlint.analyze_source(
                textwrap.dedent(jax_src), "fixture.py"), code)))
        assert hits == {True, False}, code


# -- the shapes only the torch form has ---------------------------------------
# (id, code, {module: source} or source, path, [(module path, line)])
TORCH_ONLY = [
    ("glt001_cuda_graph_block", "GLT001", """
        import torch


        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = x * 2
                n = y.sum().item()
            return g, n
        """, [9]),
    ("glt001_synchronize_and_guard", "GLT001", """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram

        def scale(x, k):
            if not isinstance(k, torch.Tensor):
                k = float(k)                  # a host value, proven
            return x * k


        def body(x, n: int):
            torch.cuda.synchronize()
            return scale(x, int(n))
        PROG = CapturedProgram(body, [BUF, BUF])
        """, [12]),
    ("glt001_forwarder_class", "GLT001", {
        "pkg.blocks": """
            from glt_tpu_torch.utils.graphs import CapturedProgram


            class Scanned:
                def __init__(self, block):
                    self.block = block

                def __call__(self, state, *blks):
                    prog = CapturedProgram(
                        lambda *ins: self.block(state, ins), blks)
                    return prog.replay()
            """,
        "pkg.train": """
            from pkg.blocks import Scanned


            def make_step(model):
                def block(model_, blks):
                    loss = model_(blks[0])
                    return loss, float(loss)

                return Scanned(block)
            """}, [("pkg/train.py", 8)]),
    ("glt002_sampler_key", "GLT002", """
        from glt_tpu_torch.ops import sample_neighbors


        def hops(indptr, indices, seeds, key):
            a = sample_neighbors(indptr, indices, seeds, 5, key)
            b = sample_neighbors(indptr, indices, a.nbrs, 5, key)
            return a, b
        """, [7]),
    ("glt003_scale_then_buffer", "GLT003", """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def build(table, idx, buf):
            scale = 2.0
            bad = CapturedProgram(lambda i: table[i] * scale, [idx])
            buf.fill_(scale)
            good = CapturedProgram(lambda i, s: table[i] * s, [idx, buf])
            return bad, good
        """, [8]),
    ("glt004_long_and_checks", "GLT004", """
        import torch


        def pos(ids):
            flat = ids.long() * 3
            return flat.int()


        def checked(ids):
            flat = ids.long() * 3
            require_int32_ids(flat)
            return flat.to(torch.int32)
        """, [7]),
    ("glt006_inputs_buffer", "GLT006", """
        import torch
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def feed(table, a, b):
            prog = CapturedProgram(lambda i: table[i], [a])
            held = prog.inputs[0]
            prog(b)
            return held.sum()
        """, [10]),
    ("glt010_counter_in_graph_block", "GLT010", """
        import torch
        from glt_tpu_torch import obs


        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                obs.metrics.counter("glt.x").inc()
                y = x + 1
            with obs.span("replay"):
                g.replay()
            return y
        """, [9, 9]),
    ("glt010_graph_safe_stage_and_counter", "GLT010", """
        import torch
        from glt_tpu_torch import obs
        from glt_tpu_torch.obs.stages import device_counter, stage, tracing
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def step(x):
            with obs.stage("x.a", device=x.device) as st:
                y = x + 1
                st.next("x.b")
                y = y * 2
            with stage("x.c", device=x.device):
                y = y - 1
            if tracing():
                device_counter("glt.x.rows", x.device).add_(y.numel())
            return y
        PROG = CapturedProgram(step, [BUF])
        """, []),
    ("glt010_host_span_beside_a_stage", "GLT010", """
        import torch
        from glt_tpu_torch import obs
        from glt_tpu_torch.utils.graphs import CapturedProgram


        def step(x):
            with obs.stage("x.a", device=x.device):
                y = x + 1
            with obs.span("x.host"):      # runs once, at the capture
                y = y * 2
            obs.metrics.counter("glt.x").inc()
            return y
        PROG = CapturedProgram(step, [BUF])
        """, [10, 12, 12]),
    ("glt013_helper_one_call_deep", "GLT013", """
        import torch


        def publish(loss):
            return float(loss.item())


        def run_scanned_epoch(step, state, blocks, on_block=None):
            for i, blk in enumerate(blocks):
                state, loss = step(state, blk)
                publish(loss)
            return state
        """, [12]),
    ("glt016_profiler_object", "GLT016", """
        import torch


        def leaky(run):
            prof = torch.profiler.profile()
            prof.start()
            run()
            prof.stop()


        def balanced(run):
            prof = torch.profiler.profile()
            prof.__enter__()
            try:
                run()
            finally:
                prof.__exit__(None, None, None)


        def chained(run):
            torch.profiler.profile().start()
        """, [7, 22]),
    ("glt018_mbarrier_and_depth", "GLT018", """
        #include <cuda_pipeline.h>
        constexpr int STAGES = 2;

        __global__ void tma(unsigned long long* bar, float* out) {
            asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], 512;"
                         :: "r"(0));
            out[threadIdx.x] = 0.f;
        }

        __global__ void deep(const float* x, float* out) {
            __shared__ float buf[STAGES][128];
            __pipeline_memcpy_async(&buf[0][threadIdx.x], &x[threadIdx.x], 4);
            __pipeline_commit();
            __pipeline_wait_prior(STAGES);
            out[threadIdx.x] = buf[0][threadIdx.x];
        }
        """, [6, 15]),
    ("glt020_while_and_summary", "GLT020", """
        from glt_tpu_torch.parallel import multihost


        def sync_all():
            multihost.barrier("step")


        def drain(mesh, fleet, x):
            n = 0
            while n < len(mesh.local):
                x = fleet.exchange([0, 1], lambda s, d: x)
                n += 1
            for s in mesh.local:
                if s == 0:
                    sync_all()
            return x
        """, [11, 15]),
    ("glt021_samplers_and_2d_mesh", "GLT021", """
        from glt_tpu_torch.parallel import multihost
        from glt_tpu_torch.parallel.multihost import global_mesh_2d


        def build(graph, feats):
            mesh = global_mesh_2d(["cpu"] * 4, num_hosts=2)
            flat = multihost.Mesh(["cpu"] * 4)
            a = DistNeighborSampler(graph, mesh=mesh, axis_name="shard")
            b = DistNeighborSampler(graph, mesh=flat, axis_name="shard")
            c = multihost.resolve_mesh_axes(mesh, ("host", "core"))
            return a, b, c
        """, [9, 11]),
    ("glt022_quant_module_exempt", "GLT022", {
        "glt_tpu_torch.store.quant": """
            import torch

            def encode(rows):
                return rows.to(torch.int8)
            """,
        "glt_tpu_torch.store.disk": """
            import torch

            def encode(rows):
                return rows.to(torch.int8)
            """}, [("glt_tpu_torch/store/disk.py", 5)]),
]


def _run_torch_only(code, src):
    if isinstance(src, dict):
        project = TProject([
            TModuleInfo(name.replace(".", "/") + ".py",
                        textwrap.dedent(s), module_name=name)
            for name, s in src.items()])
        return sorted((f.path, f.line) for f in tlint.analyze_project(
            project) if f.code == code)
    path = "fixture.cu" if code == "GLT018" else "fixture.py"
    return sorted(f.line for f in tlint.analyze_source(
        textwrap.dedent(src), path) if f.code == code)


@pytest.mark.parametrize("code,src,lines", [c[1:] for c in TORCH_ONLY],
                         ids=[c[0] for c in TORCH_ONLY])
def test_torch_only_shapes(code, src, lines):
    assert _run_torch_only(code, src) == sorted(lines)


def test_every_code_has_a_torch_only_case():
    assert {c[1] for c in TORCH_ONLY} == set(JAX_RULES)


@pytest.mark.parametrize("hz", hazards.HAZARDS,
                         ids=[h.code for h in hazards.HAZARDS])
def test_phase20_hazards_are_flagged_at_their_lines(hz):
    """The card's hazard programs: the linter flags each with its code,
    at its marked line, and with nothing else."""
    got = [(f.code, f.rule, f.line) for f in tlint.analyze_source(
        hz.source, f"hazard_{hz.code}.py")]
    assert got == [(hz.code, hz.rule, hz.line)]
