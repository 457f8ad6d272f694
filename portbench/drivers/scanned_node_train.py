"""Drive the scanned node train step (``make_scanned_node_train_step``
through ``run_scanned_epoch``), epochs back to back over the train split.

Set-up builds the one step object and its state and drives them through
their first 26 steps, on 26 distinct seed batches, each call through
the window's own call under a key the benchmark makes:

1. a block whose first batch is real and whose others are padding (the
   pattern of each epoch's last block), run eagerly;
2. three full ``[G, B]`` blocks (the pattern of every other block): the
   first runs eagerly, the second captures the block's CUDA graph, the
   third replays it;
3. the padded block again, which captures its graph.

So every graph the window replays has run a checked step.  The window
drives the same object on, and ends with the last whole epoch that fits
in ``--seconds`` (at least one).

The check, after the window and with the program's state freed but for
the readings of those steps: the reference draws each batch's sample
anew from the graph and the batch's key (``split(key, G)[g]``) and
trains the plain f32 model through the 26 steps from the same initial
parameters on its own samples; the first gradient (from Adam's state
after step 1) and the parameters' change are compared.  Each
batch is also drawn again by the program's sampler, eagerly under the
same key, and compared with the reference's sample slot by slot.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import check, common, traffic
from ..reference import sage as ref_sage
from ..reference import sampling as ref_sampling
from ..reference import threefry
from ..trace import BLOCK_RANGE, Profiled

#: Real batches of each checked call (None: a full block): the one-batch
#: pattern eagerly; the full pattern eagerly, captured, replayed; the
#: one-batch pattern captured.
CHECK_CALLS = (1, None, None, None, 1)


def _names_shapes(model):
    out = []
    for name, p in model.named_parameters():
        fan_in = p.shape[1] if p.dim() == 2 else model.get_submodule(
            name.rsplit(".", 2)[0]).lin_self.weight.shape[1]
        out.append((name, tuple(p.shape), fan_in))
    return out


def _check_blocks(ids: np.ndarray, group: int):
    """The checked calls' ``[G, B]`` blocks over distinct batches
    ``ids``, in order."""
    out, lo = [], 0
    for real in CHECK_CALLS:
        n = group if real is None else real
        blk = np.full((group, ids.shape[1]), -1, np.int64)
        blk[:n] = ids[lo: lo + n]
        out.append(blk)
        lo += n
    return out


def run(ctx) -> dict:
    from glt_tpu_torch.models import (GraphSAGE, adam, create_train_state,
                                      make_scanned_node_train_step,
                                      run_scanned_epoch)
    from glt_tpu_torch.sampler.base import NodeSamplerInput

    cfg, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
    gcfg, mcfg = cfg["graph"], cfg["model"]
    bsz, group = int(mix["batch_size"]), int(mix["group"])
    fanouts = list(mix["fanout"])
    if len(fanouts) != int(mcfg["num_layers"]):
        raise ValueError("one fanout a layer")
    sub = traffic.sub_seeds(seed)

    gd, graph = common.build_graph(cfg, seed, dev)
    sampler = common.build_sampler(graph, gd, mix, seed)
    model = GraphSAGE(int(gcfg["feature_dim"]), int(mcfg["hidden"]),
                      int(gcfg["num_classes"]),
                      num_layers=int(mcfg["num_layers"]),
                      dropout_rate=float(mcfg["dropout"]),
                      dtype=getattr(torch, mcfg["matmul_dtype"])).to(dev)
    params0 = common.init_params(_names_shapes(model), seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params0[name])
    state = create_train_state(model, adam(float(mcfg["lr"])))
    step = make_scanned_node_train_step(
        sampler, gd.table, gd.labels, bsz,
        dropout_seed=int(mcfg["dropout_seed"]), fused_frontier=True)

    # The first steps, through the window's own call.
    check_ids = traffic.distinct_batches(
        gd.train_idx, sum(group if r is None else r for r in CHECK_CALLS),
        bsz, seed, "check")
    call_keys = threefry.split(threefry.prng_key(sub["check"], dev),
                               len(CHECK_CALLS))
    first_grad, batch_keys = None, []
    for j, blk in enumerate(_check_blocks(check_ids, group)):
        state, *_ = step(state, blk, call_keys[j])
        real = int((blk >= 0).any(axis=1).sum())
        batch_keys += list(threefry.split(call_keys[j], group)[:real])
        if j == 0:
            # Adam's first moment after one step is 0.1 of the gradient;
            # an optimizer that kept no state saw none.
            st = state.optimizer.state
            first_grad = {n: st[p]["exp_avg"].detach().clone() / 0.1
                          if "exp_avg" in st.get(p, {}) else torch.zeros_like(p)
                          for n, p in model.named_parameters()}
    prog = {"first_grad": first_grad,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}

    # The window.
    clock = common.BlockClock(dev)
    prof = Profiled(torch) if ctx["trace"] else None
    tr = {"left": int(mix["trace_blocks"]), "blocks": [], "on": False}
    seeds = {"n": 0}

    def timed(state, blk, key):
        now = time.perf_counter()
        if (prof is not None and not tr["on"] and tr["left"] > 0
                and now - t0 >= float(mix["trace_at"]) * ctx["seconds"]):
            prof.start()
            tr["on"] = True
        a = clock.mark()
        if tr["on"]:
            with torch.profiler.record_function(BLOCK_RANGE):
                res = step(state, blk, key)
            tr["blocks"].append((blk, key.clone()))
            tr["left"] -= 1
        else:
            res = step(state, blk, key)
        clock.add(a, clock.mark())
        seeds["n"] += int((blk >= 0).sum())
        if tr["on"] and tr["left"] == 0:
            prof.stop(common.ROLE_RANGES)
            tr["on"] = False
        return res

    rng = np.random.default_rng(sub["order"])
    base = threefry.prng_key(sub["keys"], dev)
    batches = overflow = epochs = 0
    common.sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    while ctx["seconds"] > 0:
        t_epoch = time.perf_counter()
        state, ls, _, ovf = run_scanned_epoch(
            timed, state, gd.train_idx, bsz, group, rng,
            threefry.fold_in(base, epochs))
        batches += int(ls.shape[0])
        overflow += int(ovf)
        epochs += 1
        now = time.perf_counter()
        # The epoch ends in a host copy of its losses, so ``now`` follows
        # the card; stop where another epoch like it would not fit.
        if now - t0 + (now - t_epoch) > ctx["seconds"]:
            break
    if tr["on"]:
        prof.stop(common.ROLE_RANGES)
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    block_ms = clock.ms()
    rec = {"setup_s": setup_s, "window_s": window_s, "seeds": seeds["n"],
           "batches": batches, "overflow": overflow, "block_ms": block_ms,
           "peak_bytes": peak, "epochs": epochs,
           "node_capacity": sampler.node_capacity}

    indptr = torch.from_numpy(gd.indptr).to(dev).long()
    if prof is not None and prof.summary is not None:
        dims = ([int(gcfg["feature_dim"])]
                + [int(mcfg["hidden"])] * (int(mcfg["num_layers"]) - 1)
                + [int(gcfg["num_classes"])])
        work = common.traced_work(sampler, tr["blocks"], indptr, fanouts,
                                  dims, int(gcfg["feature_dim"]))
        rec["trace"] = dict(prof.summary, **work)

    # Each checked batch drawn again by the program's sampler.
    redrawn = [sampler.sample_from_nodes(NodeSamplerInput(ids), key=k)
               for ids, k in zip(check_ids, batch_keys)]
    cap = sampler.node_capacity
    del step, state, model, sampler, graph
    common.free(dev)
    rec["numbers"], rec["controls"] = judge(
        ctx, gd, indptr, check_ids, batch_keys, cap, redrawn, prog, params0)
    return rec


def judge(ctx, gd, indptr, check_ids, batch_keys, cap, redrawn, prog,
          params0):
    """The compared numbers of a run: each redrawn batch against the
    reference's sample, then the reference's steps on its own samples
    against the program's.  With ``ctx["controls"]`` also the same
    numbers of the control (the reference with fp8 matmuls in the
    program's place) and of two faults put in the reference's place
    (the loss over half of the seeds; a step that leaves the state
    unchanged)."""
    cfg, mix, dev = ctx["config"], ctx["mix"], ctx["device"]
    bsz, fanouts = int(mix["batch_size"]), list(mix["fanout"])
    indices = torch.from_numpy(gd.indices).to(dev)
    nums = {"bad_nodes": 0, "bad_edges": 0}
    batches = []
    for j, ids in enumerate(check_ids):
        seeds = torch.from_numpy(ids).to(dev)
        ref = ref_sampling.sample(indptr, indices, seeds, fanouts,
                                  batch_keys[j])
        out = redrawn[j]
        ovf = bool(out.metadata["overflow"]) if out.metadata else None
        got = ref_sampling.compare_sample(
            ref, bsz, fanouts, out.node, out.row, out.col, out.edge_mask,
            out.node_mask, out.num_sampled_nodes, ovf)
        for k, v in got.items():
            nums[k] += v
        src, dst, node = ref_sampling.edges(ref, cap)
        batches.append({"x": gd.table[node], "src": src, "dst": dst,
                        "y": gd.labels[node[: seeds.shape[0]]], "step": j})
    del indices
    ref = ref_sage.train(params0, batches, cfg["model"], "f32")
    nums.update(check.train_numbers(prog, ref, params0))
    controls = {}
    if ctx.get("controls"):
        half = bsz // 2
        for name, other in (
                ("fp8", ref_sage.train(params0, batches, cfg["model"],
                                       "fp8")),
                ("half_batch", ref_sage.train(params0, batches,
                                              cfg["model"], "f32", half)),
                ("unchanged", dict(prog, params=params0))):
            controls[name] = check.train_numbers(other, ref, params0)
    return nums, controls
