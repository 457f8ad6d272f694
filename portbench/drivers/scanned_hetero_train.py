"""Drive the scanned hetero train step (``make_scanned_hetero_train_step``
over the published R-GAT, ``glt_tpu_torch.models.RGNN``), blocks back to
back over the target type's train split.

Set-up makes the graph, its bf16 tables and the labels on the card
from the configuration's ``data_seed`` (the one dataset a deployment
trains on: every run holds the same graph, so the same shapes), then
calibrates the sampler's per-(hop, node type) widths on warm batches
drawn from that seed too (the ``pct`` percentile of each level's count,
times ``margin``, rounded up to ``multiple`` rows:
``calibrate_frontier_widths``; the coarse rounding is the small types'
margin, whose counts vary most).  The run's ``--seed``
draws the weights, the seed order, the keys and the checked batches.
It builds the one step object
and its state and drives them through their first 25 steps, on 25
distinct seed batches, each call through the window's own call under a
key the benchmark makes:

1. a block whose first batch is real and whose others are padding, run
   eagerly (its Adam moment gives the first gradient);
2. three full ``[G, B]`` blocks (the pattern of every block the window
   runs): the first runs eagerly, the second captures the block's CUDA
   graph, the third replays it.

So the one graph the window replays has run a checked step.  The
window drives the same object on over the seed's blocks, and ends with
the last block that fits in ``--seconds``, before the epoch's last
block: no epoch ends inside it.  The host runs at most two blocks ahead
of the card.  In a traced run the program's tracer is installed before
anything is captured.

The check, after the window and with the program's state freed but for
the readings of those steps: the reference draws each batch's sample
anew from the graph and the batch's key (``split(key, G)[g]``,
``reference/hetero_sampling.py``) and trains the plain f32 R-GAT
(``reference/rgnn.py``) through the 25 steps from the same initial
parameters on its own samples; the first gradient and the parameters'
change are compared (:func:`train_numbers`).  Each batch is also drawn
again by the program's sampler, eagerly under the same key, and
compared with the reference's sample slot by slot, per type.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import check, common, gen_hetero, progtrace, roofline
from .. import roofline_hetero, traffic
from ..reference import hetero_sampling as ref_sampling
from ..reference import rgnn as ref_rgnn
from ..reference import threefry
from ..trace import BLOCK_RANGE, Profiled

#: Real batches of each checked call (None: a full block).
CHECK_CALLS = (1, None, None, None)
#: Blocks the host may dispatch ahead of the card.
AHEAD = 2


def whole_diff(prog, ref) -> float:
    """``norm(prog - ref)`` over ``norm(ref)``, every leaf one vector."""
    num = sum(float((prog[k].double() - ref[k].double()).pow(2).sum())
              for k in ref)
    den = sum(float(ref[k].double().pow(2).sum()) for k in ref)
    return math.sqrt(num / max(den, 1e-300))


def train_numbers(prog: dict, ref: dict, params0) -> dict:
    """The compared training numbers of this cell: ``grad_gap`` and
    ``change_gap`` of ``check.train_numbers`` (worst leaves' gaps
    of norms), and ``grad_err`` and ``change_err``, the difference of
    the whole first gradient and of the whole change over the checked
    steps, each leaf a part of one vector (:func:`whole_diff`).

    ``check``'s worst leaf of a difference is left out: R-GAT's worst
    leaves are its ``att_dst`` vectors, whose gradients nearly cancel
    (the softmax over a destination's edges sees a term common to them
    all only through the LeakyReLU's kink), and Adam moves each element
    by about ``lr`` whatever its gradient's size, so bf16 rounding reads
    there within a factor of about two of the fp8 control's and of the
    faults'.  Over the whole vector it reads well under either
    (``limits/rgat-igbh.hetero_train.json`` gives the readings)."""
    nums = check.train_numbers(prog, ref, params0)
    dp = {k: prog["params"][k].float() - params0[k].float() for k in params0}
    dr = {k: ref["params"][k].float() - params0[k].float() for k in params0}
    return {"grad_gap": nums["grad_gap"], "change_gap": nums["change_gap"],
            "grad_err": whole_diff(prog["first_grad"], ref["first_grad"]),
            "change_err": whole_diff(dp, dr)}


def _names_shapes(model):
    """``(name, shape, fan_in)`` of each parameter: a weight's input
    width, an attention vector's head width, a bias its layer's input
    width."""
    out = []
    for name, p in model.named_parameters():
        if p.dim() == 2:
            fan_in = p.shape[1]
        else:
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            lin = getattr(owner, "lin", owner)
            fan_in = lin.weight.shape[1]
        out.append((name, tuple(p.shape), fan_in))
    return out


def _check_blocks(ids: np.ndarray, group: int):
    out, lo = [], 0
    for real in CHECK_CALLS:
        n = group if real is None else real
        blk = np.full((group, ids.shape[1]), -1, np.int64)
        blk[:n] = ids[lo: lo + n]
        out.append(blk)
        lo += n
    return out


def build_sampler(graphs, gd, mix: dict, seed: int):
    """The sampler with widths calibrated on the warm batches from an
    uncapped probe (the fanouts' worst case)."""
    from glt_tpu_torch.sampler import (HeteroNeighborSampler,
                                       calibrate_frontier_widths)

    bsz = int(mix["batch_size"])
    cap = mix["node_capacity"]
    probe = HeteroNeighborSampler(graphs, list(mix["fanout"]), gd.target,
                                  batch_size=bsz)
    cal = traffic.distinct_batches(gd.train_idx, int(cap["batches"]), bsz,
                                   seed, "warm")
    widths = calibrate_frontier_widths(probe, list(cal.astype(np.int32)),
                                       pct=float(cap["pct"]),
                                       margin=float(cap["margin"]),
                                       multiple=int(cap["multiple"]))
    del probe
    return HeteroNeighborSampler(graphs, list(mix["fanout"]), gd.target,
                                 batch_size=bsz, frontier_widths=widths)


def run(ctx) -> dict:
    tracer = progtrace.install(ctx)
    from glt_tpu_torch.data import CSRTopo, Graph
    from glt_tpu_torch.models import (RGNN, adam, create_train_state,
                                      make_scanned_hetero_train_step)
    from glt_tpu_torch.sampler.base import NodeSamplerInput

    cfg, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
    gcfg, mcfg = cfg["graph"], cfg["model"]
    bsz, group = int(mix["batch_size"]), int(mix["group"])
    fanouts = list(mix["fanout"])
    if len(fanouts) != int(mcfg["num_layers"]):
        raise ValueError("one fanout a layer")
    sub = traffic.sub_seeds(seed)

    data_seed = int(gcfg["data_seed"])
    gd = gen_hetero.make_hetero(
        gcfg, traffic.sub_seeds(data_seed)["graph"], dev)
    graphs = {et: Graph(CSRTopo.from_csr_arrays(ip, ix), device=dev)
              for et, (ip, ix) in gd.csr.items()}
    sampler = build_sampler(graphs, gd, mix, data_seed)
    rels = [ref_sampling.reverse(et) for et in sorted(gd.csr)]
    model = RGNN(rels, int(gcfg["feature_dim"]), int(mcfg["hidden"]),
                 int(gcfg["num_classes"]), gd.target,
                 num_layers=int(mcfg["num_layers"]),
                 heads=int(mcfg["heads"]),
                 dropout_rate=float(mcfg["dropout"]),
                 dtype=getattr(torch, mcfg["matmul_dtype"])).to(dev)
    params0 = common.init_params(_names_shapes(model), seed, dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params0[name])
    state = create_train_state(model, adam(float(mcfg["lr"])))
    step = make_scanned_hetero_train_step(
        sampler, gd.tables, {gd.target: gd.labels}, bsz,
        dropout_seed=int(mcfg["dropout_seed"]))

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
            st = state.optimizer.state
            # A parameter the first step left (a last-layer relation
            # into a type the head does not read) had no gradient.
            first_grad = {n: st[p]["exp_avg"].detach().clone() / 0.1
                          if "exp_avg" in st.get(p, {})
                          else torch.zeros_like(p)
                          for n, p in model.named_parameters()}
    prog = {"first_grad": first_grad,
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}

    # The window.
    clock = common.BlockClock(dev)
    prof = Profiled(torch) if ctx["trace"] else None
    tr = {"left": int(mix["trace_blocks"]), "blocks": [], "on": False}
    per_epoch = -(-gd.train_idx.shape[0] // (bsz * group))
    base = threefry.prng_key(sub["keys"], dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    seeds = batches = 0
    ends = []
    progtrace.window_start(tracer)
    common.sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    for i, blk in traffic.blocks(gd.train_idx, mix, seed):
        now = time.perf_counter()
        done = max(len(ends) - AHEAD, 0)
        if (ctx["seconds"] <= 0 or i + 1 >= per_epoch
                or (done and now - t0 + (now - t0) / done * (AHEAD + 1)
                    > ctx["seconds"])):
            break
        if (prof is not None and not tr["on"] and tr["left"] > 0
                and now - t0 >= float(mix["trace_at"]) * ctx["seconds"]):
            prof.start()
            tr["on"] = True
        key = threefry.fold_in(base, i)
        a = clock.mark()
        if tr["on"]:
            with torch.profiler.record_function(BLOCK_RANGE):
                res = step(state, blk, key)
            tr["blocks"].append((blk, key.clone()))
            tr["left"] -= 1
        else:
            res = step(state, blk, key)
        b = clock.mark()
        clock.add(a, b)
        state = res[0]
        ovf += res[3].sum()
        seeds += int((blk >= 0).sum())
        batches += int((blk >= 0).any(axis=1).sum())
        ends.append(b)
        if tr["on"] and tr["left"] == 0:
            prof.stop(common.ROLE_RANGES)
            tr["on"] = False
        if len(ends) > AHEAD and clock.cuda:
            ends[-1 - AHEAD].synchronize()
    if tr["on"]:
        prof.stop(common.ROLE_RANGES)
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"setup_s": setup_s, "window_s": window_s, "seeds": seeds,
           "batches": batches, "overflow": int(ovf), "block_ms": clock.ms(),
           "peak_bytes": peak, "node_capacity": sampler.node_capacity}
    progtrace.window_end(tracer, rec)

    if prof is not None and prof.summary is not None:
        work = traced_work(sampler, tr["blocks"], gd, rels, cfg)
        rec["trace"] = dict(prof.summary, **work)

    # Each checked batch drawn again by the program's sampler.
    redrawn = [sampler.sample_from_nodes(NodeSamplerInput(ids), key=k)
               for ids, k in zip(check_ids, batch_keys)]
    widths = sampler.hop_widths
    del step, state, model, sampler, graphs
    common.free(dev)
    rec["numbers"], rec["controls"] = judge(
        ctx, gd, rels, check_ids, batch_keys, widths, redrawn, prog, params0)
    return rec


def _levels(out, widths):
    """Host ``node type -> [level counts]`` of a sample and each
    ``(hop, type)``'s frontier ids (the first ``W[h][t]`` of its level)."""
    levels = {t: [int(c) for c in v.tolist()]
              for t, v in out.num_sampled_nodes.items()}
    fronts = {}
    for t, lv in levels.items():
        lo = 0
        for h in range(len(widths) - 1):
            n = min(lv[h], widths[h].get(t, 0))
            fronts[(h, t)] = out.node[t][lo: lo + n].long()
            lo += lv[h]
    return levels, fronts


def traced_work(sampler, blocks, gd, rels, cfg) -> dict:
    """The summed work of the traced blocks' batches, drawn again: B1's
    bound per (hop, edge type), B2's per type, and R-GAT's FLOPs."""
    from glt_tpu_torch.sampler.base import NodeSamplerInput

    gcfg, mcfg = cfg["graph"], cfg["model"]
    dev = sampler.device
    widths = sampler.hop_widths
    caps = sampler.node_capacity
    row_bytes = (int(gcfg["feature_dim"])
                 * next(iter(gd.tables.values())).element_size())
    indptr = {et: torch.from_numpy(ip).to(dev).long()
              for et, (ip, _) in gd.csr.items()}
    layers = int(mcfg["num_layers"])
    dims = [int(gcfg["feature_dim"])] + [int(mcfg["hidden"])] * (layers - 1)
    tot = {"b1_bound_s": 0.0, "b2_bound_s": 0.0, "flops": 0.0,
           "batches": 0}
    for blk, key in blocks:
        keys = threefry.split(key, blk.shape[0])
        for g in range(blk.shape[0]):
            if not (blk[g] >= 0).any():
                continue
            out = sampler.sample_from_nodes(NodeSamplerInput(blk[g]),
                                            key=keys[g])
            levels, fronts = _levels(out, widths)
            for et in sampler.edge_types:
                for h, f in enumerate(sampler.num_neighbors[et]):
                    front = fronts.get((h, et[0]))
                    if f <= 0 or front is None or not front.numel():
                        continue
                    ip = indptr[et]
                    deg = ip[front + 1] - ip[front]
                    tot["b1_bound_s"] += roofline.bound_s(roofline.hop_work(
                        int(front.shape[0]), int(deg.clamp(max=f).sum()),
                        int((deg > f).sum()), f))
            for t in gd.tables:
                tot["b2_bound_s"] += roofline.bound_s(
                    roofline_hetero.gather_work(max(caps[t], 1), row_bytes))
            tot["flops"] += roofline_hetero.rgnn_flops(
                levels, rels, dims, int(mcfg["hidden"]),
                int(gcfg["num_classes"]), levels[gd.target][0])
            tot["batches"] += 1
    return tot


def judge(ctx, gd, rels, check_ids, batch_keys, widths, redrawn, prog,
          params0):
    """The compared numbers of a run: each redrawn batch against the
    reference's sample, then the reference's steps on its own samples
    against the program's.  With ``ctx["controls"]`` also the same
    numbers of the control (the reference with fp8 matmuls in the
    program's place)."""
    cfg, mix, dev = ctx["config"], ctx["mix"], ctx["device"]
    mcfg = cfg["model"]
    csr = {et: (torch.from_numpy(ip).to(dev).long(),
                torch.from_numpy(ix).to(dev))
           for et, (ip, ix) in gd.csr.items()}
    fanouts = {et: list(mix["fanout"]) for et in csr}
    nums = {"bad_nodes": 0, "bad_edges": 0}
    batches = []
    for j, ids in enumerate(check_ids):
        seeds = torch.from_numpy(ids).to(dev)
        ref = ref_sampling.sample(csr, seeds, gd.target, fanouts, widths,
                                  batch_keys[j])
        out = redrawn[j]
        ovf = bool(out.metadata["overflow"]) if out.metadata else None
        for k, v in ref_sampling.compare(ref, out, ovf).items():
            nums[k] += v
        batches.append({"nodes": ref_sampling.kept_nodes(ref),
                        "edges": ref_sampling.edges(ref),
                        "y": gd.labels[seeds.long()], "step": j})
    del csr
    ref = ref_rgnn.train(params0, batches, gd.tables, rels, mcfg, gd.target,
                         "f32")
    nums.update(train_numbers(prog, ref, params0))
    controls = {}
    if ctx.get("controls"):
        fp8 = ref_rgnn.train(params0, batches, gd.tables, rels, mcfg,
                             gd.target, "fp8")
        controls["fp8"] = train_numbers(fp8, ref, params0)
    return nums, controls
