"""Drive the data path alone: ``NeighborSampler.sample_from_nodes_batched``
over ``[G, B]`` seed blocks (one CUDA graph), then for every batch the
fused-frontier gather of its features and labels
(``make_gather_xy(fused=True)``), blocks back to back.

Before the window, a few (block, batch) pairs are drawn from the seed
among the first full blocks of the window; their outputs are held as
the window made them and judged after it, exactly: the sampled subgraph
against the reference's sample, drawn anew from the graph and the
batch's key, slot by slot; the gathered rows and labels against the
table.  The benchmark makes every block's key (``fold_in(PRNGKey(s),
i)``, a table made once in set-up).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import common, traffic
from ..reference import sampling as ref_sampling
from ..reference import threefry
from ..trace import BLOCK_RANGE, Profiled


def _kept(mix: dict, seed: int) -> dict:
    """``{block: batch}`` of the batches the check judges."""
    rng = np.random.default_rng(traffic.sub_seeds(seed)["check"])
    n, within = int(mix["check_batches"]), int(mix["check_blocks_within"])
    blocks = rng.choice(within, size=n, replace=False)
    return {int(b): int(rng.integers(0, int(mix["group"]))) for b in blocks}


class _Keys:
    """``fold_in(base, i)`` of every block index, made in tables of
    ``chunk`` keys on the device; a block reads its key as a view."""

    def __init__(self, base: torch.Tensor, chunk: int = 1 << 16):
        self.base, self.chunk = base, chunk
        self.table = threefry.split(base, chunk)

    def __getitem__(self, i: int) -> torch.Tensor:
        while i >= self.table.shape[0]:
            n = self.table.shape[0] + self.chunk
            self.table = threefry.split(self.base, n)
        return self.table[i]


def run(ctx) -> dict:
    from glt_tpu_torch.models import make_gather_xy

    cfg, mix, seed, dev = ctx["config"], ctx["mix"], ctx["seed"], ctx["device"]
    gcfg = cfg["graph"]
    sub = traffic.sub_seeds(seed)
    gd, graph = common.build_graph(cfg, seed, dev)
    sampler = common.build_sampler(graph, gd, mix, seed)
    gather_xy = make_gather_xy(None, fused=True)
    table, labels = gd.table, gd.labels
    group = int(mix["group"])
    rf = torch.profiler.record_function

    def body(blk, key):
        with rf("portbench.sample"):
            out = sampler.sample_from_nodes_batched(blk, key)
        with rf("portbench.gather"):
            xy = [gather_xy(table, labels, SimpleNamespace(node=out.node[g]))
                  for g in range(group)]
        return out, xy

    warm_keys = threefry.split(threefry.prng_key(sub["warm"], dev), 2)
    warm = traffic.distinct_batches(gd.train_idx, 2 * group,
                                    int(mix["batch_size"]), seed, "warm")
    for j in range(2):
        body(warm[j * group: (j + 1) * group], warm_keys[j])

    kept_at = _kept(mix, seed)
    kept = {}
    clock = common.BlockClock(dev)
    prof = Profiled(torch) if ctx["trace"] else None
    left = int(mix["trace_blocks"])
    traced, on = [], False
    edges = torch.zeros((), dtype=torch.int64, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    keys = _Keys(threefry.prng_key(sub["keys"], dev))
    seeds = batches = 0
    common.sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    for i, blk in traffic.blocks(gd.train_idx, mix, seed):
        now = time.perf_counter()
        if now - t0 >= ctx["seconds"]:
            break
        if (prof is not None and not on and left > 0
                and now - t0 >= float(mix["trace_at"]) * ctx["seconds"]):
            prof.start()
            on = True
        key = keys[i]
        a = clock.mark()
        if on:
            with rf(BLOCK_RANGE):
                out, xy = body(blk, key)
            traced.append((blk, key))
            left -= 1
        else:
            out, xy = body(blk, key)
        clock.add(a, clock.mark())
        edges += out.num_sampled_edges.sum()
        if out.metadata:
            ovf += out.metadata["overflow"].sum()
        real = int((blk >= 0).any(axis=1).sum())
        seeds += int((blk >= 0).sum())
        batches += real
        if i in kept_at:
            g = kept_at[i]
            kept[i] = (blk[g], key, out, g, xy[g])
        if on and left == 0:
            prof.stop(common.ROLE_RANGES)
            on = False
        del out, xy
    if on:
        prof.stop(common.ROLE_RANGES)
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = {"setup_s": setup_s, "window_s": window_s, "seeds": seeds,
           "edges": int(edges), "batches": batches, "overflow": int(ovf),
           "block_ms": clock.ms(), "peak_bytes": peak,
           "node_capacity": sampler.node_capacity}
    indptr = torch.from_numpy(gd.indptr).to(dev).long()
    if prof is not None and prof.summary is not None:
        work = common.traced_work(sampler, traced, indptr, mix["fanout"],
                                  None, int(gcfg["feature_dim"]))
        rec["trace"] = dict(prof.summary, **work)
    del sampler, graph, body
    common.free(dev)
    rec["numbers"] = judge(ctx, gd, indptr, kept, kept_at)
    rec["controls"] = {}
    if ctx.get("controls"):
        # The reference's gather in bf16, in the program's place.
        rec["controls"]["bf16"] = judge(
            ctx, gd, indptr, kept, kept_at,
            lambda node, mask: torch.where(
                mask[:, None], gd.table[node.long().clamp(min=0)], 0
            ).bfloat16().float())
    return rec


def judge(ctx, gd, indptr, kept, kept_at, x_of=None) -> dict:
    """Every held batch against the reference's sample and the table;
    ``missing`` counts the drawn batches the window never made.
    ``x_of(node, node_mask)`` stands in for the program's rows (the
    control)."""
    mix, dev = ctx["mix"], ctx["device"]
    bsz, fanouts = int(mix["batch_size"]), list(mix["fanout"])
    indices = torch.from_numpy(gd.indices).to(dev)
    nums = {"bad_nodes": 0, "bad_edges": 0, "x_max_diff": 0.0,
            "bad_labels": 0, "missing": len(set(kept_at) - set(kept))}
    for i, (seeds, key, out, g, (x, y)) in sorted(kept.items()):
        meta = out.metadata
        ovf = bool(meta["overflow"][g]) if meta else None
        ref = ref_sampling.sample(indptr, indices,
                                  torch.from_numpy(seeds).to(dev), fanouts,
                                  threefry.split(key, out.node.shape[0])[g])
        got = ref_sampling.compare_sample(
            ref, bsz, fanouts, out.node[g], out.row[g], out.col[g],
            out.edge_mask[g], out.node_mask[g], out.num_sampled_nodes[g],
            ovf)
        if x_of is not None:
            x = x_of(out.node[g], out.node_mask[g])
        got.update(ref_sampling.check_gather(gd.table, gd.labels, out.node[g],
                                             out.node_mask[g], x, y))
        for k, v in got.items():
            nums[k] = max(nums[k], v) if k == "x_max_diff" else nums[k] + v
    return nums
