#!/usr/bin/env python3
"""Drive glt_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases (the first failure exits non-zero and prints no result line):

1. device: the card's name and, from nvidia-smi, its name and power limit;
2. build: compile the CUDA kernels from ``glt_tpu_torch/csrc`` (nvcc);
3. kernels: each kernel (B1 neighbor read, B2 row gather, B3 fused
   frontier gather) against its plain PyTorch version on the card
   (``torch.equal``) over the main path's shapes and the edge cases, then
   kernel, plain and library-call device times (CUDA events around 25
   calls queued back to back, median of 5 rounds) at the main path's
   widest launch (B3: at the training phase's node list), beside the
   least time the card could take (bytes over 3.35 TB/s);
4. serving: a products-scale graph (2,449,029 nodes, power-law degrees
   of mean 25, seed 0; 100-wide f32 features; 47 classes) served by
   ``SubgraphEngine(ServingOptions(num_neighbors=(15, 10, 5),
   seed_buckets=(8, 32, 128)))``; every message checked against the
   graph and the feature table, GraphSAGE (hidden 256, 3 layers, 47
   classes, random weights from seed 0) run on every served batch, and
   one micro-batch per bucket served again on the CPU and required
   equal; kernel launch counts are read around this phase.  Then, per
   bucket, the threefry draw's host time, and PROFILED warm
   micro-batches under ``torch.profiler``: kernel launches and their
   device time, counted apart from device<->host copies and memsets;
5. training: the flagship configuration of
   ``examples/train_sage_products.py`` on the same graph (GraphSAGE,
   hidden 256, 3 layers, bf16 matmuls, dropout 0.5, Adam 1e-3; batch
   1024, fanout (15, 10, 5), frontier cap 8192, no edge ids): the node
   capacity calibrated on 8 batches (p99, no margin), a capped
   ``NeighborSampler``, the
   scanned epoch at G = 8 with the feature gather through B3 for 5
   blocks, then held-out batches through ``NeighborLoader`` (B1 + B2);
   kernel launch counts are read around this phase.  Losses must be
   finite; one block's ``x`` through B3 must equal the plain gather's;
   one step with dropout off must give the CPU's loss; one more block
   runs under ``torch.profiler``;
6. digits: ``glt_tpu_torch.examples.train_sage_digits`` with its
   defaults on the card must clear ``acc > 0.93``;
7. the kernel line ``{"kernels": [...]}`` and the ok line.

Details go to ``build/results/chip_smoke.json``.  Imports torch, numpy
and glt_tpu_torch only.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published peak
FANOUTS = (15, 10, 5)
BUCKETS = (8, 32, 128)
FEAT_DIM, CLASSES, HIDDEN, LAYERS = 100, 47, 256, 3
PRODUCTS_N, AVG_DEG = 2_449_029, 25
REPS = 25
PROFILED = 3                      # micro-batches per bucket under the profiler
# Training phase: examples/train_sage_products.py's flagship settings.
TRAIN_BS, FRONTIER_CAP, GROUP, LR = 1024, 8192, 8, 1e-3
TRAIN_BLOCKS, CAL_BATCHES, EVAL_BATCHES = 5, 8, 2
LOSS_RTOL = 1e-2                  # card vs CPU loss, bf16 matmuls (see run_train)
DIGITS_ARGS = []                  # the digits twin's defaults
SLEEP_CYCLES = 40_000_000         # ~20 ms at the H100's 1.98 GHz
OUT_DIR = os.path.join("build", "results")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


class Failed(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# -- products-scale graph (the recipe of benchmarks/graph_gen.py) ---------
def powerlaw_degrees(n, avg_deg, rng, alpha=1.8, dmax=50_000):
    raw = rng.pareto(alpha, n) + 1.0
    deg = np.minimum(raw, float(dmax))
    deg = np.maximum(1, (deg * (avg_deg / deg.mean())).astype(np.int64))
    return np.minimum(deg, dmax)


def build_graph(seed: int = 0):
    rng = np.random.default_rng(seed)
    deg = powerlaw_degrees(PRODUCTS_N, AVG_DEG, rng)
    indptr = np.zeros(PRODUCTS_N + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, PRODUCTS_N, int(indptr[-1]), dtype=np.int64)
    return indptr, indices


# -- timing ----------------------------------------------------------------
def cuda_ms(torch, fn, reps: int = REPS, rounds: int = 5) -> float:
    """Device time of one ``fn`` call: ``reps`` calls back to back between
    two CUDA events, median over ``rounds``.  A sleep kernel holds the
    card while the host queues the calls, so host-side call overhead
    (argument checks, ctypes, allocation) does not show as idle time
    between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def host_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phase 3: kernels against their plain versions --------------------------
def edge_case_graph(rng):
    """Small CSR with degree 0, degree < fanout and a hub row."""
    n = 2048
    deg = rng.integers(0, 30, n)
    deg[:4] = [0, 3, 5000, 1]
    deg[-1] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1]))
    seeds = np.concatenate([
        [0, 1, 2, 3, n - 1, -1, 2, 2], rng.integers(0, n, 300),
        np.full(8, -1)]).astype(np.int32)
    return indptr, indices, edge_ids, seeds


def check_sample_kernel(torch, ops, trandom, dev, products, rng):
    """B1 cases: the degree cases on a small graph, fanouts 15/10/5/40,
    all eid modes; then the main path's three hop shapes on the products
    graph.  Returns (max_abs_err, cases, timing row)."""
    from glt_tpu_torch.ops.neighbor_sample import (
        _row_offsets_and_degrees,
        draw_positions,
    )
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    worst, cases = 0, 0

    def compare(ip, ix, eid, seeds, fanout, key_seed, with_edge):
        nonlocal worst, cases
        _, deg = _row_offsets_and_degrees(ip, seeds)
        pos, mask = draw_positions(deg, fanout,
                                   trandom.PRNGKey(key_seed, device=dev),
                                   False, seeds)
        got = ops.sample_neighbors_cuda(ip, seeds, pos, mask, ix, eid,
                                        with_edge)
        want = ops.sample_neighbors_plain(ip, seeds, pos, mask, ix, eid,
                                          with_edge)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            need((g is None) == (w is None), "B1 edge-id presence differs")
            if g is None:
                continue
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            worst = max(worst, err)
            need(torch.equal(g, w), f"B1 differs from its plain version "
                                    f"(fanout {fanout}, rows {g.shape[0]})")
        cases += 1
        return pos, mask

    indptr, indices, edge_ids, seeds = edge_case_graph(rng)
    ip, ix, ei, sd = t(indptr), t(indices), t(edge_ids), t(seeds)
    all_pad = t(np.full(64, -1))
    for fanout in (15, 10, 5, 40):
        for eid, with_edge in ((None, False), (None, True), (ei, True)):
            compare(ip, ix, eid, sd, fanout, fanout, with_edge)
            compare(ip, ix, eid, all_pad, fanout, fanout, with_edge)

    pip, pix = products
    widths = [BUCKETS[-1]]
    for f in FANOUTS[:-1]:
        widths.append(widths[-1] * f)
    shapes = []
    for w, f in zip(widths, FANOUTS):
        frontier = t(rng.integers(0, PRODUCTS_N, w))
        pos, mask = compare(pip, pix, None, frontier, f, w, True)
        shapes.append((w, f, frontier, pos, mask))

    # Time the widest hop of the largest bucket (B = 19200, F = 5).
    w, f, frontier, pos, mask = shapes[-1]
    start = pip[frontier.long()]
    flat = (start[:, None] + torch.where(mask, pos, 0)).reshape(-1).long()
    valid = int(mask.sum())
    rows_valid = int(mask.any(dim=1).sum())
    nbytes = (w * 4 + rows_valid * 4 + w * f * 4 + w * f * 1
              + valid * 4 + 2 * w * f * 4)
    row = {
        "shape": [w, f],
        "ms": cuda_ms(torch, lambda: ops.sample_neighbors_cuda(
            pip, frontier, pos, mask, pix, None, True)),
        "plain_ms": cuda_ms(torch, lambda: ops.sample_neighbors_plain(
            pip, frontier, pos, mask, pix, None, True)),
        "library_ms": cuda_ms(torch, lambda: torch.take(pix, flat)),
        "bound_ms": bound_ms(nbytes),
        "bytes": nbytes,
    }
    per_hop = []
    for w, f, frontier, pos, mask in shapes:
        per_hop.append({"shape": [w, f], "ms": cuda_ms(
            torch, lambda: ops.sample_neighbors_cuda(
                pip, frontier, pos, mask, pix, None, True))})
    row["per_hop"] = per_hop
    return worst, cases, row


def check_gather_kernel(torch, ops, dev, table, idx_main, rng):
    """B2 cases: d in {1, 3, 64, 100, 128, 256}, f32 and bf16, ragged
    batches, an unaligned base; then the main path's feature gather."""
    worst, cases = 0.0, 0

    def compare(tab, idx):
        nonlocal worst, cases
        got = ops.gather_rows_cuda(tab, idx)
        want = ops.gather_rows_plain(tab, idx)
        torch.cuda.synchronize()
        if got.numel():
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        need(torch.equal(got, want), f"B2 differs from its plain version "
                                     f"({tuple(tab.shape)}, {tab.dtype}, "
                                     f"B={idx.shape[0]})")
        cases += 1

    for d in (1, 3, 64, 100, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            tab = torch.from_numpy(rng.standard_normal(
                (4099, d)).astype(np.float32)).to(dev).to(dt)
            for b in (1, 7, 255, 4097):
                idx = rng.integers(-3, 4105, b).astype(np.int32)
                idx = torch.from_numpy(idx).to(dev)
                compare(tab, idx)
                compare(tab[1:], idx)            # base not 16-byte aligned
    compare(table, idx_main)

    n, d = table.shape
    b = idx_main.shape[0]
    uniq = int(torch.unique(idx_main.clamp(0, n - 1)).numel())
    nbytes = b * 4 + uniq * d * 4 + b * d * 4
    idx_lib = idx_main.clamp(0, n - 1).long()
    row = {
        "shape": [b, d],
        "ms": cuda_ms(torch, lambda: ops.gather_rows_cuda(table, idx_main)),
        "plain_ms": cuda_ms(torch, lambda: ops.gather_rows_plain(
            table, idx_main)),
        "library_ms": cuda_ms(torch, lambda: torch.index_select(
            table, 0, idx_lib)),
        "bound_ms": bound_ms(nbytes),
        "bytes": nbytes,
    }
    return worst, cases, row


def check_fused_kernel(torch, ops, dev, table, rng):
    """B3 cases: duplicate-heavy, all-unique and all-padding frontiers,
    B in {1, 61, 4097} (not multiples of 32), d in {64, 100, 128}, f32
    and bf16, an unaligned base, an id2index indirection; then the
    products shape, ``[139264, 100]`` f32 (the full capacity, 30 %
    padding).  Returns (max_abs_err, cases)."""
    worst, cases = 0.0, 0

    def compare(tab, ids, id2index=None):
        nonlocal worst, cases
        _, inv, uidx = ops.frontier_plan(ids, id2index)
        got = ops.fused_frontier_cuda(tab, uidx, inv)
        want = ops.fused_frontier_plain(tab, uidx, inv)
        torch.cuda.synchronize()
        if got.numel():
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        need(torch.equal(got, want), f"B3 differs from its plain version "
                                     f"({tuple(tab.shape)}, {tab.dtype}, "
                                     f"B={ids.shape[0]})")
        cases += 1

    n = 4099
    for d in (64, 100, 128):
        for dt in (torch.float32, torch.bfloat16):
            tab = torch.from_numpy(rng.standard_normal(
                (n + 1, d)).astype(np.float32)).to(dev).to(dt)
            for b in (1, 61, 4097):
                for ids in (rng.integers(-1, 40, b),       # duplicates
                            rng.permutation(n)[:b],        # all unique
                            np.full(b, -1)):               # all padding
                    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
                    compare(tab[:n], ids)
                    compare(tab[1:], ids)     # base not 16-byte aligned
            perm = torch.from_numpy(
                rng.permutation(n).astype(np.int32)).to(dev)
            compare(tab[:n], torch.from_numpy(rng.integers(
                -1, n, 3000).astype(np.int32)).to(dev), id2index=perm)
    full = TRAIN_BS * (1 + 15) + FRONTIER_CAP * (10 + 5)
    ids = np.full(full, -1, np.int64)
    live = int(full * 0.7)
    ids[:live] = rng.choice(PRODUCTS_N, live, replace=False)
    compare(table, torch.from_numpy(ids.astype(np.int32)).to(dev))
    return worst, cases


def time_fused_kernel(torch, ops, table, ids):
    """B3's kernel, plain and library times on one node list of the
    main path, and its bound: unique rows read once, every row written
    once, 8 B of indices per row."""
    _, inv, uidx = ops.frontier_plan(ids)
    b, d = ids.shape[0], table.shape[1]
    uniq = int((torch.unique(ids) >= 0).sum())
    need(uniq > 0, "B3 would be timed on an all-padding node list")
    nbytes = uniq * d * table.element_size() + b * d * table.element_size() \
        + 8 * b
    lib_idx = inv.clamp(min=0).long()
    valid = (inv >= 0)[:, None]
    return {
        "shape": [b, d],
        "unique_rows": uniq,
        "ms": cuda_ms(torch, lambda: ops.fused_frontier_cuda(
            table, uidx, inv)),
        "plain_ms": cuda_ms(torch, lambda: ops.fused_frontier_plain(
            table, uidx, inv)),
        "library_ms": cuda_ms(torch, lambda: torch.where(
            valid, table.index_select(0, uidx[lib_idx]), 0)),
        "bound_ms": bound_ms(nbytes),
        "bytes": nbytes,
    }


# -- phase 4: serving --------------------------------------------------------
def request_lists(rng, n):
    """Micro-batches of 1-100-seed requests, a few per bucket, with
    overlapping seeds."""
    hot = rng.integers(0, n, 64)
    lists = {8: [], 32: [], 128: []}
    for i in range(6):
        lists[8].append([hot[i:i + 3], rng.integers(0, n, 4)])
        lists[32].append([rng.integers(0, n, 10), hot[i:i + 12],
                          rng.integers(0, n, 1)])
        lists[128].append([rng.integers(0, n, 60), hot[:40],
                           rng.integers(0, n, 2)])
    return lists


def check_message(msg, indptr, indices, feat, labels):
    nb = msg["batch"].size
    node = msg["node"]
    need(np.array_equal(node[:nb], msg["batch"]), "seeds do not lead")
    need(len(np.unique(node)) == node.size, "request node list repeats")
    u = node[msg["col"]].astype(np.int64)          # seed side (source row)
    v = node[msg["row"]]                           # sampled neighbor
    e = msg["edge"].astype(np.int64)
    need(bool(((e >= indptr[u]) & (e < indptr[u + 1])).all()),
         "an edge id lies outside its source row")
    need(np.array_equal(indices[e], v), "an edge is not a CSR edge")
    need(np.array_equal(msg["x"], feat[node]), "features differ from table")
    need(np.array_equal(msg["y"], labels[node]), "labels differ")


def random_model(torch, GraphSAGE, dev, dtype=None, dropout_rate=0.5):
    """GraphSAGE with weights drawn from numpy seed 0 (no global RNG)."""
    model = GraphSAGE(FEAT_DIM, HIDDEN, CLASSES, num_layers=LAYERS,
                      dropout_rate=dropout_rate, dtype=dtype)
    rng = np.random.default_rng(0)
    state = {}
    for name, p in model.state_dict().items():
        fan_in = p.shape[-1] if p.dim() == 2 else p.shape[0]
        state[name] = torch.from_numpy(
            (rng.standard_normal(tuple(p.shape)) / np.sqrt(fan_in))
            .astype(np.float32))
    model.load_state_dict(state)
    return model.to(dev).eval()


def device_profile(torch, prof, n: int, wall: float) -> dict:
    """Per-unit device counts from a ``torch.profiler`` run over ``n``
    units (micro-batches or steps) of ``wall`` ms each: kernel launches
    and their device ms, device<->host copies and memsets apart from
    kernels, and the share of the wall time spent in kernels and
    copies."""
    cls = {"kernels": [0, 0.0], "copies": [0, 0.0], "memsets": [0, 0.0]}
    by_name = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = ("copies" if ev.name.startswith("Memcpy") else
                "memsets" if ev.name.startswith("Memset") else "kernels")
        ms = ev.device_time_total / 1e3
        cls[kind][0] += 1
        cls[kind][1] += ms
        c = by_name.setdefault((kind, ev.name[:80]), [0, 0.0])
        c[0] += 1
        c[1] += ms
    row = {"wall_ms": wall}
    for kind, (cnt, ms) in cls.items():
        row[kind] = cnt / n
        row[f"{kind}_ms"] = ms / n
    row["kernel_share"] = row["kernels_ms"] / wall
    row["copy_share"] = row["copies_ms"] / wall
    named = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    row["top_kernels"] = [
        {"name": name, "count": c / n, "ms": t / n}
        for (kind, name), (c, t) in named if kind == "kernels"][:8]
    row["copy_kinds"] = [
        {"name": name, "count": c / n, "ms": t / n}
        for (kind, name), (c, t) in named if kind == "copies"]
    return row


def profiler_activities(torch):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def profile_buckets(torch, engine, lists):
    """Serve PROFILED warm micro-batches per bucket under torch.profiler
    (see :func:`device_profile`)."""
    from torch.profiler import profile

    out = {}
    for bucket in BUCKETS:
        reqs_all = lists[bucket][-PROFILED:]
        torch.cuda.synchronize()
        with profile(activities=profiler_activities(torch)) as prof:
            t0 = time.perf_counter()
            for reqs in reqs_all:
                engine.scatter(engine.sample(
                    [engine.validate_seeds(r) for r in reqs]))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / len(reqs_all)
        out[bucket] = device_profile(torch, prof, len(reqs_all), wall)
    return out


def run_slice(torch, dev, indptr, indices, feat, labels, rng):
    from glt_tpu_torch.data import CSRTopo, Dataset, Graph
    from glt_tpu_torch.distributed import message_to_batch
    from glt_tpu_torch.models import GraphSAGE
    from glt_tpu_torch.ops import sample_neighbors_cuda, gather_rows_cuda
    from glt_tpu_torch.ops.neighbor_sample import draw_positions
    from glt_tpu_torch.serving import ServingOptions, SubgraphEngine
    from glt_tpu_torch import random as trandom

    topo = CSRTopo.from_csr_arrays(indptr, indices)
    ds = Dataset(graph=Graph(topo, device=dev), device=dev)
    ds.init_node_features(feat)
    ds.init_node_labels(labels)
    opts = dict(num_neighbors=FANOUTS, seed_buckets=BUCKETS)
    engine = SubgraphEngine(ds, ServingOptions(**opts))
    model = random_model(torch, GraphSAGE, dev)
    lists = request_lists(rng, PRODUCTS_N)
    torch.cuda.synchronize()

    # -- the main path: counts set to 0 just before, read just after ----
    sample_neighbors_cuda.launches = 0
    gather_rows_cuda.launches = 0
    first, lat, served, nmsg, logits_first = {}, {}, 0, 0, {}
    for bucket in BUCKETS:
        lat[bucket] = []
        for i, reqs in enumerate(lists[bucket]):
            t0 = time.perf_counter()
            seeds = [engine.validate_seeds(r) for r in reqs]
            coal = engine.sample(seeds)        # ends with the host copy
            t1 = time.perf_counter()
            msgs = engine.scatter(coal)
            t2 = time.perf_counter()
            lat[bucket].append(((t2 - t0) * 1e3, (t1 - t0) * 1e3,
                                (t2 - t1) * 1e3))
            need(coal.bucket == bucket, f"bucket {coal.bucket} != {bucket}")
            served += 1
            for m in msgs:
                check_message(m, indptr, indices, feat, labels)
                nmsg += 1
            outs = []
            with torch.no_grad():
                for m in msgs:
                    b = message_to_batch(m, device=dev)
                    out = model(b.x, b.edge_index, b.edge_mask)
                    need(tuple(out.shape) == (m["node"].size, CLASSES),
                         "logits shape")
                    need(bool(torch.isfinite(out).all()), "logits not finite")
                    outs.append(out)
            if i == 0:
                first[bucket] = (seeds, msgs)
                logits_first[bucket] = [o.cpu() for o in outs]
    torch.cuda.synchronize()
    launches = {"sample_neighbors_cuda": sample_neighbors_cuda.launches,
                "gather_rows_cuda": gather_rows_cuda.launches}


    # -- the same first micro-batch per bucket on the CPU: equal ---------
    cds = Dataset(graph=Graph(topo, device="cpu"), device="cpu")
    cds.init_node_features(feat)
    cds.init_node_labels(labels)
    cengine = SubgraphEngine(cds, ServingOptions(**opts))
    cmodel = random_model(torch, GraphSAGE, "cpu")
    logit_err = 0.0
    for bucket in BUCKETS:
        seeds, msgs = first[bucket]
        cmsgs = cengine.scatter(cengine.sample(seeds))
        need(len(cmsgs) == len(msgs), "CPU message count differs")
        for j, (a, b) in enumerate(zip(msgs, cmsgs)):
            need(sorted(a) == sorted(b), "CPU message keys differ")
            for k in a:
                need(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                     f"bucket {bucket}: CPU message differs at {k!r}")
            with torch.no_grad():
                cb = message_to_batch(b, device="cpu")
                ref = cmodel(cb.x, cb.edge_index, cb.edge_mask)
            got = logits_first[bucket][j]
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            logit_err = max(logit_err, err / max(scale, 1e-30))
            need(err <= 1e-4 * max(scale, 1.0),
                 f"bucket {bucket}: card and CPU logits differ by {err}")

    profiled = profile_buckets(torch, engine, lists)

    # -- the draw's share of a micro-batch ---------------------------------
    draw = {}
    g = ds.get_graph()
    for bucket in BUCKETS:
        widths = [bucket]
        for f in FANOUTS[:-1]:
            widths.append(widths[-1] * f)
        parts = []
        for w, f in zip(widths, FANOUTS):
            seeds = torch.from_numpy(rng.integers(
                0, PRODUCTS_N, w).astype(np.int32)).to(dev)
            deg = (g.indptr[seeds.long() + 1] - g.indptr[seeds.long()])
            key = trandom.PRNGKey(w, device=dev)
            parts.append(host_ms(torch, lambda: draw_positions(
                deg, f, key, False, seeds)))
        draw[bucket] = sum(parts)

    per_bucket = {}
    for bucket in BUCKETS:
        steady = lat[bucket][1:]            # the first call warms up
        med = statistics.median(t for t, _, _ in steady)
        per_bucket[str(bucket)] = {
            "latency_ms_median": med,
            "sample_ms_median": statistics.median(s for _, s, _ in steady),
            "scatter_ms_median": statistics.median(c for _, _, c in steady),
            "latency_ms_first": lat[bucket][0][0],
            "latency_ms_all": [t for t, _, _ in lat[bucket]],
            "draw_ms": draw[bucket],
            "draw_share": draw[bucket] / med,
            "profile": profiled[bucket],
        }
    return {"launches": launches, "micro_batches": served,
            "messages_checked": nmsg, "per_bucket": per_bucket,
            "cpu_logit_rel_err": logit_err}


# -- phase 5: training -------------------------------------------------------
def run_train(torch, dev, indptr, indices, feat, labels, rng):
    """The scanned epoch at the flagship settings through B1 and B3 (see
    the module docstring).  Returns the phase's report and one node list
    of the main path for B3's timing."""
    from glt_tpu_torch import ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.data import CSRTopo, Dataset, Graph
    from glt_tpu_torch.examples.train_sage_digits import seed_batches
    from glt_tpu_torch.loader import NeighborLoader
    from glt_tpu_torch.models import (
        GraphSAGE,
        adam,
        create_train_state,
        make_eval_step,
        make_gather_xy,
        make_scanned_node_train_step,
        node_seed_blocks,
        run_scanned_epoch,
    )
    from glt_tpu_torch.sampler import (
        NeighborSampler,
        NodeSamplerInput,
        calibrate_node_capacity,
    )
    from torch.profiler import profile

    topo = CSRTopo.from_csr_arrays(indptr, indices)
    ds = Dataset(graph=Graph(topo, device=dev), device=dev)
    ds.init_node_features(feat)
    ds.init_node_labels(labels)
    perm = rng.permutation(PRODUCTS_N)
    train_idx = perm[: TRAIN_BLOCKS * GROUP * TRAIN_BS]
    eval_idx = perm[-EVAL_BATCHES * TRAIN_BS:]
    skw = dict(batch_size=TRAIN_BS, frontier_cap=FRONTIER_CAP,
               with_edge=False)
    graph = ds.get_graph()

    # -- the main path: counts set to 0 just before, read just after ------
    ops.sample_neighbors_cuda.launches = 0
    ops.gather_rows_cuda.launches = 0
    ops.fused_frontier_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe = NeighborSampler(graph, FANOUTS, **skw)
    cal = [b for b, _ in zip(seed_batches(train_idx, TRAIN_BS,
                                          np.random.default_rng(42)),
                             range(CAL_BATCHES))]
    # Neighbor ids of this graph are uniform, so a batch's 139,264
    # candidate slots hold only ~3 % duplicates; the default 5 % margin
    # would round the cap up to the full capacity and leave the sampler
    # uncapped.  The p99 itself (margin 1.0) keeps it capped.
    node_cap = calibrate_node_capacity(probe, cal, margin=1.0)
    cal_s = time.perf_counter() - t0
    sampler = NeighborSampler(graph, FANOUTS, node_capacity=node_cap, **skw)
    need(sampler.capped, f"calibrated capacity {node_cap} is not below the "
                         f"full {sampler.full_node_capacity}")
    model = random_model(torch, GraphSAGE, dev, dtype=torch.bfloat16)
    state = create_train_state(model, adam(LR))
    step = make_scanned_node_train_step(sampler, ds.get_node_feature(),
                                        labels, TRAIN_BS, fused_frontier=True)
    base_key = trandom.PRNGKey(100, device=dev)
    stamps = [time.perf_counter()]
    state, losses, accs, ovf = run_scanned_epoch(
        step, state, train_idx, TRAIN_BS, GROUP, np.random.default_rng(5),
        base_key, on_block=lambda st, i: stamps.append(time.perf_counter()))
    need(losses.shape == (TRAIN_BLOCKS * GROUP,), "loss count")
    need(bool(np.isfinite(losses).all()), f"losses not finite: {losses}")
    ev = make_eval_step(TRAIN_BS)
    loader = NeighborLoader(ds, FANOUTS, eval_idx, sampler=sampler, **skw)
    eval_accs = [float(ev(state.model, b)[1]) for b in loader]
    torch.cuda.synchronize()
    launches = {"sample_neighbors_cuda": ops.sample_neighbors_cuda.launches,
                "gather_rows_cuda": ops.gather_rows_cuda.launches,
                "fused_frontier_cuda": ops.fused_frontier_cuda.launches}
    peak = torch.cuda.max_memory_allocated()
    block_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_ms = statistics.median(block_ms[1:]) / GROUP   # warm blocks

    # -- one more block under the profiler --------------------------------
    prof_idx = perm[-(EVAL_BATCHES + GROUP) * TRAIN_BS:
                    -EVAL_BATCHES * TRAIN_BS]          # 8 full batches
    blk = next(node_seed_blocks(prof_idx, TRAIN_BS, GROUP,
                                np.random.default_rng(6)))
    need(bool((blk >= 0).all()), "the profiled block holds padding")
    torch.cuda.synchronize()
    with profile(activities=profiler_activities(torch)) as prof:
        t1 = time.perf_counter()
        state, _, _, _ = step(state, blk, trandom.PRNGKey(7, device=dev))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / GROUP
    profiled = device_profile(torch, prof, GROUP, wall)

    # -- one block's x through B3 equals the plain gather ----------------
    rows = ds.get_node_feature().hot_rows
    lab = torch.from_numpy(labels.astype(np.int32)).to(dev)
    fused_xy, plain_xy = make_gather_xy(fused=True), make_gather_xy()
    keys = trandom.split(trandom.PRNGKey(8, device=dev), GROUP)
    for g in range(GROUP):
        out = sampler.sample_from_nodes(NodeSamplerInput(blk[g]), key=keys[g])
        xf, yf = fused_xy(rows, lab, out)
        xp, yp = plain_xy(rows, lab, out)
        need(torch.equal(xf, xp) and torch.equal(yf, yp),
             f"batch {g}: x through B3 differs from the plain gather")
        if g == 0:
            node_list = out.node

    # -- one step with dropout off: card and CPU give one loss ------------
    # The two devices' dropout generators differ, so dropout is off here.
    # Sampling and gathers agree bit for bit; the loss differs by the
    # summation order of index_add_ (nondeterministic on the card) and
    # of the bf16 matmuls, whose outputs round to 8 mantissa bits.
    first = next(node_seed_blocks(train_idx, TRAIN_BS, GROUP,
                                  np.random.default_rng(5)))
    one = np.full_like(first, -1)
    one[0] = first[0]
    pair = []
    for d in (dev, "cpu"):
        g = graph if d == dev else Graph(topo, device="cpu")
        s = NeighborSampler(g, FANOUTS, node_capacity=node_cap, **skw)
        m = random_model(torch, GraphSAGE, d, dtype=torch.bfloat16,
                         dropout_rate=0.0)
        fe = ds.get_node_feature() if d == dev else feat
        st = make_scanned_node_train_step(s, fe, labels, TRAIN_BS,
                                          fused_frontier=True)
        _, ls, _, _ = st(create_train_state(m, adam(LR)), one,
                         trandom.PRNGKey(100, device=d))
        pair.append(float(ls[0]))
    loss_err = abs(pair[0] - pair[1]) / max(abs(pair[1]), 1e-30)
    need(loss_err <= LOSS_RTOL, f"card loss {pair[0]} vs CPU {pair[1]}")
    return {
        "node_capacity": node_cap,
        "full_node_capacity": sampler.full_node_capacity,
        "calibrate_s": cal_s,
        "steps": int(losses.shape[0]),
        "overflow_batches": ovf,
        "losses": losses.tolist(),
        "train_acc_last_block": float(np.mean(accs[-GROUP:])),
        "eval_acc": eval_accs,
        "block_ms": block_ms,
        "step_ms_median": step_ms,
        "steps_per_s": 1e3 / step_ms,
        "max_memory_allocated": peak,
        "launches": launches,
        "launches_per_step": {k: v / losses.shape[0]
                              for k, v in launches.items()},
        "profile": profiled,
        "cpu_loss": pair[1],
        "card_loss": pair[0],
        "cpu_loss_rel_err": loss_err,
    }, node_list, rows


def run_digits(torch, dev) -> dict:
    """The digits twin with its defaults on the card."""
    from glt_tpu_torch.examples import train_sage_digits

    t0 = time.perf_counter()
    acc = train_sage_digits.main(DIGITS_ARGS + ["--device", str(dev)])
    need(acc > 0.93, f"digits accuracy {acc} <= 0.93")
    return {"test_acc": acc, "seconds": time.perf_counter() - t0}


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is missing ({exc})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    try:
        from glt_tpu_torch import ops
        from glt_tpu_torch import random as trandom
        from glt_tpu_torch.ops import cuda_lib
    except ImportError as exc:
        print(f"chip_smoke: glt_tpu_torch is not importable ({exc}); run "
              f"from the repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    os.makedirs(OUT_DIR, exist_ok=True)
    report = {}
    try:
        # 1. device
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        need(bool(smi), "nvidia-smi printed nothing")
        log(f"device: {kind} | count {torch.cuda.device_count()} | "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
        report["device"] = {"kind": kind, "nvidia_smi": smi[0]}

        # 2. build
        t0 = time.perf_counter()
        cuda_lib.library()
        report["build_s"] = time.perf_counter() - t0
        log(f"build: {report['build_s']:.2f} s (nvcc, sm_90a)")

        # products-scale data, made once
        t0 = time.perf_counter()
        indptr, indices = build_graph(0)
        drng = np.random.default_rng(1)
        feat = drng.standard_normal((PRODUCTS_N, FEAT_DIM), dtype=np.float32)
        labels = drng.integers(0, CLASSES, PRODUCTS_N).astype(np.int32)
        log(f"data: {PRODUCTS_N} nodes, {indices.size} edges, features "
            f"{feat.shape} made in {time.perf_counter() - t0:.1f} s")

        # 3. kernels against their plain versions
        rng = np.random.default_rng(2)
        pip = torch.from_numpy(indptr.astype(np.int32)).to(dev)
        pix = torch.from_numpy(indices.astype(np.int32)).to(dev)
        b1_err, b1_cases, b1 = check_sample_kernel(
            torch, ops, trandom, dev, (pip, pix), rng)
        table = torch.from_numpy(feat).to(dev)
        cap = BUCKETS[-1] * (1 + 15 + 150 + 750)
        main_idx = rng.integers(0, PRODUCTS_N, cap).astype(np.int32)
        main_idx[rng.random(cap) < 0.3] = 0          # padding reads row 0
        b2_err, b2_cases, b2 = check_gather_kernel(
            torch, ops, dev, table, torch.from_numpy(main_idx).to(dev), rng)
        b3_err, b3_cases = check_fused_kernel(torch, ops, dev, table, rng)
        del pip, pix, table
        log(f"kernels: B1 {b1_cases} cases equal, B2 {b2_cases} cases "
            f"equal, B3 {b3_cases} cases equal")
        for name, row in (("B1", b1), ("B2", b2)):
            log(f"  {name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
                f"ms, bound {row['bound_ms']:.4f} ms")

        # 4. serving
        t0 = time.perf_counter()
        sl = run_slice(torch, dev, indptr, indices, feat, labels, rng)
        report["slice"] = sl
        need(sl["launches"]["sample_neighbors_cuda"] > 0,
             "the serving path never launched B1")
        need(sl["launches"]["gather_rows_cuda"] > 0,
             "the serving path never launched B2")
        log(f"serving: {sl['micro_batches']} micro-batches, "
            f"{sl['messages_checked']} messages checked, CPU run equal, "
            f"launches {sl['launches']} ({time.perf_counter() - t0:.1f} s)")
        for b, row in sl["per_bucket"].items():
            log(f"  bucket {b}: median {row['latency_ms_median']:.2f} ms "
                f"(device stage {row['sample_ms_median']:.2f} ms, host "
                f"scatter {row['scatter_ms_median']:.2f} ms; first "
                f"{row['latency_ms_first']:.2f} ms), draw "
                f"{row['draw_ms']:.2f} ms = {row['draw_share']:.0%}")
            p = row["profile"]
            log(f"    profiled: wall {p['wall_ms']:.2f} ms, "
                f"{p['kernels']:.0f} kernels {p['kernels_ms']:.3f} ms "
                f"({p['kernel_share']:.1%}), {p['copies']:.0f} copies "
                f"{p['copies_ms']:.3f} ms ({p['copy_share']:.1%}), "
                f"{p['memsets']:.0f} memsets {p['memsets_ms']:.3f} ms")
            for c in p["copy_kinds"]:
                log(f"      {c['count']:.2f} x {c['name']}: {c['ms']:.3f} ms")

        # 5. training
        t0 = time.perf_counter()
        tr, node_list, rows = run_train(torch, dev, indptr, indices, feat,
                                        labels, rng)
        report["train"] = tr
        for k, v in tr["launches"].items():
            need(v > 0, f"the training path never launched {k}")
        b3 = time_fused_kernel(torch, ops, rows, node_list)
        del node_list, rows
        p = tr["profile"]
        log(f"training: {tr['steps']} steps in {TRAIN_BLOCKS} blocks of "
            f"{GROUP}, node capacity {tr['node_capacity']} of "
            f"{tr['full_node_capacity']}, {tr['overflow_batches']} overflow "
            f"batches, losses {tr['losses'][0]:.4f} -> "
            f"{tr['losses'][-1]:.4f} (finite), launches {tr['launches']} "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"  step: median {tr['step_ms_median']:.2f} ms over warm blocks "
            f"({tr['steps_per_s']:.2f} steps/s), peak memory "
            f"{tr['max_memory_allocated'] / 2**30:.2f} GiB; card vs CPU "
            f"loss {tr['card_loss']:.6f} vs {tr['cpu_loss']:.6f} (rel "
            f"{tr['cpu_loss_rel_err']:.2e}); x through B3 equal to the "
            f"plain gather")
        log(f"  profiled step: wall {p['wall_ms']:.2f} ms, "
            f"{p['kernels']:.0f} kernels {p['kernels_ms']:.3f} ms "
            f"({p['kernel_share']:.1%}), {p['copies']:.0f} copies "
            f"{p['copies_ms']:.3f} ms, {p['memsets']:.0f} memsets "
            f"{p['memsets_ms']:.3f} ms")
        log(f"  B3 {b3['shape']}: kernel {b3['ms']:.4f} ms, plain "
            f"{b3['plain_ms']:.4f} ms, library {b3['library_ms']:.4f} ms, "
            f"bound {b3['bound_ms']:.4f} ms")

        # 6. digits
        report["digits"] = run_digits(torch, dev)
        log(f"digits: test accuracy {report['digits']['test_acc']:.4f} "
            f"(> 0.93) in {report['digits']['seconds']:.1f} s")
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    launches = {k: sl["launches"].get(k, 0) + tr["launches"][k]
                for k in tr["launches"]}
    kernels = [
        {"name": "sample_neighbors_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/sample.cu",
         "replaces": "glt_tpu/ops/sample_pallas.py:162",
         "launches": launches["sample_neighbors_cuda"],
         "max_abs_err": b1_err, "ms": b1["ms"], "plain_ms": b1["plain_ms"],
         "bound_ms": b1["bound_ms"], "bound_by": "bytes",
         "library_ms": b1["library_ms"]},
        {"name": "gather_rows_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/gather.cu",
         "replaces": "glt_tpu/ops/gather_pallas.py:174",
         "launches": launches["gather_rows_cuda"],
         "max_abs_err": b2_err, "ms": b2["ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["bound_ms"], "bound_by": "bytes",
         "library_ms": b2["library_ms"]},
        {"name": "fused_frontier_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/fused_frontier.cu",
         "replaces": "glt_tpu/ops/fused_frontier.py:96",
         "launches": launches["fused_frontier_cuda"],
         "max_abs_err": b3_err, "ms": b3["ms"], "plain_ms": b3["plain_ms"],
         "bound_ms": b3["bound_ms"], "bound_by": "bytes",
         "library_ms": b3["library_ms"]},
    ]
    report["kernels"] = kernels
    report["kernel_detail"] = {"B1": b1, "B2": b2, "B3": b3}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(report["device"]["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
