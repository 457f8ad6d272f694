#!/usr/bin/env python3
"""Drive glt_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the repository root

Phases (the first failure exits non-zero and prints no result line):

1. device: the card's name, from nvidia-smi its name and power limit,
   and its SM clock (for the int32 rate of the bounds);
2. build: compile the CUDA kernels from ``glt_tpu_torch/csrc`` (nvcc);
3. kernels: each kernel (B1 one hop's draw and neighbor read, the
   threefry key-derivation kernel, B2 row gather, B3 fused frontier
   gather, B4 dequantizing row gather, B5 dequantizing fused frontier
   gather) against its plain PyTorch version on the card (``torch.equal``;
   B1 in its four draw modes and three edge-id modes at fanouts 1-40 over
   deg 0, < F, F, F + 1, hubs, padding, ids past the end, empty batches;
   B2/B3 also over int8 tables, B4/B5 over int8 and bf16 codes, d in {1,
   3, 64, 100, 128, 256}, constant columns, -0.0, subnormals, clamped
   ids, all-padding, all-duplicate and empty batches), then kernel, plain
   and library-call device times (CUDA events around 25 calls queued back
   to back, median of 5 rounds) at the main path's launches (B1: the
   three hops of bucket 128; B3 and B5: at the training phase's node
   list; B4: at a served bucket-128 node list, timed in phase 6), beside
   the least time the card could take (the larger of bytes over 3.35 TB/s
   and int32 operations over 132 x 64 lanes at the SM clock);
4. serving: a products-scale graph (2,449,029 nodes, power-law degrees
   of mean 25, seed 0; 100-wide f32 features; 47 classes) served by
   ``SubgraphEngine(ServingOptions(num_neighbors=(15, 10, 5),
   seed_buckets=(8, 32, 128)))``: ``warmup()`` captures one CUDA graph
   per bucket, then every micro-batch replays it.  Every message checked
   against the graph and the feature table, GraphSAGE (hidden 256, 3
   layers, 47 classes, random weights from seed 0) run on every served
   batch, and one micro-batch per bucket served again on the CPU (after
   the CPU engine's own ``warmup()``) and required equal; kernel launch
   counts are read around this phase (B1 once per hop in each bucket's
   warm-up and once into its graph, none in a replay; the hash kernel
   for each micro-batch's fold_in and each bucket's two hop splits; the
   plain threefry arithmetic never on the card).  Then per bucket one
   replayed micro-batch ``torch.equal`` to the eager route at the same
   key (node, row, col, edge_mask, x); PROFILED warm micro-batches per
   bucket under ``torch.profiler`` through the graph and through the
   eager route (the same stage launched op by op): host calls into the
   CUDA runtime, kernels and their device time, B1 counted by name (3 a
   replayed micro-batch), copies and memsets; and the medians of both
   routes over the same request lists;
5. training: the flagship configuration of
   ``examples/train_sage_products.py`` on the same graph (GraphSAGE,
   hidden 256, 3 layers, bf16 matmuls, dropout 0.5, Adam 1e-3; batch
   1024, fanout (15, 10, 5), frontier cap 8192, no edge ids): the node
   capacity calibrated on 8 batches (p99, no margin), a capped
   ``NeighborSampler``, the scanned epoch at G = 8 with the feature
   gather through B3 for 5 blocks (the first eager, the second
   captured into a CUDA graph, the rest replayed), then held-out
   batches through ``NeighborLoader`` (B1 + B2); kernel launch counts
   are read around this phase (the plain threefry arithmetic never on
   the card).  Losses must be finite.  One more block is replayed under
   ``torch.profiler`` (B1 3 times a step by name) and the same block
   run eagerly from copies of the same state (a fresh step): first
   losses within 1e-3 relative, all within ``LOSS_RTOL``; two more
   eager blocks are timed.  One block's ``x`` through B3 must equal the
   plain gather's; one step with dropout off must give the CPU's loss;
   three blocks with ``feature_cache=`` (eager, captured, replayed)
   whose replayed ``x`` equals the uncached gather bit for bit, with
   the cache's hit and miss counts; ``sample_from_nodes_batched`` at
   G = 8 replayed and ``torch.equal`` to 8 eager samples;
6. store: the products features written as an int8 and a bf16
   ``DiskFeatureStore`` under ``build/tmp`` (deleted at the end); the
   three buckets served over ``Feature.from_store(split_ratio=1.0)`` of
   each codec (B4) and over the raw f32 features, every message's ``x``
   equal to the host decode of its rows (``cpu_get``); every served int8
   node list gathered again at ``split_ratio=0.5`` (DRAM budget 1/8 of
   the int8 bytes, a 65,536-row cold cache) and required equal to split
   1.0; ``fused_frontier(dequant=int8)`` (B5) on the training node list
   equal to its plain version; then ``RefreshDriver`` over the whole
   graph from the int8 store (split 1.0, GraphSAGE hidden 256 x 3 with
   the random weights of seed 0, bf16 output stores, max degree 32,
   blocks of 8,192 nodes), two of its layer-0 sweeps recomputed on the
   CPU through the plain versions within 1e-5 relative; kernel launch
   counts are read around this phase;
7. digits: ``glt_tpu_torch.examples.train_sage_digits`` with its
   defaults on the card must clear ``acc > 0.93``; its weights evaluated
   on the raw features and through an int8 store at split 0.0 (stager +
   merge) and split 1.0 (B4) must agree within 0.005, the two int8
   evaluations' ``x`` bit for bit; launch counts are read around it;
8. link: the link-prediction and SEAL settings of
   ``examples/graph_sage_unsup_ppi.py`` and ``examples/seal_link_pred.py``
   on the products graph.  The column-sorted view built on the card and
   held to ``np.sort`` of SORT_ROWS rows (the 16 hubs included) and to
   the CPU's; ``edge_in_csr`` over 1,048,576 pairs (half real edges,
   padding, ids 0 and N - 1) equal to its 32-step plain version on the
   card; then, with the launch counts set to 0 just before and read just
   after: ``LinkNeighborLoader`` (binary x1, fanout (10, 10), 256 seed
   edges a batch, frontier cap 4096) for 4 batches (positives decode to
   their seed edges, ``edge_label`` follows the rules, ``x`` equals the
   rows, negatives that are real edges counted against the host CSR), a
   triplet x2 and a weighted binary batch, 4 blocks of the scanned link
   step at G = 8 (GraphSAGE 64/64, unsupervised dot-product loss) and 4
   blocks of the scanned subgraph step at the SEAL settings (fanout (8,
   8), max degree 16, 32 links a batch, GraphSAGE 32/32), each step's
   first block eager, the second captured into a CUDA graph (one capture
   a step), the rest replayed: B1 once per hop of every eager and
   captured sample, the plain threefry arithmetic never on the card.
   Then link batch 0 and subgraph batch 0 sampled again on the CPU and
   required equal, one link and one subgraph batch's loss on the CPU
   within F32_LOSS_RTOL (both steps run f32), that subgraph batch's
   induced edges exactly the real edges among its nodes within the
   degree cap; per step one replayed block and the same block eager
   from a copy of the state (a fresh step), both profiled, their losses
   within F32_LOSS_RTOL, then blocks timed in turns (eager, replayed,
   replayed, eager); and B2 timed at the link batch's node list;
9. hetero: the settings of ``examples/rgat_igbh.py`` (R-GAT, hidden 32,
   2 layers, 2 heads, fanout (4, 4), Adam 5e-3) on synthetic IGBH at
   scale 1,000 and of ``examples/train_hgt_mag.py`` (HGT, hidden 64, 4
   heads, dropout 0.3, fanout (5, 5), Adam 1e-3) on synthetic MAG at
   scale 490, built on the card by the port's dataset functions, 64 papers a
   batch.  Per model, with the launch counts set to 0 just before and
   read just after: 4 ``HeteroNeighborLoader`` batches (every valid edge
   of every reversed edge type a real edge of its forward type with its
   id, ``x`` equal to the rows, ``y`` to the labels) and 6 scanned blocks
   at G = 8 (eager, captured, replayed): B1 once per (hop, edge type) with
   a nonzero width in every sample (6 for R-GAT, 9 for HGT), B2 once per
   node type a batch, the plain threefry arithmetic never on the card.
   Then loader batch 0 sampled again on the CPU (every field
   ``torch.equal``), one batch's loss on the CPU from a copy of the state
   within F32_LOSS_RTOL, one replayed block against an eager block from
   copies of one state (first loss within F32_LOSS_RTOL, all within 1e-3)
   with both profiled (B1 by name per replayed step), HGT's attention mass
   per destination 1 or 0 within 1e-5, and B1 and B2 timed at this
   phase's shapes.  Then ``HeteroLinkNeighborLoader`` on MAG's writes
   (binary x 1, fanout (5, 5), 64 seed edges) for 4 batches: positives
   decode to their seed edges, negatives that are edges counted;
10. checkpoints and observability: phase 5's node step (capped at its
   calibrated capacity, B3 gather, bf16) on the products graph through
   ``glt_tpu_torch.ckpt.TrainLoop`` with a ``Tracer`` installed and
   metrics on, the train set cut to CKPT_BLOCKS blocks an epoch, a
   checkpoint every block, CKPT_EPOCHS epochs; with the launch counts set
   to 0 just before and read just after: the run without a kill (epoch
   by epoch: one capture of ``scanned_node_step`` in epoch 1, none in
   epoch 2), a ``SimulatedPreemption`` after block KILL_AT and a resume
   into a fresh model, optimizer and TrainLoop (one re-capture; the
   restored parameters and Adam's state equal to the killed run's at its
   kill; keys, seeds, a sampled batch and the cursor equal to the run
   without a kill, losses within LOSS_RTOL, the parameters' L2 gap to it
   within PARAM_DRIFT_X times a second run's, the largest differences
   printed; a planted fault, the same resume with Adam's state dropped,
   must fail both the state check and that gate); the SIGKILL leg:
   ``chip_smoke.py --ckpt-worker`` processes on a SMALL_N-node graph of
   the same recipe and widths (one straight through, one
   killed by ``FaultPlan(kill_at_train_step=WORKER_KILL_AT)``, one
   resumed from the store), the resumed losses within LOSS_RTOL of the
   straight run's; ``RefreshDriver(checkpointer=)`` on another such
   graph from an int8 store (split 1.0: B4), killed after one sweep and
   resumed, its rows within REFRESH_RTOL of a straight refresh, and a
   second straight refresh as the control (each layer's differing rows
   and sweeps printed for both).  B1, B3, the hash kernel and B4 must
   launch, the plain threefry never.  Then
   the save and resume medians (from the trace's ``ckpt.*`` spans) and a
   checkpoint's bytes, the ``glt.device.*`` gauges and the owner
   snapshot (no owner over ``memory_allocated()``, ``params`` at least
   three live models' parameters, a probe tensor claimed exactly while
   it lives and dropped after), the memcpy roofline against the
   datasheet, the span summary, one triggered
   ``torch.profiler`` capture and its flight index, and the host-clock
   ms of a replayed node step with tracing and metrics on and off (in
   turns);
11. distributed: ``examples/dist_train_papers100m.py``'s settings at
   DIST_SCALE (``sample_prob`` of every rank on the card, rank 0 within
   1e-6 of the CPU's; ``FrequencyPartitioner``; ``DistDataset.load`` on
   the card and the CPU, CHECK_ROWS rows held to the host arrays), 4
   shards on ``cuda:0``, batch 128 a shard, fanout (12, 10), GraphSAGE
   256 x 2, B3 serving.  With the launch counts set to 0 just before and
   read just after: DIST_STEPS eager steps (B1 8 and B3 4 a step, the
   loss falling); step 0's batch and loss against the CPU; the route,
   dedup, B3 and capped variants against their counterparts; two capped
   steps (B1 16 a step); a warm step's host syncs (none); one profiled
   step.  Then the scanned step at G = GROUP: with the counts set to 0
   just before and read just after, DIST_SCAN_BLOCKS blocks (eager,
   captured, replays; B1 8 and B3 4 a slot in the eager block, none in
   a replay, one capture); the first block's slot 0 against the CPU's
   scanned step within F32_LOSS_RTOL; one replayed block and the same
   block eager from a copy of the state, both profiled (B1 8 a replayed
   step by name), their losses within F32_LOSS_RTOL;
12. the example twins, each through its entry point with the launch
   counts set to 0 just before and read just after:
   ``train_sage_products`` at its widths (batch 1024, fanout (15, 10,
   5), hidden 256, bf16) on TWIN_PRODUCTS_SCALE of the products graph,
   three scanned epochs (two blocks an epoch, captured in the second
   epoch, replayed in the third) and one loader epoch;
   ``bipartite_sage_unsup`` and ``dist_train_sage`` (8 shards on the
   card) at their defaults for TWIN_EPOCHS epochs: every loss finite,
   the bipartite loss falling, the plain threefry never on the card;
13. features that outgrow the card: phase 11's partition loaded by
   ``DistDataset.load(hot_ratio=0.25)`` (the JAX example's default; a
   quarter of each shard's rows on the card, the rest in host memory;
   its rows equal to the whole load's), the twin's
   ``TieredTrainPipeline`` at phase 11's settings (B3 serving the hot
   rows, the default cold_cap of twice the node capacity).  Step 0's
   stage outputs (sample, compact slots, cold ids, drops) equal the
   CPU's, its tiered gather the hot_ratio-1.0 gather of phase 11, and
   at cold_cap TIERED_SMALL_CAP the card and the CPU drop the same
   requests, served as zero rows; B3 timed at shard 0's hot requests.
   With the launch counts set to 0 just before and read just after:
   TIERED_STEPS batches of one epoch (B1 8 and B3 4 in the eager batch
   and in each graph's capture, one capture of the stage and of the
   train step, the loss falling, no drops), step 0's loss within
   F32_LOSS_RTOL of the CPU's, the step time from the host's stamps of
   the train calls, peak memory.  Then 3 replayed steps profiled (B1 8,
   B3 4 and 2 graph launches a step by name), 3 under the sync debug
   mode (no sync on the main thread), and one step's parts timed alone
   (sample+route, train, id fetch, host gather, H2D copy) for the
   overlap.  The disk tier on a DISK_SCALE graph of the same recipe (a
   raw store, a DRAM budget of an eighth of the cold bytes): staged rows
   equal to HostColdStore's, DISK_STEPS losses within TIERED_DRIFT_RTOL.
   Then on the same mesh ``sample_from_edges`` (binary x1, strict and
   not) and ``subgraph`` equal to the CPU's, no strict negative an edge,
   the induced edges CSR edges;
14. the distributed path whole: phase 9's synthetic IGBH (built on the
   host) on DW_SHARDS shards of the card, the rgat_igbh twin's
   ``--distributed`` settings (batch 64 a shard, fanout (4, 4), frontier
   cap 512, R-GAT 32 x 2, GAT, dropout 0, Adam 5e-3): two batches of
   ``DistHeteroNeighborSampler`` equal to the CPU's; with the launch
   counts set to 0 just before and read just after, DW_STEPS steps of
   ``make_hetero_dist_train_step`` (eager, captured, replays: B1 24 in
   the eager step and in the capture, none in a replay, one capture);
   step 0's loss within F32_LOSS_RTOL of the CPU's; eager and replayed
   steps in turns from one state, the first pair profiled on one batch
   (their losses within F32_LOSS_RTOL; B1 24 by name in the replay);
   3 replayed steps under the sync debug mode (no sync); peak memory.
   Then the tiered leg: paper rows at DW_TIER_RATIO a shard on the card,
   ``HeteroTieredTrainPipeline`` and a full-HBM pipeline from one state
   for DW_TIERED_STEPS batches (losses within TIERED_DRIFT_RTOL, no
   drops, one capture of the stage and of the train step, B1 24 in the
   eager batch and in the stage's capture), 3 replayed batches profiled
   (2 graph launches a step), and one warm step's parts alone for the
   overlap.  Then phase 11's partition on a 2 x 2 mesh: a batch's
   sampled ids and gathered rows (B3 serving) ``torch.equal`` between
   ``route='hier'`` and ``'flat'``; per route 3 scanned blocks (eager,
   captured, replayed; B1 8 and B3 4 a slot eager), their first losses
   within F32_LOSS_RTOL, the byte model's ICI and DCN bytes; the hetero
   step on a 2 x 2 mesh, its hier batch ``==`` the flat one and the
   losses within F32_LOSS_RTOL; a ``collective='ring'`` batch ``==`` the
   CPU's;
15. the kernel line ``{"kernels": [...]}`` (launches summed over phases
   4-14) and the ok line.

Details go to ``build/results/chip_smoke.json`` (phase 10's trace to
``build/results/phase10_trace.json``).  Imports torch, numpy and
glt_tpu_torch only.  Every profiled window starts with
PROFILER_SETTLE_S of idle time: the profiler can lose the device records
of work launched just after it starts.  ``python3 chip_smoke.py
--profiler-settle-check N`` counts those losses over N windows per
bucket, with and without the settle time, and runs no phase.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published peak
INT32_LANES = 132 * 64             # H100 SXM: SMs x INT32 lanes per SM
HASH_OPS = 80                      # threefry2x32 (csrc/threefry.cuh) + xor
DRAW_OPS = 2 * HASH_OPS + 8        # randint_span: two words, the reduction
FANOUTS = (15, 10, 5)
BUCKETS = (8, 32, 128)
FEAT_DIM, CLASSES, HIDDEN, LAYERS = 100, 47, 256, 3
PRODUCTS_N, AVG_DEG = 2_449_029, 25
REPS = 25
B1_READ_ONLY_MS = 0.00489         # the earlier read-only B1 at [19200, 5] (PERF.md)
PROFILED = 3                      # micro-batches per bucket under the profiler
PROFILER_SETTLE_S = 0.1           # idle time after the profiler starts (see profiled)
# Training phase: examples/train_sage_products.py's flagship settings.
TRAIN_BS, FRONTIER_CAP, GROUP, LR = 1024, 8192, 8, 1e-3
TRAIN_BLOCKS, CAL_BATCHES, EVAL_BATCHES = 5, 8, 2
CACHE_ROWS = 1 << 18              # the cached block's feature cache
LOSS_RTOL = 1e-2                  # card vs CPU loss, bf16 matmuls (see run_train)
F32_LOSS_RTOL = 1e-5              # card vs CPU link/subgraph loss (f32 matmuls)
DIGITS_ARGS = []                  # the digits twin's defaults
DIGITS_INT8_TOL = 0.005           # tests/test_real_digits.py:157
STORE_CODECS = ("int8", "bf16")
DEQUANT_WIDTHS = (1, 3, 64, 100, 128, 256)
COLD_CACHE_ROWS = 1 << 16         # split-0.5 gather's device cold cache
REFRESH_BLOCK, REFRESH_MAX_DEGREE = 8192, 32
REFRESH_RTOL = 1e-5               # card vs CPU layer-0 rows (f32 sums)
# Link phase: examples/graph_sage_unsup_ppi.py's settings (GraphSAGE
# 64/64, 2 layers; fanout (10, 10); 256 seed edges a batch, one binary
# negative each; frontier cap 4096; Adam 1e-3; G = 8) and
# examples/seal_link_pred.py's (fanout (8, 8), max degree 16, 32 links
# a batch, GraphSAGE 32/32, G = 8), on the products-scale graph.
LINK_FANOUT, LINK_BS, LINK_CAP, LINK_HIDDEN = (10, 10), 256, 4096, 64
LINK_BATCHES, LINK_BLOCKS = 4, 4
SEAL_FANOUT, SEAL_BS, SEAL_DEGREE, SEAL_HIDDEN = (8, 8), 32, 16, 32
SEAL_BLOCKS = 4
# Heterogeneous phase: examples/rgat_igbh.py's settings (R-GAT hidden 32,
# 2 layers, 2 heads, GAT convs, dropout 0, fanout (4, 4), Adam 5e-3) on
# synthetic IGBH at scale 1,000 (IGBH-small's 1,000,000 papers) and
# examples/train_hgt_mag.py's (HGT hidden 64, 4 heads, 2 layers, dropout
# 0.3, fanout (5, 5), Adam 1e-3) on synthetic MAG at scale 490 (735,000
# papers, ogbn-mag's 736,389); batches of 64 papers, G = 8.
HETERO = {
    "rgat": {"dataset": "synthetic_igbh", "scale": 1000, "fanout": (4, 4),
             "lr": 5e-3, "b1_per_step": 6, "seed": 31},
    "hgt": {"dataset": "synthetic_mag", "scale": 490, "fanout": (5, 5),
            "lr": 1e-3, "b1_per_step": 9, "seed": 32},
}
HET_BS, HET_BATCHES, HET_BLOCKS = 64, 4, 6
HGT_HIDDEN, HGT_HEADS = 64, 4
EDGE_PAIRS, SORT_ROWS = 1 << 20, 4096
# Checkpoint and observability phase: phase 5's node step through
# TrainLoop, the train set cut to CKPT_BLOCKS full blocks an epoch (no
# partial block, so epoch 2 replays only patterns epoch 1 captured).
CKPT_BLOCKS, CKPT_EPOCHS, KILL_AT = 3, 2, 4
# A resumed run's parameters may sit at most PARAM_DRIFT_X times as far
# (L2, relative to how far training moved them) from the run without a
# kill as a second run without a kill does; PARAM_GAP_FLOOR stands in
# for that control when the card happens to repeat a run bit for bit
# (a replayed block and its eager twin differ by ~1e-6, PERF.md).
PARAM_DRIFT_X, PARAM_GAP_FLOOR = 4.0, 1e-6
# The owner census's probe, and how far the caching allocator may round
# an allocation of that size (an unsplit cached block, < 2 MiB more).
PROBE_BYTES, ALLOC_ROUNDING = 64 << 20, 2 << 20
# The SIGKILL worker and the refresh leg: a graph of SMALL_N nodes made
# by the products recipe (same degrees law, widths and model), so each
# worker process builds it in seconds; WORKER_BLOCKS blocks an epoch.
SMALL_N, WORKER_BLOCKS, WORKER_KILL_AT = 200_000, 2, 3
OBS_TIMED_TURNS = ("off", "on", "on", "off")
WORK_DIR = os.path.join("build", "tmp")
SLEEP_CYCLES = 40_000_000         # ~20 ms at the H100's 1.98 GHz
OUT_DIR = os.path.join("build", "results")
# Distributed phase: examples/dist_train_papers100m.py's settings on its
# synthetic graph at --scale 0.02 (2,221,199 nodes), --devices 4 as 4
# shards on one card, --hot-ratio 1.0: 128-wide f32 features, 172
# classes, batch 128 a shard, fanout (12, 10), GraphSAGE hidden 256 x 2,
# dropout 0, Adam 1e-3; CHECK_ROWS loaded rows held to the host arrays.
DIST_SHARDS, DIST_SCALE, DIST_DIM, DIST_CLASSES = 4, 0.02, 128, 172
DIST_BS, DIST_FANOUT, DIST_STEPS = 128, (12, 10), 20
DIST_LOAD_FACTOR, CHECK_ROWS = 2.0, 2048
# The scanned distributed step: DIST_SCAN_BLOCKS blocks of GROUP slots
# (eager, captured, replays), then one more replayed and eager block.
DIST_SCAN_BLOCKS = 5
# The example twins at their own widths, cut in depth: the products twin
# at TWIN_PRODUCTS_SCALE (12 batches of 1024, two blocks an epoch) for
# 3 scanned epochs (eager, captured, replayed) and 1 loader epoch; the
# bipartite and dist_train_sage twins at their defaults for 2 epochs.
TWIN_PRODUCTS_SCALE, TWIN_EPOCHS = 0.05, 2
# Features that outgrow the card: phase 11's partition loaded at the JAX
# example's --hot-ratio 0.25 and trained through TieredTrainPipeline for
# TIERED_STEPS batches; a leg at cold_cap TIERED_SMALL_CAP; the disk
# tier on a ~SMALL_N-node graph of the same recipe (DISK_SCALE) for
# DISK_STEPS batches, its losses within TIERED_DRIFT_RTOL of the host
# tier's (two runs' drift on the card, index_add_ atomics: PERF.md §7);
# subgraphs at SUB_MAX_DEGREE, SUB_CHECK_EDGES induced edges a shard
# checked against the CSR.
TIERED_RATIO, TIERED_STEPS, TIERED_SMALL_CAP = 0.25, 24, 2048
DISK_SCALE, DISK_STEPS, TIERED_DRIFT_RTOL = 0.0018, 6, 8.574e-04
SUB_MAX_DEGREE, SUB_CHECK_EDGES = 32, 2000
# The distributed path whole: the rgat_igbh twin's --distributed settings
# (batch 64 a shard, fanout (4, 4), frontier cap 512, R-GAT 32 x 2, GAT,
# dropout 0, Adam 5e-3) on DW_SHARDS shards of phase 9's synthetic IGBH;
# DW_STEPS steps (eager, captured, replays); the tiered leg at
# DW_TIER_RATIO of each shard's papers on the card for DW_TIERED_STEPS
# batches; B1 DW_B1_PER_STEP times a step (6 a shard's sample).
DW_SHARDS, DW_BS, DW_FANOUT, DW_CAP, DW_LR = 4, 64, (4, 4), 512, 5e-3
DW_STEPS, DW_TIERED_STEPS, DW_TIER_RATIO = 12, 8, 0.25
DW_BATCHES, DW_B1_PER_STEP = 24, 24
DEVICE = "cuda"


def count_plain_hashes(trandom):
    """Wrap the plain threefry arithmetic (the core of the plain draw and
    of the plain key derivation) so that its calls on CUDA tensors count
    in ``.calls``: on the card, the main paths make none."""
    inner = trandom.threefry2x32

    def counted(k1, k2, x1, x2):
        counted.calls += int(x2.is_cuda)
        return inner(k1, k2, x1, x2)

    counted.calls = 0
    trandom.threefry2x32 = counted
    return counted


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


def build_graph(seed: int = 0, n: int = PRODUCTS_N):
    rng = np.random.default_rng(seed)
    deg = powerlaw_degrees(n, AVG_DEG, rng)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]), dtype=np.int64)
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
def edge_case_graph(rng, fanout):
    """Small CSR with degree 0, degree < fanout, degree F - 1, F and
    F + 1, and a hub row; seeds with padding and ids past the end."""
    n = 2048
    deg = rng.integers(0, 30, n)
    special = [0, 3, 5000, 1, max(fanout - 1, 0), fanout, fanout + 1]
    deg[:len(special)] = special
    deg[-1] = 0
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n, int(indptr[-1]))
    edge_ids = rng.permutation(int(indptr[-1]))
    seeds = np.concatenate([
        np.arange(len(special)), [n - 1, -1, 2, 2, n, n + 7],
        rng.integers(0, n, 300), np.full(8, -1)]).astype(np.int32)
    return indptr, indices, edge_ids, seeds


def b1_work(ip, frontier, fanout, mask):
    """B1's least work at one hop of the main path (keyed by slot, no
    replacement, positional edge ids), counted from this run's data:
    bytes (seeds, two indptr words a row, 4 B of ``indices`` per valid
    slot, 9 B of output a slot, the key) and int32 operations (the block
    keys' hashes, two hashes and the span reduction per drawn slot of a
    row above the fanout, Floyd's duplicate test)."""
    w = frontier.shape[0]
    f = fanout
    valid = int(mask.sum())
    live = int((frontier >= 0).sum())
    s = frontier.long().clamp(min=0).clamp(max=ip.shape[0] - 2)
    deg = (ip[s + 1] - ip[s]) * (frontier >= 0)
    big = int((deg > f).sum())
    group = min(32, 1 << (f - 1).bit_length())
    blocks = -(-w // (256 // group))
    nbytes = w * 4 + live * 8 + valid * 4 + w * f * 9 + 16
    ops = (blocks * 3 * f * HASH_OPS + big * f * DRAW_OPS
           + big * f * f * 2)
    return nbytes, ops


def int_ops_ms(ops: int, sm_mhz: float) -> float:
    return ops / (INT32_LANES * sm_mhz * 1e6) * 1e3


def bound_of(nbytes: int, ops: int, sm_mhz: float):
    """(bound ms, what binds): the larger of bytes over HBM's rate and
    int32 operations over the card's INT32 rate."""
    b, o = bound_ms(nbytes), int_ops_ms(ops, sm_mhz)
    return (b, "bytes") if b >= o else (o, "operations")


def check_sample_kernel(torch, ops, trandom, dev, products, rng, sm_mhz):
    """B1 (draw and read in one launch) against its plain version: four
    draw modes x three edge-id modes x fanouts (1, 5, 15, 32, 33, 40) on
    the degree cases, an all-padding and an empty batch; then the main
    path's three hop shapes of bucket 128 on the products graph, timed
    against the plain draw + read on the card.  Returns (max_abs_err,
    cases, timing row)."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    worst, cases = 0, 0

    def compare(ip, ix, eid, seeds, fanout, key, **kw):
        nonlocal worst, cases
        got = ops.sample_neighbors_cuda(ip, ix, seeds, fanout, key,
                                        edge_ids=eid, **kw)
        want = ops.sample_neighbors_plain(ip, ix, seeds, fanout, key,
                                          edge_ids=eid, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            need((g is None) == (w is None), "B1 edge-id presence differs")
            if g is None:
                continue
            err = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            worst = max(worst, err)
            need(torch.equal(g, w), f"B1 differs from its plain version "
                                    f"(fanout {fanout}, rows {g.shape[0]}, "
                                    f"{kw})")
        cases += 1
        return want

    for fanout in (1, 5, 15, 32, 33, 40):
        indptr, indices, edge_ids, seeds = edge_case_graph(rng, fanout)
        ip, ix, ei = t(indptr), t(indices), t(edge_ids)
        key = trandom.PRNGKey(fanout, device=dev)
        for sd in (seeds, np.full(64, -1), seeds[:0]):
            sd = t(sd)
            for replace in (False, True):
                for key_by in ("slot", "id"):
                    for eid, with_edge in ((None, False), (None, True),
                                           (ei, True)):
                        compare(ip, ix, eid, sd, fanout, key,
                                with_replacement=replace,
                                with_edge=with_edge, key_by=key_by)

    pip, pix = products
    row = {"per_hop": []}
    widths = [BUCKETS[-1]]
    for f in FANOUTS[:-1]:
        widths.append(widths[-1] * f)
    for w, f in zip(widths, FANOUTS):
        frontier = t(rng.integers(0, PRODUCTS_N, w))
        key = trandom.PRNGKey(w, device=dev)
        want = compare(pip, pix, None, frontier, f, key)
        nbytes, nops = b1_work(pip, frontier, f, want.mask)
        bound, by = bound_of(nbytes, nops, sm_mhz)
        flat = want.eids.reshape(-1).clamp(min=0).long()   # CSR positions
        hop = {
            "shape": [w, f],
            "ms": cuda_ms(torch, lambda: ops.sample_neighbors_cuda(
                pip, pix, frontier, f, key)),
            "plain_ms": cuda_ms(torch, lambda: ops.sample_neighbors_plain(
                pip, pix, frontier, f, key), reps=5, rounds=3),
            # No single PyTorch call draws and reads; torch.take of the
            # read alone, beside it.
            "take_read_ms": cuda_ms(torch, lambda: torch.take(pix, flat)),
            "bound_ms": bound,
            "bound_by": by,
            "bytes": nbytes,
            "int_ops": nops,
        }
        row["per_hop"].append(hop)
    row.update(row["per_hop"][-1])
    row["library_ms"] = None
    return worst, cases, row


def check_hash_kernel(torch, ops, trandom, dev, rng, sm_mhz):
    """The key-derivation kernel against its plain version on the card:
    split (the iota), fold_in of a tensor (int32, int64) and of a Python
    int, over key batches; then its time at the sampler's split(key, 3).
    Returns (cases, timing row)."""
    cases = 0
    for k in (1, 3, 257):
        words = torch.from_numpy(rng.integers(0, 2**32, (k, 2))).to(dev)
        for kw in (dict(n=1), dict(n=3), dict(n=1000), dict(data=0),
                   dict(data=2**31 + 7), dict(data=-1),
                   dict(data=torch.from_numpy(rng.integers(
                       -2**31, 2**31, 99)).to(dev)),
                   dict(data=torch.from_numpy(rng.integers(
                       0, PRODUCTS_N, 99).astype(np.int32)).to(dev))):
            got = ops.threefry_hash_cuda(words, **kw)
            want = ops.threefry_hash_plain(words, **kw)
            torch.cuda.synchronize()
            need(torch.equal(got, want),
                 f"the hash kernel differs from its plain version ({k} "
                 f"keys, {sorted(kw)})")
            cases += 1
    key = trandom.PRNGKey(0, device=dev)[None]
    nbytes, nops = 16 + 3 * 16, 3 * HASH_OPS
    bound, by = bound_of(nbytes, nops, sm_mhz)
    return cases, {
        "shape": [1, 3],
        "ms": cuda_ms(torch, lambda: ops.threefry_hash_cuda(key, n=3)),
        "plain_ms": cuda_ms(torch, lambda: ops.threefry_hash_plain(key, n=3)),
        "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "int_ops": nops, "library_ms": None,
    }


def check_gather_kernel(torch, ops, dev, table, idx_main, rng):
    """B2 cases: d in {1, 3, 64, 100, 128, 256}, f32, bf16 and int8,
    ragged batches, an unaligned base; then the main path's feature
    gather."""
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
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            tab = torch.from_numpy(rng.standard_normal(
                (4099, d)).astype(np.float32) * 40).to(dev).to(dt)
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
    B in {1, 61, 4097} (not multiples of 32), d in {64, 100, 128}, f32,
    bf16 and int8, an unaligned base, an id2index indirection; then the
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
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            tab = torch.from_numpy(rng.standard_normal(
                (n + 1, d)).astype(np.float32) * 40).to(dev).to(dt)
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


def compressed_table(torch, quant, codec, n, d, rng):
    """``(codes [n, d], sz [8, d])`` on the CPU covering the decode's edge
    cases: an encoded matrix with a constant column (scale 0), signed
    zeros and a subnormal column; for int8 also raw codes over the full
    range -128..127 with a subnormal and a negative scale in ``sz``; for
    bf16 also random finite bit patterns (subnormals included)."""
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    x[:, 0] = 1.25
    x[::5, d // 2] = -0.0
    x[:, d - 1] = rng.standard_normal(n).astype(np.float32) * 1e-39
    enc, spec = quant.encode(x, codec)
    sz = quant.scale_zero_rows(spec, d)
    half = n // 2
    if codec == "int8":
        enc[half:] = rng.integers(-128, 128, (n - half, d))
        if d > 2:
            sz[0, 1] = 1e-41                # a subnormal scale
            sz[0, 2] = -0.5                 # a negative scale: zero
        return torch.from_numpy(enc), torch.from_numpy(sz)
    bits = rng.integers(0, 2**16, (n - half, d)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF   # no inf or NaN
    enc[half:] = bits
    return quant.host_to_torch(enc), torch.from_numpy(sz)


def dequant_ids(kind, n, b, rng):
    if kind == "ragged":
        ids = rng.integers(-1, n, b)
    elif kind == "all_padding":
        ids = np.full(b, -1)
    elif kind == "all_duplicates":
        ids = np.full(b, min(5, n - 1))
    else:                                   # ids past N clamp
        ids = rng.integers(-1, n + 50, b)
    return ids.astype(np.int32)


def check_dequant_kernels(torch, ops, quant, dev, rng):
    """B4 and B5 cases, ``torch.equal`` on the f32 bits: codecs int8 and
    bf16, d in {1, 3, 64, 100, 128, 256}, constant columns (scale 0),
    -0.0 and subnormals, ragged, all-padding, all-duplicate and clamped
    ids, empty and ragged batches, an unaligned base.  Returns
    ``({"B4": err, "B5": err}, {"B4": cases, "B5": cases})``."""
    worst, cases = {"B4": 0.0, "B5": 0.0}, {"B4": 0, "B5": 0}

    def compare(name, got, want, what):
        torch.cuda.synchronize()
        if got.numel():
            worst[name] = max(worst[name],
                              float((got - want).abs().max()))
        need(got.dtype == torch.float32 and torch.equal(
            got.view(torch.int32), want.view(torch.int32)),
            f"{name} differs from its plain version ({what})")
        cases[name] += 1

    n = 4099
    for codec in STORE_CODECS:
        for d in DEQUANT_WIDTHS:
            tab, sz = compressed_table(torch, quant, codec, n + 1, d, rng)
            tab, sz = tab.to(dev), sz.to(dev)
            for b in (0, 61, 4097):
                for kind in ("ragged", "all_padding", "all_duplicates",
                             "clamped"):
                    ids = torch.from_numpy(dequant_ids(kind, n, b, rng)).to(
                        dev)
                    _, inv, uidx = ops.frontier_plan(ids)
                    for t in (tab[:n], tab[1:]):   # [1:]: unaligned base
                        what = f"{codec}, d={d}, B={b}, {kind}"
                        compare("B4", ops.gather_rows_dequant_cuda(t, ids, sz),
                                ops.gather_rows_dequant_plain(t, ids, sz),
                                what)
                        compare("B5", ops.fused_frontier_dequant_cuda(
                            t, uidx, inv, sz), ops.fused_frontier_dequant_plain(
                            t, uidx, inv, sz), what)
    return worst, cases


def time_gather_dequant(torch, ops, quant, table, sz, node):
    """B4's kernel, plain and library times on one served node list (the
    feature gather's ids: padding reads row 0), and its bound: the
    unique compressed rows read once, every f32 row written once, 4 B of
    index per row and the three ``sz`` rows."""
    idx = torch.where(node >= 0, node, 0).to(torch.int32).contiguous()
    b, d = idx.shape[0], table.shape[1]
    uniq = int(torch.unique(idx).numel())
    nbytes = b * 4 + uniq * d * table.element_size() + 3 * d * 4 + b * d * 4
    lib_idx = idx.long()
    return {
        "shape": [b, d], "dtype": str(table.dtype).replace("torch.", ""),
        "unique_rows": uniq,
        "ms": cuda_ms(torch, lambda: ops.gather_rows_dequant_cuda(
            table, idx, sz)),
        "plain_ms": cuda_ms(torch, lambda: ops.gather_rows_dequant_plain(
            table, idx, sz)),
        "library_ms": cuda_ms(torch, lambda: quant.dequantize_rows(
            table.index_select(0, lib_idx), sz)),
        "bound_ms": bound_ms(nbytes),
        "bytes": nbytes,
    }


def time_fused_dequant(torch, ops, quant, table, sz, ids):
    """B5's kernel, plain and library times on one node list, and its
    bound: unique compressed rows read once, every f32 row written once,
    8 B of indices per row and the three ``sz`` rows."""
    _, inv, uidx = ops.frontier_plan(ids)
    b, d = ids.shape[0], table.shape[1]
    uniq = int((torch.unique(ids) >= 0).sum())
    need(uniq > 0, "B5 would be timed on an all-padding node list")
    nbytes = uniq * d * table.element_size() + b * d * 4 + 8 * b + 3 * d * 4
    lib_idx = inv.clamp(min=0).long()
    valid = (inv >= 0)[:, None]
    return {
        "shape": [b, d], "dtype": str(table.dtype).replace("torch.", ""),
        "unique_rows": uniq,
        "ms": cuda_ms(torch, lambda: ops.fused_frontier_dequant_cuda(
            table, uidx, inv, sz)),
        "plain_ms": cuda_ms(torch, lambda: ops.fused_frontier_dequant_plain(
            table, uidx, inv, sz)),
        "library_ms": cuda_ms(torch, lambda: torch.where(
            valid, quant.dequantize_rows(
                table.index_select(0, uidx[lib_idx]), sz), 0.0)),
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
    units (micro-batches or steps) of ``wall`` ms each: kernels run and
    their device ms, device<->host copies and memsets apart from
    kernels, the share of the wall time spent in kernels and copies, and
    the host's calls into the CUDA runtime (all of them, and those that
    launch work: kernels, graphs, copies, memsets)."""
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
    calls = runtime_calls(torch, prof)
    row["runtime_calls"] = sum(calls.values()) / n
    row["launch_calls"] = launch_calls(calls) / n
    row["runtime_call_kinds"] = {k: v / n for k, v in sorted(
        calls.items(), key=lambda kv: -kv[1])[:8]}
    return row


def profiler_activities(torch):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def settle_profiler(torch, settle_s: float = PROFILER_SETTLE_S) -> None:
    """Let a just-started profiler reach the card before measured work.
    Device records of work launched in the first milliseconds after the
    start are sometimes lost, every kernel of a graph replay at once
    (``--profiler-settle-check`` counts how often; PERF.md)."""
    torch.cuda.synchronize()
    time.sleep(settle_s)


@contextlib.contextmanager
def profile_window(torch, settle_s: float = PROFILER_SETTLE_S):
    """A ``torch.profiler`` window over CPU and CUDA activity, settled
    (see :func:`settle_profiler`) before the body runs; the body times
    itself."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=profiler_activities(torch)) as prof:
        settle_profiler(torch, settle_s)
        yield prof


def runtime_calls(torch, prof) -> dict:
    """Host calls into the CUDA APIs (``cuda*`` and ``cu*``) in a
    profiled window, by name (``cudaLaunchKernel``, ``cudaGraphLaunch``,
    ``cudaMemcpyAsync``, ...)."""
    calls = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name
        if name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper()):
            calls[name] = calls.get(name, 0) + 1
    return calls


def launch_calls(calls: dict) -> int:
    """The runtime calls that put work on the card: kernel and graph
    launches, copies and memsets."""
    return sum(n for name, n in calls.items()
               if any(w in name for w in ("Launch", "Memcpy", "Memset")))


def b1_kernels(torch, prof) -> int:
    """Device executions of kernel B1 (``sample_kernel``) in a profiled
    window, counted by name: inside a graph replay the launch counters
    do not move, the device still runs each kernel."""
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and re.search(r"(^|[^A-Za-z_])sample_kernel", ev.name))


def eager_sample(torch, engine, seed_lists, bucket=None):
    """``SubgraphEngine.sample`` without its graph: the same device stage
    launched op by op, the same host copy.  The yardstick of the graph
    route, timed in the same run."""
    from glt_tpu_torch.serving.engine import CoalescedSample, _fetch

    total = int(sum(s.size for s in seed_lists))
    bucket = engine.bucket_for(total) if bucket is None else bucket
    seeds = np.full((bucket,), -1, np.int32)
    off = 0
    for s in seed_lists:
        seeds[off: off + s.size] = s
        off += s.size
    sampler = engine._sampler(bucket)
    dev = engine.graph.device
    node, row, col, edge, edge_mask, x = engine._device_stage(
        sampler, torch.from_numpy(seeds).to(dev), sampler._next_key())
    node, row, col, edge, edge_mask, x = _fetch(node, row, col, edge,
                                                edge_mask, x)
    labels = engine._labels
    y = np.where(node >= 0, labels[np.clip(node, 0, labels.shape[0] - 1)],
                 -1).astype(np.int32)
    return CoalescedSample(list(seed_lists), bucket, node, row, col, edge,
                           edge_mask, x, y, len(engine.num_neighbors))


def profile_buckets(torch, engine, lists, route):
    """Serve PROFILED warm micro-batches per bucket under torch.profiler
    through ``route`` ("graph": ``engine.sample``; "eager":
    :func:`eager_sample`); see :func:`device_profile`."""
    sample = (engine.sample if route == "graph"
              else lambda seeds: eager_sample(torch, engine, seeds))
    out = {}
    for bucket in BUCKETS:
        reqs_all = lists[bucket][-PROFILED:]
        with profile_window(torch) as prof:
            t0 = time.perf_counter()
            for reqs in reqs_all:
                engine.scatter(sample(
                    [engine.validate_seeds(r) for r in reqs]))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / len(reqs_all)
        row = device_profile(torch, prof, len(reqs_all), wall)
        row["b1_kernels"] = b1_kernels(torch, prof) / len(reqs_all)
        out[bucket] = row
    return out


def serve_timed(torch, engine, lists, sample, on_batch=None):
    """Serve every micro-batch of ``lists`` through ``sample``; per
    bucket the (total, device stage, host scatter) ms of each."""
    lat = {}
    for bucket in BUCKETS:
        lat[bucket] = []
        for i, reqs in enumerate(lists[bucket]):
            t0 = time.perf_counter()
            seeds = [engine.validate_seeds(r) for r in reqs]
            coal = sample(seeds)               # ends with the host copy
            t1 = time.perf_counter()
            msgs = engine.scatter(coal)
            t2 = time.perf_counter()
            lat[bucket].append(((t2 - t0) * 1e3, (t1 - t0) * 1e3,
                                (t2 - t1) * 1e3))
            need(coal.bucket == bucket, f"bucket {coal.bucket} != {bucket}")
            if on_batch is not None:
                on_batch(bucket, i, seeds, coal, msgs)
    return lat


def medians(passes) -> dict:
    """Per bucket: the medians over the warm micro-batches of every pass
    in ``passes`` (the first of each bucket in a pass is left out)."""
    out = {}
    for bucket in BUCKETS:
        steady = [r for lat in passes for r in lat[bucket][1:]]
        out[str(bucket)] = {
            "latency_ms_median": statistics.median(t for t, _, _ in steady),
            "sample_ms_median": statistics.median(s for _, s, _ in steady),
            "scatter_ms_median": statistics.median(c for _, _, c in steady),
            "latency_ms_all": [[t for t, _, _ in lat[bucket]]
                               for lat in passes]}
    return out


def run_slice(torch, dev, indptr, indices, feat, labels, rng):
    from glt_tpu_torch.data import CSRTopo, Dataset, Graph
    from glt_tpu_torch.distributed import message_to_batch
    from glt_tpu_torch import ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.models import GraphSAGE
    from glt_tpu_torch.sampler import NodeSamplerInput
    from glt_tpu_torch.serving import ServingOptions, SubgraphEngine

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
    # warmup() captures each bucket's graph (one eager warm-up run, then
    # the capture); every micro-batch after it is a replay.
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    first, logits_first, counts = {}, {}, {}
    nmsg = [0]
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    def check(bucket, i, seeds, coal, msgs):
        for m in msgs:
            check_message(m, indptr, indices, feat, labels)
            nmsg[0] += 1
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

    lat = serve_timed(torch, engine, lists, engine.sample, check)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    plain_calls = trandom.threefry2x32.calls
    served = sum(len(v) for v in lists.values())
    need(plain_calls == 0, f"the serving path ran the plain threefry "
                           f"arithmetic on the card ({plain_calls} calls)")
    need(engine.compiled_buckets() == list(BUCKETS),
         f"captured buckets {engine.compiled_buckets()}")
    # Per bucket: B1 once per hop in the warm-up and once per hop into
    # the graph; replays move no counter.  The hash kernel: the split
    # by hop in the warm-up and in the graph, and one fold_in per
    # micro-batch (warmup()'s included), outside the graph.
    nb = len(BUCKETS)
    need(launches["sample_neighbors_cuda"] == 2 * len(FANOUTS) * nb,
         f"B1 launched {launches['sample_neighbors_cuda']} times to "
         f"capture {nb} buckets of {len(FANOUTS)} hops")
    need(launches["threefry_hash_cuda"] == 2 * nb + nb + served,
         f"the hash kernel launched {launches['threefry_hash_cuda']} "
         f"times for {nb} captures and {served + nb} micro-batches")
    need(launches["gather_rows_cuda"] == 2 * nb,
         f"B2 launched {launches['gather_rows_cuda']} times for {nb} "
         f"captures")

    # -- the same first micro-batch per bucket on the CPU: equal ---------
    cds = Dataset(graph=Graph(topo, device="cpu"), device="cpu")
    cds.init_node_features(feat)
    cds.init_node_labels(labels)
    cengine = SubgraphEngine(cds, ServingOptions(**opts))
    cengine.warmup()                    # the same key counters
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

    # -- per bucket, a replayed micro-batch == the eager route -----------
    feature = ds.get_node_feature()
    for bucket in BUCKETS:
        reqs = [engine.validate_seeds(r) for r in lists[bucket][0]]
        s = engine._sampler(bucket)
        count = s._call_count
        coal = engine.sample(reqs)
        seeds = np.full((bucket,), -1, np.int32)
        flat = np.concatenate(reqs)
        seeds[: flat.size] = flat
        out = s.sample_from_nodes(
            NodeSamplerInput(seeds),
            key=trandom.fold_in(s._base_key, count))
        want = (out.node, out.row, out.col, out.edge_mask,
                feature.gather(out.node))
        got = (coal.node, coal.row, coal.col, coal.edge_mask, coal.x)
        for name, w, g in zip(("node", "row", "col", "edge_mask", "x"),
                              want, got):
            need(torch.equal(w.cpu(), torch.from_numpy(g)),
                 f"bucket {bucket}: the replayed {name} differs from the "
                 f"eager route's")

    # -- graph against eager in this run: profiles, then medians ---------
    profiled = {r: profile_buckets(torch, engine, lists, r)
                for r in ("graph", "eager")}
    for bucket in BUCKETS:
        b1 = profiled["graph"][bucket]["b1_kernels"]
        need(b1 == len(FANOUTS), f"bucket {bucket}: B1 ran {b1} times per "
                                 f"replayed micro-batch, not "
                                 f"{len(FANOUTS)}")
    # Timed passes without the checks, in turns: graph, eager, eager,
    # graph (the checked pass above runs the model and the host checks
    # between micro-batches, which would tilt the comparison).
    routes = {"graph": engine.sample,
              "eager": lambda seeds: eager_sample(torch, engine, seeds)}
    passes = {"graph": [], "eager": []}
    for route in ("graph", "eager", "eager", "graph"):
        passes[route].append(serve_timed(torch, engine, lists,
                                         routes[route]))
    graph_med, eager_med = medians(passes["graph"]), medians(passes["eager"])
    per_bucket = {}
    for bucket in map(str, BUCKETS):
        per_bucket[bucket] = dict(graph_med[bucket])
        per_bucket[bucket]["latency_ms_first"] = lat[int(bucket)][0][0]
        per_bucket[bucket]["checked_pass_ms"] = [
            t for t, _, _ in lat[int(bucket)]]
        per_bucket[bucket]["profile"] = profiled["graph"][int(bucket)]
        per_bucket[bucket]["eager"] = dict(
            eager_med[bucket], profile=profiled["eager"][int(bucket)])
    return {"launches": launches, "plain_hash_calls": plain_calls,
            "micro_batches": served, "warmup_s": warmup_s,
            "messages_checked": nmsg[0], "per_bucket": per_bucket,
            "cpu_logit_rel_err": logit_err}


def copy_state(state, make, tx):
    """A TrainState with its own model (from ``make()``) and optimizer
    (``tx``), holding copies of ``state``'s weights, optimizer state and
    step."""
    from glt_tpu_torch.models import TrainState

    model = make()
    model.load_state_dict(state.model.state_dict())
    opt = tx(model.parameters())
    # A deep copy: load_state_dict keeps the given tensors where their
    # device and dtype already fit, so the two optimizers would share
    # (and both update) one set of moments.
    opt.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    return TrainState(model, opt, state.step)


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
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
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
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    plain_calls = trandom.threefry2x32.calls
    need(plain_calls == 0, f"the training path ran the plain threefry "
                           f"arithmetic on the card ({plain_calls} calls)")
    # B1 once per hop of each eager sample; the epoch's first block runs
    # eagerly, the second is captured (its launches counted once) and
    # replayed, and the rest replay without moving a counter.
    samples = (CAL_BATCHES + 2 * GROUP + len(eval_accs)
               + loader.overflow_batches)
    need(launches["sample_neighbors_cuda"] == len(FANOUTS) * samples,
         f"B1 launched {launches['sample_neighbors_cuda']} times for "
         f"{samples} eager and captured samples of {len(FANOUTS)} hops")
    peak = torch.cuda.max_memory_allocated()
    block_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    step_ms = statistics.median(block_ms[2:]) / GROUP   # replayed blocks

    # -- one block replayed and the same block eager, from one state ------
    prof_idx = perm[-(EVAL_BATCHES + GROUP) * TRAIN_BS:
                    -EVAL_BATCHES * TRAIN_BS]          # 8 full batches
    blk = next(node_seed_blocks(prof_idx, TRAIN_BS, GROUP,
                                np.random.default_rng(6)))
    need(bool((blk >= 0).all()), "the profiled block holds padding")
    twin = copy_state(state, lambda: random_model(
        torch, GraphSAGE, dev, dtype=torch.bfloat16), adam(LR))
    key7 = trandom.PRNGKey(7, device=dev)
    with profile_window(torch) as prof:
        t1 = time.perf_counter()
        state, ls_graph, _, _ = step(state, blk, key7)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / GROUP
    profiled = device_profile(torch, prof, GROUP, wall)
    profiled["b1_kernels"] = b1_kernels(torch, prof) / GROUP
    need(profiled["b1_kernels"] == len(FANOUTS),
         f"B1 ran {profiled['b1_kernels']} times a replayed step")

    def eager_step():
        # A fresh step's first call at a block shape runs eagerly.
        return make_scanned_node_train_step(
            sampler, ds.get_node_feature(), labels, TRAIN_BS,
            fused_frontier=True)

    fresh = eager_step()
    with profile_window(torch) as prof:
        t1 = time.perf_counter()
        twin, ls_eager, _, _ = fresh(twin, blk, key7)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / GROUP
    eager_profiled = device_profile(torch, prof, GROUP, wall)
    eager_profiled["b1_kernels"] = b1_kernels(torch, prof) / GROUP
    lg, le = ls_graph.double().cpu(), ls_eager.double().cpu()
    replay_rel = ((lg - le).abs() / le.abs().clamp(min=1e-30)).tolist()
    need(replay_rel[0] <= 1e-3, f"replayed block's first loss {lg[0]} vs "
                                f"eager {le[0]}")
    need(max(replay_rel) <= LOSS_RTOL,
         f"replayed block's losses {lg.tolist()} vs eager {le.tolist()}")
    # Blocks timed in turns, eager, graph, graph, eager: the eager ones
    # on the copy through fresh steps, the graph ones replayed.
    turn_ms = {"eager": [], "graph": []}
    for j, (route, eb) in enumerate(zip(
            ("eager", "graph", "graph", "eager"),
            node_seed_blocks(train_idx[: 4 * GROUP * TRAIN_BS], TRAIN_BS,
                             GROUP, np.random.default_rng(10)))):
        run = eager_step() if route == "eager" else step
        key = trandom.PRNGKey(11 + j, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if route == "eager":
            twin, _, _, _ = run(twin, eb, key)
        else:
            state, _, _, _ = run(state, eb, key)
        torch.cuda.synchronize()
        turn_ms[route].append((time.perf_counter() - t1) * 1e3)
    eager_block_ms = turn_ms["eager"]
    del twin

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

    cached = run_cached_block(torch, dev, sampler, ds, labels, train_idx,
                              rows, lab)
    batched = run_batched_sample(torch, dev, sampler, prof_idx)
    return {
        "feature_cache_block": cached,
        "batched_sample": batched,
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
        "eager_block_ms": eager_block_ms,
        "eager_step_ms_median": statistics.median(eager_block_ms) / GROUP,
        "turn_graph_block_ms": turn_ms["graph"],
        "replay_vs_eager_rel": replay_rel,
        "eager_profile": eager_profiled,
        "max_memory_allocated": peak,
        "launches": launches,
        "plain_hash_calls": plain_calls,
        "launches_per_step": {k: v / losses.shape[0]
                              for k, v in launches.items()},
        "profile": profiled,
        "cpu_loss": pair[1],
        "card_loss": pair[0],
        "cpu_loss_rel_err": loss_err,
    }, node_list, rows


def run_cached_block(torch, dev, sampler, ds, labels, train_idx, rows,
                     lab) -> dict:
    """The scanned node step with ``feature_cache=`` (CACHE_ROWS rows)
    for three blocks: eager, captured, replayed.  A recording wrapper
    round the model copies each batch's ``x`` into a static buffer (an
    in-place copy, which the graph replays); the replayed block's ``x``
    must equal the uncached gather of the same samples bit for bit."""
    from glt_tpu_torch import ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.data.feature_cache import cache_init, cache_stats
    from glt_tpu_torch.models import (
        GraphSAGE,
        adam,
        create_train_state,
        make_gather_xy,
        make_scanned_node_train_step,
        node_seed_blocks,
    )
    from glt_tpu_torch.sampler import NodeSamplerInput

    inner = random_model(torch, GraphSAGE, dev, dtype=torch.bfloat16)

    class Recorder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = inner
            self.calls = 0
            self.x = torch.zeros((GROUP, sampler.node_capacity, FEAT_DIM),
                                 device=dev)

        def forward(self, x, edge_index, edge_mask, dropout_key=None):
            self.x[self.calls % GROUP].copy_(x)
            self.calls += 1
            return self.inner(x, edge_index, edge_mask,
                              dropout_key=dropout_key)

    rec = Recorder()
    state = create_train_state(rec, adam(LR))
    step = make_scanned_node_train_step(
        sampler, ds.get_node_feature(), labels, TRAIN_BS,
        fused_frontier=True, feature_cache=cache_init(
            PRODUCTS_N, CACHE_ROWS, FEAT_DIM, device=dev))
    blocks = list(node_seed_blocks(train_idx[: 3 * GROUP * TRAIN_BS],
                                   TRAIN_BS, GROUP,
                                   np.random.default_rng(9)))
    b1 = ops.sample_neighbors_cuda.launches
    block_ms = []
    for i, blk in enumerate(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses, _, _ = step(state, blk,
                                   trandom.PRNGKey(50 + i, device=dev))
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        need(bool(torch.isfinite(losses).all()), "cached block: losses")
    launched = ops.sample_neighbors_cuda.launches - b1
    need(launched == 2 * GROUP * len(FANOUTS),
         f"cached block: B1 launched {launched} times (eager block and "
         f"capture), not {2 * GROUP * len(FANOUTS)}")
    plain_xy = make_gather_xy()
    keys = trandom.split(trandom.PRNGKey(52, device=dev), GROUP)
    for g in range(GROUP):
        out = sampler.sample_from_nodes(NodeSamplerInput(blocks[2][g]),
                                        key=keys[g])
        xp, _ = plain_xy(rows, lab, out)
        need(torch.equal(rec.x[g], xp),
             f"cached block: the replayed batch {g}'s x differs from the "
             f"uncached gather")
    stats = cache_stats(step.feature_cache())
    need(stats["hits"] + stats["misses"] > 0, "the cache served nothing")
    return {"cache_rows": CACHE_ROWS, "block_ms": block_ms,
            "stats": stats}


def run_batched_sample(torch, dev, sampler, ids) -> dict:
    """``sample_from_nodes_batched`` at G = GROUP on the training
    sampler: the first call captures, the second replays and must equal
    GROUP eager ``sample_from_nodes`` calls under ``split(key, G)``
    (every field and the overflow flags); then the replay and the loop,
    timed."""
    from glt_tpu_torch import ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.models import node_seed_blocks
    from glt_tpu_torch.sampler import NodeSamplerInput

    blk = next(node_seed_blocks(ids, TRAIN_BS, GROUP,
                                np.random.default_rng(12)))
    sampler.sample_from_nodes_batched(blk[::-1].copy())     # captures
    key = trandom.PRNGKey(60, device=dev)
    b1 = ops.sample_neighbors_cuda.launches
    out = sampler.sample_from_nodes_batched(blk, key=key)
    need(ops.sample_neighbors_cuda.launches == b1,
         "the second batched call launched B1: not a replay")
    keys = trandom.split(key, GROUP)
    fields = ("node", "row", "col", "batch", "node_mask", "edge_mask",
              "num_sampled_nodes", "num_sampled_edges")
    for g in range(GROUP):
        one = sampler.sample_from_nodes(NodeSamplerInput(blk[g]),
                                        key=keys[g])
        for f in fields:
            need(torch.equal(getattr(out, f)[g], getattr(one, f)),
                 f"batched sample {g}: {f} differs from the loop's")
        need(torch.equal(out.metadata["overflow"][g],
                         one.metadata["overflow"]),
             f"batched sample {g}: overflow flag differs")

    def loop():
        return [sampler.sample_from_nodes(NodeSamplerInput(blk[g]),
                                          key=keys[g])
                for g in range(GROUP)]

    return {"G": GROUP, "batch_size": TRAIN_BS,
            "replay_ms": host_ms(torch, lambda: sampler.
                                 sample_from_nodes_batched(blk, key=key)),
            "loop_ms": host_ms(torch, loop)}


# -- phase 6: the compressed feature store -------------------------------
def serve_lists(engine, feature, lists):
    """Serve every micro-batch of ``lists`` and hold each message's ``x``
    to the host decode of its rows (``cpu_get``).  Returns per-bucket
    latencies (ms) and the served node lists."""
    lat, nodes = {}, []
    for bucket in BUCKETS:
        lat[bucket] = []
        for reqs in lists[bucket]:
            t0 = time.perf_counter()
            coal = engine.sample([engine.validate_seeds(r) for r in reqs])
            msgs = engine.scatter(coal)
            lat[bucket].append((time.perf_counter() - t0) * 1e3)
            need(coal.bucket == bucket, f"bucket {coal.bucket} != {bucket}")
            for m in msgs:
                need(np.array_equal(m["x"], feature.cpu_get(m["node"])),
                     "served x differs from the host decode of its rows")
            nodes.append((bucket, coal.node))
    return lat, nodes


def run_store(torch, dev, indptr, indices, feat, labels, train_nodes):
    """The compressed tier at products scale (module docstring, phase 6).
    Returns the phase's report and the tables and node lists that time
    B4 and B5."""
    from glt_tpu_torch import ops
    from glt_tpu_torch.data import CSRTopo, Dataset, Feature, Graph
    from glt_tpu_torch.models import GraphSAGE
    from glt_tpu_torch.refresh import RefreshDriver, sage_refresh_layers
    from glt_tpu_torch.serving import ServingOptions, SubgraphEngine
    from glt_tpu_torch.store import DiskFeatureStore, quant
    from glt_tpu_torch.store import write_feature_store
    from torch.profiler import profile

    os.makedirs(WORK_DIR, exist_ok=True)
    rep = {}
    with tempfile.TemporaryDirectory(dir=WORK_DIR) as tmp:
        t0 = time.perf_counter()
        roots = {c: write_feature_store(os.path.join(tmp, c), feat, codec=c)
                 for c in STORE_CODECS}
        rep["write_s"] = time.perf_counter() - t0
        rep["store_bytes"] = {c: os.path.getsize(os.path.join(
            roots[c], "features.bin")) for c in STORE_CODECS}
        graph = Graph(CSRTopo.from_csr_arrays(indptr, indices), device=dev)
        feats = {"raw": Feature(feat, device=dev)}
        for c in STORE_CODECS:
            feats[c] = Feature.from_store(DiskFeatureStore(roots[c]),
                                          64 << 20, split_ratio=1.0,
                                          device=dev)
        spec = feats["int8"].quant_spec
        lists = request_lists(np.random.default_rng(3), PRODUCTS_N)

        # -- the main path: counts set to 0 just before, read just after
        for fn in kernel_wrappers(ops).values():
            fn.launches = 0
        served, nodes = {}, {}
        for name in ("raw",) + STORE_CODECS:
            ds = Dataset(graph=graph, device=dev)
            ds.node_features = feats[name]
            ds.init_node_labels(labels)
            engine = SubgraphEngine(ds, ServingOptions(
                num_neighbors=FANOUTS, seed_buckets=BUCKETS))
            lat, nodes[name] = serve_lists(engine, feats[name], lists)
            served[name] = {str(b): {
                "latency_ms_median": statistics.median(v[1:]),
                "latency_ms_all": v} for b, v in lat.items()}
        rep["serving"] = served
        serve_b4 = ops.gather_rows_dequant_cuda.launches
        need(serve_b4 > 0, "serving from a compressed store never "
                           "launched B4")

        # split 0.5 with a DRAM budget of 1/8 of the compressed bytes and
        # the cold cache: every served node list equals split 1.0's.
        budget = rep["store_bytes"]["int8"] // 8
        half = Feature.from_store(DiskFeatureStore(roots["int8"]), budget,
                                  split_ratio=0.5, device=dev)
        half.enable_cold_cache(COLD_CACHE_ROWS)
        tier_ms = []
        try:
            for _, node in nodes["int8"]:
                t0 = time.perf_counter()
                got = half.gather(node)
                torch.cuda.synchronize()
                tier_ms.append((time.perf_counter() - t0) * 1e3)
                want = feats["int8"].gather(torch.from_numpy(node).to(dev))
                need(torch.equal(got.view(torch.int32),
                                 want.view(torch.int32)),
                     "split 0.5 gather differs from split 1.0")
            rep["tiered"] = {"budget_bytes": budget,
                             "cold_cache_rows": COLD_CACHE_ROWS,
                             "gather_ms_median": statistics.median(tier_ms),
                             "gather_ms_all": tier_ms,
                             "stager": half.store_stats(),
                             "cold_cache": half.cache_stats()}
        finally:
            half.close()

        # B5 through its entry point on the training node list.
        table = feats["int8"].hot_rows
        sz = quant.scale_zero_tensor(spec, table.shape[1], dev)
        ff = ops.fused_frontier(table, train_nodes, dequant=spec)
        _, inv, uidx = ops.frontier_plan(train_nodes)
        want = ops.fused_frontier_dequant_plain(table, uidx, inv, sz)
        need(torch.equal(ff.features.view(torch.int32),
                         want.view(torch.int32)),
             "B5 on the training node list differs from its plain version")

        # The whole-graph refresh from the int8 store through B4.
        model = random_model(torch, GraphSAGE, dev, dropout_rate=0.0)
        layers = sage_refresh_layers(model)
        last, kept = {}, {}

        def layer0(x, ei, em):
            last["h"] = layers[0](x, ei, em)
            return last["h"]

        stamps = []                 # (layer, host clock) after each sweep
        prof = profile(activities=profiler_activities(torch))

        def on_sweep(d, layer, sweep):
            stamps.append((layer, time.perf_counter()))
            # Layer 1's sweeps 11..13 (256-wide input) under the profiler.
            if (layer, sweep) == (1, 10):
                prof.start()
                settle_profiler(torch)
                kept["prof_t0"] = time.perf_counter()
            elif (layer, sweep) == (1, 10 + PROFILED):
                torch.cuda.synchronize()
                prof.stop()
                kept["prof_wall_ms"] = (stamps[-1][1] - kept.pop("prof_t0")
                                        ) * 1e3 / PROFILED
            if layer == 0 and sweep in check_sweeps:
                block_len = min(d.block_size,
                                d.num_nodes - sweep * d.block_size)
                kept[sweep] = last["h"][:block_len].cpu()

        drv = RefreshDriver(
            indptr, indices, [layer0] + layers[1:],
            DiskFeatureStore(roots["int8"]), os.path.join(tmp, "refresh"),
            block_size=REFRESH_BLOCK, max_degree=REFRESH_MAX_DEGREE,
            out_codec="bf16", split_ratio=1.0, on_sweep=on_sweep,
            device=dev)
        check_sweeps = (0, drv.num_sweeps - 1)
        frontier_s = []
        build = drv.frontier

        def timed_frontier(sweep):
            t = time.perf_counter()
            out = build(sweep)
            frontier_s.append(time.perf_counter() - t)
            return out

        drv.frontier = timed_frontier
        t0 = time.perf_counter()
        refresh = dict(drv.run())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        refresh["wall_s"] = t1 - t0
        # Where the wall time goes: the host clock between sweeps of one
        # layer, the gaps around each layer's sweeps (store load, writer
        # set-up, finalize), and the frontier builds.
        gaps = [b - a for (la, a), (lb, b) in zip(stamps, stamps[1:])
                if la == lb]
        bounds = [stamps[0][1] - t0] + [
            b - a for (la, a), (lb, b) in zip(stamps, stamps[1:])
            if la != lb] + [t1 - stamps[-1][1]]
        refresh["sweep_gap_ms_median"] = statistics.median(gaps) * 1e3
        refresh["layer_boundary_s"] = bounds
        refresh["frontier_ms_median"] = statistics.median(frontier_s) * 1e3
        refresh["profile"] = device_profile(torch, prof, PROFILED,
                                            kept.pop("prof_wall_ms"))
        refresh["block_size"] = REFRESH_BLOCK
        refresh["sweep_ms_mean"] = (drv.totals["seconds"] * 1e3
                                    / (drv.num_sweeps * len(layers)))
        out = DiskFeatureStore(refresh["out_root"])
        need(out.codec == "bf16" and out.shape == (PRODUCTS_N, CLASSES),
             f"refresh published {out.codec} {out.shape}")
        probe = out.read_rows(np.arange(0, PRODUCTS_N, 997))
        need(bool(np.isfinite(quant.decode(probe, out.quant_spec())).all()),
             "refreshed embeddings not finite")
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
        refresh["out_root"] = os.path.relpath(refresh["out_root"], tmp)
        rep["refresh"] = refresh

        # Two sweeps of layer 0 again on the CPU through the plain
        # versions: the card's rows before the bf16 output, within 1e-5.
        cpu_feat = Feature.from_store(DiskFeatureStore(roots["int8"]),
                                      64 << 20, split_ratio=1.0,
                                      device="cpu")
        cpu_drv = RefreshDriver(
            indptr, indices, [], DiskFeatureStore(roots["int8"]),
            os.path.join(tmp, "cpu"), block_size=REFRESH_BLOCK,
            max_degree=REFRESH_MAX_DEGREE, device="cpu")
        cpu_layer0 = sage_refresh_layers(random_model(
            torch, GraphSAGE, "cpu", dropout_rate=0.0))[0]
        rel = 0.0
        for sweep in check_sweeps:
            frontier, block_len, _ = cpu_drv.frontier(sweep)
            ft = torch.from_numpy(frontier)
            h = cpu_drv.step(cpu_layer0, cpu_feat.gather(ft), ft)[:block_len]
            err = float((h - kept[sweep]).abs().max())
            rel = max(rel, err / max(float(h.abs().max()), 1e-30))
        need(rel <= REFRESH_RTOL, f"refresh sweeps: card vs CPU rel {rel}")
        rep["refresh_cpu_rel_err"] = rel
        rep["refresh_checked_sweeps"] = list(check_sweeps)
        cpu_feat.close()
        for f in feats.values():
            f.close()
        timing_node = torch.from_numpy(
            [n for b, n in nodes["int8"] if b == BUCKETS[-1]][-1]).to(dev)
        tables = {c: (feats[c].hot_rows, quant.scale_zero_tensor(
            feats[c].quant_spec, FEAT_DIM, dev)) for c in STORE_CODECS}
    rep["launches"] = launches
    rep["serve_b4_launches"] = serve_b4
    return rep, tables, timing_node


def kernel_wrappers(ops):
    """The launch-counting wrapper of each kernel, by name."""
    return {"sample_neighbors_cuda": ops.sample_neighbors_cuda,
            "threefry_hash_cuda": ops.threefry_hash_cuda,
            "gather_rows_cuda": ops.gather_rows_cuda,
            "fused_frontier_cuda": ops.fused_frontier_cuda,
            "gather_rows_dequant_cuda": ops.gather_rows_dequant_cuda,
            "fused_frontier_dequant_cuda": ops.fused_frontier_dequant_cuda}


def run_digits(torch, dev) -> dict:
    """The digits twin with its defaults on the card, then its weights
    evaluated on the raw features and through an int8 store at split
    0.0 (stager + merge) and split 1.0 (B4)."""
    from glt_tpu_torch import ops
    from glt_tpu_torch.examples import train_sage_digits as digits

    t0 = time.perf_counter()
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    run = digits.train(digits.parse_args(DIGITS_ARGS + ["--device",
                                                        str(dev)]))
    acc, _ = digits.evaluate(run)
    need(acc > 0.93, f"digits accuracy {acc} <= 0.93")
    os.makedirs(WORK_DIR, exist_ok=True)
    par = digits.int8_store_parity(run, WORK_DIR)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    for k in ("acc_int8_split0", "acc_int8_split1"):
        need(abs(par[k] - par["acc_raw"]) <= DIGITS_INT8_TOL,
             f"digits {k} {par[k]} vs raw {par['acc_raw']}")
    need(par["x_equal"], "digits: the two int8 evaluations' x differ")
    return {"test_acc": acc, "int8_parity": par, "launches": launches,
            "seconds": time.perf_counter() - t0}


# -- phase 8: link prediction and induced subgraphs -------------------------
def edge_sources(indptr, pos):
    """The CSR row (source node) of each edge position."""
    return np.searchsorted(indptr, pos, side="right") - 1


def is_edge(indptr, indices, s, d) -> bool:
    return bool((indices[indptr[s]: indptr[s + 1]] == d).any())


def check_sorted_view(torch, graph, indptr, indices, rng):
    """The card's sorted view against ``np.sort`` of SORT_ROWS CSR rows:
    random rows and the 16 highest-degree rows."""
    deg = np.diff(indptr)
    rows = np.concatenate([np.argsort(deg)[-16:],
                           rng.integers(0, PRODUCTS_N, SORT_ROWS - 16)])
    pos = np.concatenate([np.arange(indptr[r], indptr[r + 1]) for r in rows])
    got = graph.sorted_indices[torch.from_numpy(pos).to(
        graph.device)].cpu().numpy()
    want = np.concatenate([np.sort(indices[indptr[r]: indptr[r + 1]])
                           for r in rows])
    need(np.array_equal(got, want), "the sorted view differs from np.sort "
                                    "of the CSR rows")
    return int(rows.shape[0]), int(pos.shape[0]), int(deg[rows].max())


def edge_queries(indptr, indices, rng):
    """EDGE_PAIRS (src, dst) pairs: half real edges, half uniform pairs,
    with padding on either side and ids 0 and N - 1."""
    half = EDGE_PAIRS // 2
    pos = rng.integers(0, indices.shape[0], half)
    qs = np.concatenate([edge_sources(indptr, pos),
                         rng.integers(0, PRODUCTS_N, half)])
    qd = np.concatenate([indices[pos], rng.integers(0, PRODUCTS_N, half)])
    at = rng.integers(half, EDGE_PAIRS, 4096)
    qs[at[:1024]] = -1
    qd[at[1024:2048]] = -1
    qs[at[2048:3072]] = rng.choice([0, PRODUCTS_N - 1], 1024)
    qd[at[3072:]] = rng.choice([0, PRODUCTS_N - 1], 1024)
    return qs.astype(np.int32), qd.astype(np.int32), half


def link_model(torch, GraphSAGE, init_params, dev, hidden):
    return init_params(GraphSAGE(FEAT_DIM, hidden, hidden, num_layers=2,
                                 dropout_rate=0.0)).to(dev)


def check_link_batch(b, src, dst, feat, amount):
    """A binary batch: positives decode to the seed edges with label 1,
    padded positives -1, negatives 0; ``x`` is each node's row (zeros on
    padding).  Returns the negative pairs as global ids."""
    q = src.shape[0]
    node = b.node.cpu().numpy()
    eli = b.metadata["edge_label_index"].cpu().numpy()
    lab = b.metadata["edge_label"].cpu().numpy()
    need(eli.shape == (2, LINK_BS * (1 + amount)), f"edge_label_index "
                                                    f"{eli.shape}")
    need(np.array_equal(node[eli[0, :q]], src)
         and np.array_equal(node[eli[1, :q]], dst),
         "a positive does not decode to its seed edge")
    need((lab[:q] == 1).all() and (lab[q:LINK_BS] == -1).all()
         and (lab[LINK_BS:] == 0).all(), "edge_label breaks the rules")
    need((eli[:, LINK_BS:] >= 0).all(), "a negative is not in the batch")
    valid = node >= 0
    x = b.x.cpu().numpy()
    need(np.array_equal(x[valid], feat[node[valid]])
         and not x[~valid].any(), "the batch's x differs from its rows")
    return node[eli[0, LINK_BS:]], node[eli[1, LINK_BS:]]


def check_induced(out, indptr, indices):
    """Every induced edge is a real edge among the batch's node set (its
    id the CSR position), and every edge of that set within the first
    SEAL_DEGREE entries of its row is present."""
    node = out.node.cpu().numpy()
    mask = out.edge_mask.cpu().numpy()
    r, c = out.row.cpu().numpy()[mask], out.col.cpu().numpy()[mask]
    e = out.edge.cpu().numpy()[mask]
    u, v = node[r], node[c]
    need((u >= 0).all() and (v >= 0).all(), "an induced edge leaves the "
                                            "node set")
    need(np.array_equal(indices[e], v) and (e >= indptr[u]).all()
         and (e < np.minimum(indptr[u + 1], indptr[u] + SEAL_DEGREE)).all(),
         "an induced edge is not a real edge within the degree cap")
    local = {int(g): i for i, g in enumerate(node) if g >= 0}
    want = set()
    for g, i in local.items():
        lo = indptr[g]
        for p in range(lo, min(indptr[g + 1], lo + SEAL_DEGREE)):
            j = local.get(int(indices[p]))
            if j is not None:
                want.add((i, j, p))
    got = set(zip(r.tolist(), c.tolist(), e.tolist()))
    need(got == want, f"induced edges: {len(got)} emitted, {len(want)} in "
                      f"the node set")
    return len(local), len(got)


def run_link(torch, dev, indptr, indices, feat, rng):
    """Link prediction and induced-subgraph training on the products
    graph (see the module docstring)."""
    from glt_tpu_torch import ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.data import CSRTopo, Dataset, Feature, Graph
    from glt_tpu_torch.examples.graph_sage_unsup_ppi import unsup_dot_loss
    from glt_tpu_torch.examples.seal_link_pred import (
        candidate_links,
        pair_loss,
    )
    from glt_tpu_torch.examples.train_sage_digits import init_params
    from glt_tpu_torch.loader import LinkNeighborLoader
    from glt_tpu_torch.models import (
        GraphSAGE,
        adam,
        create_train_state,
        link_seed_blocks,
        make_scanned_link_train_step,
        make_scanned_subgraph_train_step,
    )
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.sampler import (
        EdgeSamplerInput,
        NegativeSampling,
        NeighborSampler,
        NodeSamplerInput,
    )

    rep = {}
    topo = CSRTopo.from_csr_arrays(indptr, indices)
    ds = Dataset(graph=Graph(topo, device=dev), device=dev)
    ds.init_node_features(feat)
    graph = ds.get_graph()

    # -- the sorted view, built on the card -------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.sorted_indices
    torch.cuda.synchronize()
    rep["sorted_view_s"] = time.perf_counter() - t0
    rep["edge_keys_bytes"] = graph.edge_keys.numel() * 8
    rows, entries, top = check_sorted_view(torch, graph, indptr, indices, rng)
    rep["sorted_rows_checked"] = {"rows": rows, "entries": entries,
                                  "max_degree": top}

    # -- edge_in_csr against its 32-step plain version --------------------
    qs, qd, half = edge_queries(indptr, indices, rng)
    qs_d, qd_d = (torch.from_numpy(a).to(dev) for a in (qs, qd))
    args = (graph.indptr, graph.sorted_indices, qs_d, qd_d)
    got = ops.edge_in_csr(*args, graph.edge_keys)
    plain = ops.edge_in_csr_plain(*args)
    torch.cuda.synchronize()
    need(torch.equal(got, plain), "edge_in_csr differs from its plain "
                                  "version on the card")
    hit = got.cpu().numpy()
    need(bool(hit[:half][(qs[:half] >= 0) & (qd[:half] >= 0)].all()),
         "edge_in_csr missed a real edge")
    with profile_window(torch) as prof:
        ops.edge_in_csr(*args, graph.edge_keys)
        torch.cuda.synchronize()
    rep["edge_in_csr"] = {
        "pairs": EDGE_PAIRS, "true": int(hit.sum()),
        "ms": cuda_ms(torch, lambda: ops.edge_in_csr(*args, graph.edge_keys)),
        "plain_ms": cuda_ms(torch, lambda: ops.edge_in_csr_plain(*args)),
        "kernels_per_call": device_profile(torch, prof, 1, 1.0)["kernels"]}
    del qs_d, qd_d, args, got, plain

    # -- the main path: counts set to 0 just before, read just after ------
    pos = rng.integers(0, indices.shape[0],
                       LINK_BLOCKS * GROUP * LINK_BS)
    seed_edges = np.stack([edge_sources(indptr, pos), indices[pos]])
    loader_edges = seed_edges[:, : LINK_BATCHES * LINK_BS - 7]
    w = (rng.random(PRODUCTS_N) * (rng.random(PRODUCTS_N) < 0.01)
         ).astype(np.float32)
    links, link_labels = candidate_links(seed_edges, PRODUCTS_N,
                                         SEAL_BLOCKS * GROUP * SEAL_BS // 2,
                                         rng)
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    captures0 = {p: compilewatch.counts(p)
                 for p in ("scanned_link_step", "scanned_subgraph_step")}
    torch.cuda.synchronize()
    loader = LinkNeighborLoader(
        ds, LINK_FANOUT, loader_edges, batch_size=LINK_BS,
        neg_sampling=NegativeSampling("binary", 1), frontier_cap=LINK_CAP,
        seed=11)
    batches = list(loader)
    ls = loader.sampler
    trip = ls.sample_from_edges(EdgeSamplerInput(
        seed_edges[0, :LINK_BS], seed_edges[1, :LINK_BS],
        neg_sampling=NegativeSampling("triplet", 2)))
    weighted = ls.sample_from_edges(EdgeSamplerInput(
        seed_edges[0, :LINK_BS], seed_edges[1, :LINK_BS],
        neg_sampling=NegativeSampling("binary", 1, weight=w)))

    lsamp = NeighborSampler(graph, LINK_FANOUT, batch_size=LINK_BS,
                            frontier_cap=LINK_CAP, with_edge=False)
    lmodel = link_model(torch, GraphSAGE, init_params, dev, LINK_HIDDEN)
    lstate = create_train_state(lmodel, adam(LR))
    lstep = make_scanned_link_train_step(
        lsamp, ds.get_node_feature(), unsup_dot_loss,
        NegativeSampling("binary", 1))
    lblocks = list(link_seed_blocks(seed_edges, LINK_BS, GROUP,
                                    np.random.default_rng(12)))
    need(len(lblocks) == LINK_BLOCKS, f"{len(lblocks)} link blocks")
    link_losses, link_ms = [], []
    for i, (sb, db, _) in enumerate(lblocks):
        t1 = time.perf_counter()
        lstate, losses = lstep(lstate, sb, db,
                               trandom.PRNGKey(30 + i, device=dev))
        torch.cuda.synchronize()
        link_ms.append((time.perf_counter() - t1) * 1e3)
        link_losses.append(losses)

    gsamp = NeighborSampler(graph, SEAL_FANOUT, batch_size=2 * SEAL_BS,
                            with_edge=True)
    gmodel = link_model(torch, GraphSAGE, init_params, dev, SEAL_HIDDEN)
    gstate = create_train_state(gmodel, adam(LR))
    gstep = make_scanned_subgraph_train_step(
        gsamp, ds.get_node_feature(), pair_loss, max_degree=SEAL_DEGREE)
    order = np.random.default_rng(13).permutation(link_labels.shape[0])
    per_block = SEAL_BS * GROUP
    gblocks = []
    for lo in range(0, link_labels.shape[0], per_block):
        sel = order[lo: lo + per_block]
        sb = np.full((GROUP, 2 * SEAL_BS), -1, np.int64)
        yb = np.full((GROUP, SEAL_BS), -1, np.int64)
        sb.reshape(-1)[: sel.shape[0] * 2] = links.T[sel].reshape(-1)
        yb.reshape(-1)[: sel.shape[0]] = link_labels[sel]
        gblocks.append((sb, yb))
    need(len(gblocks) == SEAL_BLOCKS, f"{len(gblocks)} subgraph blocks")
    seal_losses, seal_ms = [], []
    for i, (sb, yb) in enumerate(gblocks):
        t1 = time.perf_counter()
        gstate, losses = gstep(gstate, sb, yb,
                               trandom.PRNGKey(40 + i, device=dev))
        torch.cuda.synchronize()
        seal_ms.append((time.perf_counter() - t1) * 1e3)
        seal_losses.append(losses)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    plain_calls = trandom.threefry2x32.calls
    need(plain_calls == 0, f"the link phase ran the plain threefry "
                           f"arithmetic on the card ({plain_calls} calls)")
    captures = {p: compilewatch.counts(p) - captures0[p] for p in captures0}
    need(captures == {"scanned_link_step": 1, "scanned_subgraph_step": 1},
         f"captures in the link phase: {captures}, not one a step")
    # B1 once per hop of each eager sample: the loader's, the two
    # variants', and each step's first block (eager) and second (its
    # capture); the other blocks replay without moving a counter.
    samples = len(batches) + 2 + 2 * GROUP + 2 * GROUP
    need(launches["sample_neighbors_cuda"] == 2 * samples,
         f"B1 launched {launches['sample_neighbors_cuda']} times for "
         f"{samples} eager and captured samples of 2 hops")
    for k in ("threefry_hash_cuda", "gather_rows_cuda"):
        need(launches[k] > 0, f"the link phase never launched {k}")
    rep["launches"] = launches
    rep["plain_hash_calls"] = plain_calls
    rep["samples"] = samples

    # -- the loader's batches ----------------------------------------------
    need(len(batches) == LINK_BATCHES, f"{len(batches)} loader batches")
    neg_edges = 0
    for i, b in enumerate(batches):
        lo = i * LINK_BS
        src = loader_edges[0, lo: lo + LINK_BS]
        ns, nd = check_link_batch(b, src, loader_edges[1, lo: lo + LINK_BS],
                                  feat, 1)
        neg_edges += sum(is_edge(indptr, indices, a, c)
                         for a, c in zip(ns.tolist(), nd.tolist()))
    rep["loader_negatives"] = LINK_BATCHES * LINK_BS
    rep["loader_negatives_that_are_edges"] = int(neg_edges)
    rep["link_node_capacity"] = int(batches[0].node.shape[0])
    # the triplet and the weighted batch
    node = trip.node.cpu().numpy()
    meta = {k: v.cpu().numpy() for k, v in trip.metadata.items()}
    need(np.array_equal(node[meta["src_index"]], seed_edges[0, :LINK_BS])
         and np.array_equal(node[meta["dst_pos_index"]],
                            seed_edges[1, :LINK_BS])
         and meta["dst_neg_index"].shape == (LINK_BS, 2)
         and (meta["dst_neg_index"] >= 0).all(), "triplet indices")
    node = weighted.node.cpu().numpy()
    eli = weighted.metadata["edge_label_index"].cpu().numpy()
    need(np.array_equal(node[eli[0, :LINK_BS]], seed_edges[0, :LINK_BS])
         and np.array_equal(node[eli[1, :LINK_BS]], seed_edges[1, :LINK_BS]),
         "weighted batch: a positive does not decode to its seed edge")
    neg_nodes = node[eli[:, LINK_BS:]]
    need((w[neg_nodes] > 0).all(), "a weighted negative is outside the "
                                   "weight's support")

    # -- one batch again on the CPU ------------------------------------------
    t0 = time.perf_counter()
    cpu_graph = Graph(topo, device="cpu", with_sorted_columns=True)
    rep["cpu_sorted_view_s"] = time.perf_counter() - t0
    need(torch.equal(cpu_graph.sorted_indices, graph.sorted_indices.cpu()),
         "the card's sorted view differs from the CPU's")
    cpu_ds = Dataset(graph=cpu_graph, device="cpu")
    cpu_ds.node_features = Feature(feat, device="cpu")
    cpu_loader = LinkNeighborLoader(
        cpu_ds, LINK_FANOUT, loader_edges, batch_size=LINK_BS,
        neg_sampling=NegativeSampling("binary", 1), frontier_cap=LINK_CAP,
        seed=11)
    cb, gb = next(iter(cpu_loader)), batches[0]
    for f in ("x", "edge_index", "node", "node_mask", "edge_mask", "batch"):
        need(torch.equal(getattr(gb, f).cpu(), getattr(cb, f)),
             f"link batch 0: card and CPU differ in {f}")
    for k, v in cb.metadata.items():
        need(torch.equal(gb.metadata[k].cpu(), v),
             f"link batch 0: card and CPU differ in {k}")

    # -- the scanned link step: losses, one batch against the CPU ------------
    link_losses = torch.cat(link_losses).cpu().numpy()
    need(bool(np.isfinite(link_losses).all()), "link losses not finite")
    sb, db, _ = lblocks[0]
    link_pair = []
    for d, g, fe in ((dev, graph, ds.get_node_feature()),
                     ("cpu", cpu_graph, cpu_ds.get_node_feature())):
        m = link_model(torch, GraphSAGE, init_params, d, LINK_HIDDEN)
        s = NeighborSampler(g, LINK_FANOUT, batch_size=LINK_BS,
                            frontier_cap=LINK_CAP, with_edge=False)
        st = make_scanned_link_train_step(s, fe, unsup_dot_loss,
                                          NegativeSampling("binary", 1))
        _, one = st(create_train_state(m, adam(LR)), sb[:1], db[:1],
                    trandom.PRNGKey(30, device=d))
        link_pair.append(float(one[0]))
    need(abs(link_pair[0] - float(link_losses[0]))
         <= F32_LOSS_RTOL * abs(link_pair[0]),
         "the scanned block's first loss differs from the same batch alone")
    link_err = abs(link_pair[0] - link_pair[1]) / max(abs(link_pair[1]),
                                                      1e-30)
    need(link_err <= F32_LOSS_RTOL,
         f"link loss: card {link_pair[0]} vs CPU {link_pair[1]}")

    # -- the scanned subgraph step: batch 0 against the CPU ------------------
    seal_losses = torch.cat(seal_losses).cpu().numpy()
    need(bool(np.isfinite(seal_losses).all()), "subgraph losses not finite")
    sb, yb = gblocks[0]
    cpu_gsamp = NeighborSampler(cpu_graph, SEAL_FANOUT,
                                batch_size=2 * SEAL_BS, with_edge=True)
    outs = [s.subgraph(NodeSamplerInput(sb[0]), max_degree=SEAL_DEGREE,
                       key=trandom.split(trandom.PRNGKey(40, device=d),
                                         GROUP)[0])
            for s, d in ((gsamp, dev), (cpu_gsamp, "cpu"))]
    for f in ("node", "row", "col", "edge", "batch", "node_mask",
              "edge_mask", "num_sampled_nodes"):
        need(torch.equal(getattr(outs[0], f).cpu(), getattr(outs[1], f)),
             f"subgraph batch 0: card and CPU differ in {f}")
    need(sorted(outs[0].metadata) == sorted(outs[1].metadata),
         "subgraph batch 0: card and CPU metadata keys differ")
    for k, v in outs[1].metadata.items():
        need(torch.equal(outs[0].metadata[k].cpu(), v),
             f"subgraph batch 0: card and CPU differ in {k}")
    n_nodes, n_edges = check_induced(outs[0], indptr, indices)
    seal_pair = []
    for s, d, fe in ((gsamp, dev, ds.get_node_feature()),
                     (cpu_gsamp, "cpu", cpu_ds.get_node_feature())):
        m = link_model(torch, GraphSAGE, init_params, d, SEAL_HIDDEN)
        st = make_scanned_subgraph_train_step(s, fe, pair_loss,
                                              max_degree=SEAL_DEGREE)
        _, one = st(create_train_state(m, adam(LR)), sb[:1], yb[:1],
                    trandom.PRNGKey(40, device=d))
        seal_pair.append(float(one[0]))
    need(abs(seal_pair[0] - float(seal_losses[0]))
         <= F32_LOSS_RTOL * abs(seal_pair[0]),
         "the scanned subgraph block's first loss differs from the same "
         "batch alone")
    seal_err = abs(seal_pair[0] - seal_pair[1]) / max(abs(seal_pair[1]),
                                                      1e-30)
    need(seal_err <= F32_LOSS_RTOL,
         f"subgraph loss: card {seal_pair[0]} vs CPU {seal_pair[1]}")

    # -- each step: a replayed block against an eager block from one state,
    #    both profiled, then blocks timed in turns ------------------------
    lmake = (lambda: link_model(torch, GraphSAGE, init_params, dev,
                                LINK_HIDDEN))
    gmake = (lambda: link_model(torch, GraphSAGE, init_params, dev,
                                SEAL_HIDDEN))
    states = {"link": lstate, "subgraph": gstate}
    fresh = {"link": lambda: make_scanned_link_train_step(
                 lsamp, ds.get_node_feature(), unsup_dot_loss,
                 NegativeSampling("binary", 1)),
             "subgraph": lambda: make_scanned_subgraph_train_step(
                 gsamp, ds.get_node_feature(), pair_loss,
                 max_degree=SEAL_DEGREE)}
    graph_steps = {"link": lstep, "subgraph": gstep}
    args = {"link": lblocks[1][:2], "subgraph": gblocks[1]}
    makes = {"link": lmake, "subgraph": gmake}
    profiled, replay_rel, turn_ms = {}, {}, {}
    for name in ("link", "subgraph"):
        twin = copy_state(states[name], makes[name], adam(LR))
        key = trandom.PRNGKey(50, device=dev)
        outs = {}
        for route, run in (("replayed", graph_steps[name]),
                           ("eager", fresh[name]())):
            with profile_window(torch) as prof:
                t1 = time.perf_counter()
                if route == "replayed":
                    states[name], ls = run(states[name], *args[name], key)
                else:
                    twin, ls = run(twin, *args[name], key)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t1) * 1e3 / GROUP
            profiled[f"{name}_{route}"] = device_profile(torch, prof, GROUP,
                                                         wall)
            outs[route] = ls.double().cpu()
        rel = ((outs["replayed"] - outs["eager"]).abs()
               / outs["eager"].abs().clamp(min=1e-30)).tolist()
        need(max(rel) <= F32_LOSS_RTOL,
             f"{name}: replayed block's losses {outs['replayed'].tolist()} "
             f"vs eager {outs['eager'].tolist()}")
        replay_rel[name] = rel
        # Blocks timed in turns, eager, graph, graph, eager: the eager
        # ones on the copy through fresh steps, the graph ones replayed.
        turn_ms[name] = {"eager": [], "graph": []}
        for j, route in enumerate(("eager", "graph", "graph", "eager")):
            key = trandom.PRNGKey(60 + j, device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if route == "eager":
                twin, _ = fresh[name]()(twin, *args[name], key)
            else:
                states[name], _ = graph_steps[name](states[name],
                                                    *args[name], key)
            torch.cuda.synchronize()
            turn_ms[name][route].append((time.perf_counter() - t1) * 1e3)
        del twin
    lstate, gstate = states["link"], states["subgraph"]

    # -- B2 at the link path's node list ---------------------------------
    rows = ds.get_node_feature().hot_rows
    ids = batches[0].node
    idx = torch.where(ids >= 0, ids, 0).to(torch.int32).contiguous()
    uniq = int(torch.unique(idx).numel())
    nbytes = idx.shape[0] * 4 + uniq * FEAT_DIM * 4 + idx.shape[0] * FEAT_DIM * 4
    lib = idx.long()
    rep["b2_link"] = {
        "shape": [int(idx.shape[0]), FEAT_DIM],
        "ms": cuda_ms(torch, lambda: ops.gather_rows_cuda(rows, idx)),
        "plain_ms": cuda_ms(torch, lambda: ops.gather_rows_plain(rows, idx)),
        "library_ms": cuda_ms(torch, lambda: torch.index_select(rows, 0,
                                                                lib)),
        "bound_ms": bound_ms(nbytes), "bytes": nbytes}
    rep.update({
        "link_losses": link_losses.tolist(),
        "link_block_ms": link_ms,
        # Blocks 2 and 3 replay (block 0 is eager, block 1 captures).
        "link_step_ms_median": statistics.median(link_ms[2:]) / GROUP,
        "link_cpu_loss": link_pair[1], "link_card_loss": link_pair[0],
        "link_cpu_loss_rel_err": link_err,
        "seal_losses": seal_losses.tolist(),
        "seal_block_ms": seal_ms,
        "seal_step_ms_median": statistics.median(seal_ms[2:]) / GROUP,
        "seal_checked": {"nodes": n_nodes, "induced_edges": n_edges},
        "seal_cpu_loss": seal_pair[1], "seal_card_loss": seal_pair[0],
        "seal_cpu_loss_rel_err": seal_err,
        "profile": profiled,
        "replay_vs_eager_rel": replay_rel,
        "turn_ms": turn_ms,
        "captures": captures,
    })
    return rep


# -- phase 9: heterogeneous graphs -------------------------------------------
def hetero_host(ds):
    """Host copies for the checks: per edge type the CSR and the CSR
    position of each edge id; per node type the feature rows."""
    csr = {}
    for et, g in ds.graph.items():
        topo = g.topo
        pos = np.empty(topo.edge_ids.shape[0], np.int64)
        pos[topo.edge_ids] = np.arange(topo.edge_ids.shape[0])
        csr[et] = (topo.indptr, topo.indices, pos)
    feats = {t: ds.get_node_feature(t).hot_rows.cpu().numpy()
             for t in ds.get_node_types()}
    return csr, feats


def check_hetero_batch(b, csr, feats, labels):
    """Every valid edge of every reversed edge type is a real edge of its
    forward type (its id at that edge's CSR position); ``x[t]`` equals
    the rows (zeros on padding); ``y`` equals the labels.  Returns the
    number of edges checked."""
    from glt_tpu_torch.typing import reverse_edge_type

    node = {t: v.cpu().numpy() for t, v in b.node.items()}
    edges = 0
    for rev, ei in b.edge_index.items():
        fwd = reverse_edge_type(rev)
        indptr, indices, pos = csr[fwd]
        m = b.edge_mask[rev].cpu().numpy()
        ei = ei.cpu().numpy()[:, m]
        dst, src = node[rev[0]][ei[0]], node[rev[2]][ei[1]]
        need((dst >= 0).all() and (src >= 0).all(),
             f"{rev}: an edge leaves the node set")
        p = pos[b.edge_id[rev].cpu().numpy()[m]]
        need(np.array_equal(indices[p], dst) and (p >= indptr[src]).all()
             and (p < indptr[src + 1]).all(),
             f"{rev}: an edge is not an edge of {fwd}")
        edges += int(m.sum())
    for t, x in b.x.items():
        x = x.cpu().numpy()
        valid = node[t] >= 0
        need(np.array_equal(x[valid], feats[t][node[t][valid]])
             and not x[~valid].any(), f"x[{t}] differs from its rows")
    y = b.y["paper"].cpu().numpy()
    valid = node["paper"] >= 0
    need(np.array_equal(y[valid], labels[node["paper"][valid]])
         and (y[~valid] == -1).all(), "y differs from the labels")
    return edges


def b1_per_sample(sampler, widths=None) -> int:
    """B1 launches of one sample: its (hop, edge type) pairs with a
    nonzero fanout and source width."""
    widths = sampler.hop_widths if widths is None else widths
    return sum(1 for et in sampler.edge_types
               for h, f in enumerate(sampler.num_neighbors[et])
               if f > 0 and widths[h][et[0]] > 0)


def attention_mass(torch, model, b) -> float:
    """HGT's attention mass per destination against 1 for a node with an
    incoming edge of any type and 0 otherwise: the largest deviation over
    layers, node types and heads."""
    model.record_attention()
    with torch.no_grad():
        model(b.x, b.edge_index, b.edge_mask)
    model.record_attention(False)
    worst = 0.0
    for layer in model.layers:
        for t, mass in layer.att_weight_sum.items():
            has_in = torch.zeros(mass.shape[0], dtype=torch.bool,
                                 device=mass.device)
            for et, ei in b.edge_index.items():
                if et[2] == t:
                    has_in[ei[1][b.edge_mask[et]].long()] = True
            worst = max(worst, float((mass - has_in.float()[:, None])
                                     .abs().max()))
    return worst


def time_hetero_kernels(torch, ops, trandom, ds, sampler, out, sm_mhz):
    """B1 at this configuration's hop shapes (the seed frontier, then the
    widest next-hop frontier, of sample ``out``) and B2 at each node
    type's node list of ``out``, against their bounds."""
    widths = sampler.hop_widths
    t1 = max(widths[1], key=lambda t: widths[1][t])
    lo = int(out.num_sampled_nodes[t1][0])
    frontiers = [(0, sampler.input_type,
                  out.node[sampler.input_type][:sampler.batch_size]),
                 (1, t1, out.node[t1][lo: lo + widths[1][t1]])]
    rows = {"B1": [], "B2": []}
    for hop, t, frontier in frontiers:
        frontier = frontier.contiguous()
        et = next(e for e in sampler.edge_types if e[0] == t)
        g = ds.get_graph(et)
        f = sampler.num_neighbors[et][hop]
        key = trandom.PRNGKey(hop, device=frontier.device)

        def b1(fn=ops.sample_neighbors_cuda):
            return fn(g.indptr, g.indices, frontier, f, key,
                      edge_ids=g.gather_edge_ids)

        nbytes, nops = b1_work(g.indptr, frontier, f, b1().mask)
        bound, by = bound_of(nbytes, nops, sm_mhz)
        rows["B1"].append({
            "edge_type": list(et), "shape": [int(frontier.shape[0]), f],
            "ms": cuda_ms(torch, b1),
            "plain_ms": cuda_ms(torch, lambda: b1(
                ops.sample_neighbors_plain), reps=5, rounds=3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "int_ops": nops, "library_ms": None})
    for t, node in out.node.items():
        table = ds.get_node_feature(t).hot_rows
        d = table.shape[1]
        idx = torch.where(node >= 0, node, 0).to(torch.int32).contiguous()
        uniq = int(torch.unique(idx).numel())
        nbytes = idx.shape[0] * 4 + uniq * d * 4 + idx.shape[0] * d * 4
        lib = idx.long()
        rows["B2"].append({
            "node_type": t, "shape": [int(idx.shape[0]), d],
            "ms": cuda_ms(torch, lambda: ops.gather_rows_cuda(table, idx)),
            "plain_ms": cuda_ms(torch, lambda: ops.gather_rows_plain(
                table, idx)),
            "library_ms": cuda_ms(torch, lambda: torch.index_select(
                table, 0, lib)),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "bytes": nbytes})
    return rows


def run_hetero_model(torch, ops, trandom, dev, name, sm_mhz):
    """One configuration of phase 9: ``name`` is "rgat" (the rgat_igbh
    twin's settings on IGBH) or "hgt" (the train_hgt_mag twin's on MAG);
    see the module docstring."""
    import argparse

    from glt_tpu_torch.data import Dataset, Feature, Graph
    from glt_tpu_torch.examples import datasets as tdatasets
    from glt_tpu_torch.examples import rgat_igbh, train_hgt_mag
    from glt_tpu_torch.loader import HeteroNeighborLoader
    from glt_tpu_torch.models import (
        adam,
        init_hetero_state,
        make_eval_step,
        make_scanned_hetero_train_step,
        node_seed_blocks,
        run_scanned_epoch,
    )
    from glt_tpu_torch.sampler import HeteroNeighborSampler, NodeSamplerInput

    cfg = HETERO[name]
    twin = rgat_igbh if name == "rgat" else train_hgt_mag
    args = argparse.Namespace(hidden=HGT_HIDDEN, heads=HGT_HEADS,
                              fanout=list(cfg["fanout"]), bf16=False,
                              device=str(dev))
    t0 = time.perf_counter()
    ds, train_idx, classes = getattr(tdatasets, cfg["dataset"])(
        scale=cfg["scale"], device=dev)
    csr, feats = hetero_host(ds)
    labels = ds.get_node_label("paper")
    rep = {"build_s": time.perf_counter() - t0,
           "nodes": {t: int(f.shape[0]) for t, f in feats.items()},
           "edges": {"__".join(et): int(c[1].shape[0])
                     for et, c in csr.items()}}
    rng = np.random.default_rng(cfg["seed"])
    perm = rng.permutation(train_idx)
    loader_idx = perm[: HET_BATCHES * HET_BS]
    train_ids = perm[HET_BATCHES * HET_BS:][: HET_BLOCKS * GROUP * HET_BS]
    feat_of = {t: ds.get_node_feature(t) for t in ds.get_node_types()}
    label_of = {"paper": labels}

    def make():
        return twin.make_model(ds, classes, args)

    # -- the main path: counts set to 0 just before, read just after ------
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loader = HeteroNeighborLoader(ds, cfg["fanout"], ("paper", loader_idx),
                                  batch_size=HET_BS, shuffle=True, seed=0)
    batches = list(loader)
    sampler = HeteroNeighborSampler(ds.graph, cfg["fanout"], "paper",
                                    batch_size=HET_BS, seed=0)
    state = init_hetero_state(make(), adam(cfg["lr"]), sampler, feat_of)
    step = make_scanned_hetero_train_step(sampler, feat_of, label_of, HET_BS)
    stamps = [time.perf_counter()]
    state, losses, accs, _ = run_scanned_epoch(
        step, state, train_ids, HET_BS, GROUP, np.random.default_rng(5),
        trandom.PRNGKey(100, device=dev),
        on_block=lambda st, i: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    plain_calls = trandom.threefry2x32.calls
    peak = torch.cuda.max_memory_allocated()
    need(plain_calls == 0, f"{name}: the hetero path ran the plain threefry "
                           f"arithmetic on the card ({plain_calls} calls)")
    per_sample = b1_per_sample(sampler)
    need(per_sample == cfg["b1_per_step"], f"{name}: {per_sample} B1 "
                                           f"launches a sample")
    # The loader's samples (its prefetch included), the eager block and
    # the capture; the replays move no counter.
    samples = loader.sampler._call_count + 2 * GROUP
    need(launches["sample_neighbors_cuda"] == per_sample * samples,
         f"{name}: B1 launched {launches['sample_neighbors_cuda']} times "
         f"for {samples} samples of {per_sample}")
    ntypes = len(feat_of)
    need(launches["gather_rows_cuda"] == ntypes * (len(batches) + 2 * GROUP),
         f"{name}: B2 launched {launches['gather_rows_cuda']} times, not "
         f"once per node type a batch")
    need(launches["threefry_hash_cuda"] > 0, f"{name}: no hash-kernel launch")
    need(losses.shape == (HET_BLOCKS * GROUP,)
         and bool(np.isfinite(losses).all()), f"{name}: losses {losses}")
    block_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

    # -- the loader's batches ---------------------------------------------
    need(len(batches) == HET_BATCHES, f"{name}: {len(batches)} batches")
    checked = sum(check_hetero_batch(b, csr, feats, labels) for b in batches)
    cpu_ds = Dataset(device="cpu")
    cpu_ds.graph = {et: Graph(g.topo, device="cpu")
                    for et, g in ds.graph.items()}
    cpu_ds.node_features = {t: Feature(f, device="cpu")
                            for t, f in feats.items()}
    cpu_ds.node_labels = ds.node_labels
    cb = next(iter(HeteroNeighborLoader(
        cpu_ds, cfg["fanout"], ("paper", loader_idx), batch_size=HET_BS,
        shuffle=True, seed=0)))
    gb = batches[0]
    for f in ("x", "y", "edge_index", "edge_id", "node", "node_mask",
              "edge_mask", "batch"):
        for k, v in getattr(cb, f).items():
            need(torch.equal(getattr(gb, f)[k].cpu(), v),
                 f"{name}: batch 0 on the card and the CPU differ in "
                 f"{f}[{k}]")

    # -- one batch's loss on the CPU, from a copy of the state -------------
    ev = make_eval_step(HET_BS, target_type="paper")
    pair = []
    for d, b in ((dev, gb), ("cpu", cb)):
        m = make()
        m.load_state_dict(state.model.state_dict())
        pair.append(float(ev(m.to(d), b)[0]))
    loss_err = abs(pair[0] - pair[1]) / max(abs(pair[1]), 1e-30)
    need(loss_err <= F32_LOSS_RTOL, f"{name}: card loss {pair[0]} vs CPU "
                                    f"{pair[1]}")

    # -- one replayed block against an eager block from one state ---------
    blk = next(node_seed_blocks(perm[-GROUP * HET_BS:], HET_BS, GROUP,
                                np.random.default_rng(6)))
    twin_state = copy_state(state, make, adam(cfg["lr"]))
    key = trandom.PRNGKey(7, device=dev)
    with profile_window(torch) as prof:
        t1 = time.perf_counter()
        state, ls_graph, _ = step(state, blk, key)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / GROUP
    profiled = device_profile(torch, prof, GROUP, wall)
    profiled["b1_kernels"] = b1_kernels(torch, prof) / GROUP
    need(profiled["b1_kernels"] == per_sample,
         f"{name}: B1 ran {profiled['b1_kernels']} times a replayed step, "
         f"not {per_sample}")
    fresh = make_scanned_hetero_train_step(sampler, feat_of, label_of,
                                           HET_BS)
    with profile_window(torch) as prof:
        t1 = time.perf_counter()
        twin_state, ls_eager, _ = fresh(twin_state, blk, key)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3 / GROUP
    eager_profiled = device_profile(torch, prof, GROUP, wall)
    eager_profiled["b1_kernels"] = b1_kernels(torch, prof) / GROUP
    lg, le = ls_graph.double().cpu(), ls_eager.double().cpu()
    replay_rel = ((lg - le).abs() / le.abs().clamp(min=1e-30)).tolist()
    need(replay_rel[0] <= F32_LOSS_RTOL,
         f"{name}: replayed block's first loss {lg[0]} vs eager {le[0]}")
    need(max(replay_rel) <= 1e-3, f"{name}: replayed block's losses "
                                  f"{lg.tolist()} vs eager {le.tolist()}")
    eager_ms = []
    for j in range(2):
        fresh = make_scanned_hetero_train_step(sampler, feat_of, label_of,
                                               HET_BS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        twin_state, _, _ = fresh(twin_state, blk,
                                 trandom.PRNGKey(8 + j, device=dev))
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t1) * 1e3)
    mass_err = None
    if name == "hgt":
        mass_err = attention_mass(torch, state.model, gb)
        need(mass_err <= 1e-5, f"hgt: attention mass off by {mass_err}")
    out = sampler.sample_from_nodes(NodeSamplerInput(blk[0]),
                                    key=trandom.PRNGKey(9, device=dev))
    rep.update({
        "launches": launches, "plain_hash_calls": plain_calls,
        "b1_per_sample": per_sample, "samples": samples,
        "node_capacity": sampler.node_capacity,
        "loader_batches": len(batches), "edges_checked": checked,
        "losses": losses.tolist(), "accs": accs.tolist(),
        "block_ms": block_ms,
        "step_ms_median": statistics.median(block_ms[2:]) / GROUP,
        "eager_block_ms": eager_ms,
        "eager_step_ms_median": statistics.median(eager_ms) / GROUP,
        "replay_vs_eager_rel": replay_rel, "profile": profiled,
        "eager_profile": eager_profiled, "max_memory_allocated": peak,
        "card_loss": pair[0], "cpu_loss": pair[1],
        "cpu_loss_rel_err": loss_err, "attention_mass_err": mass_err,
        "kernels": time_hetero_kernels(torch, ops, trandom, ds, sampler,
                                       out, sm_mhz)})
    return rep, ds, csr


def run_hetero_link(torch, ops, trandom, ds, csr):
    """``HeteroLinkNeighborLoader`` on MAG's ``writes`` (binary x 1,
    fanout (5, 5), 64 seed edges a batch) for HET_BATCHES batches:
    positives decode to their seed edges; negatives that are real edges
    are counted against the host CSR."""
    from glt_tpu_torch.loader import HeteroLinkNeighborLoader
    from glt_tpu_torch.sampler import NegativeSampling

    et = ("author", "writes", "paper")
    indptr, indices, _ = csr[et]
    rng = np.random.default_rng(21)
    pos = rng.integers(0, indices.shape[0], HET_BATCHES * HET_BS)
    eli = np.stack([edge_sources(indptr, pos), indices[pos]])
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    torch.cuda.synchronize()
    loader = HeteroLinkNeighborLoader(
        ds, list(HETERO["hgt"]["fanout"]), (et, eli), batch_size=HET_BS,
        neg_sampling=NegativeSampling("binary", 1), seed=3)
    batches = list(loader)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    plain_calls = trandom.threefry2x32.calls
    need(plain_calls == 0, "hetero link: plain threefry on the card")
    s = loader.sampler
    widths = s._edge_plan(et, "binary", 1)[0]
    per_sample = b1_per_sample(s, widths)
    need(launches["sample_neighbors_cuda"] == per_sample * s._call_count,
         f"hetero link: B1 launched {launches['sample_neighbors_cuda']} "
         f"times for {s._call_count} samples of {per_sample}")
    need(len(batches) == HET_BATCHES, "hetero link: batch count")
    neg_edges = 0
    for i, b in enumerate(batches):
        lab = b.metadata["edge_label"].cpu().numpy()
        e = b.metadata["edge_label_index"].cpu().numpy()
        src = b.node["author"].cpu().numpy()[e[0]]
        dst = b.node["paper"].cpu().numpy()[e[1]]
        seed = eli[:, i * HET_BS: (i + 1) * HET_BS]
        need(np.array_equal(src[:HET_BS], seed[0])
             and np.array_equal(dst[:HET_BS], seed[1])
             and (lab[:HET_BS] == 1).all() and (lab[HET_BS:] == 0).all(),
             f"hetero link batch {i}: a positive does not decode to its "
             f"seed edge")
        need((e[:, HET_BS:] >= 0).all(), "hetero link: a negative is not "
                                         "in the batch")
        neg_edges += sum(is_edge(indptr, indices, a, c) for a, c in
                         zip(src[HET_BS:].tolist(), dst[HET_BS:].tolist()))
    return {"launches": launches, "plain_hash_calls": plain_calls,
            "b1_per_sample": per_sample, "samples": s._call_count,
            "negatives": HET_BATCHES * HET_BS,
            "negatives_that_are_edges": int(neg_edges)}


def run_hetero(torch, ops, trandom, dev, sm_mhz) -> dict:
    """Phase 9 (see the module docstring)."""
    rep = {}
    rep["rgat"], _, _ = run_hetero_model(torch, ops, trandom, dev, "rgat",
                                         sm_mhz)
    rep["hgt"], ds, csr = run_hetero_model(torch, ops, trandom, dev, "hgt",
                                           sm_mhz)
    rep["link"] = run_hetero_link(torch, ops, trandom, ds, csr)
    rep["launches"] = {k: sum(rep[p]["launches"][k]
                              for p in ("rgat", "hgt", "link"))
                       for k in rep["link"]["launches"]}
    return rep


# -- phase 10: checkpoints and observability ---------------------------------
def small_arrays(seed: int):
    """A SMALL_N-node graph of the products recipe (numpy seed ``seed``)
    with 100-wide features and 47-class labels (seed ``seed + 1``)."""
    indptr, indices = build_graph(seed, SMALL_N)
    drng = np.random.default_rng(seed + 1)
    feat = drng.standard_normal((SMALL_N, FEAT_DIM), dtype=np.float32)
    labels = drng.integers(0, CLASSES, SMALL_N).astype(np.int32)
    return indptr, indices, feat, labels


def node_step(torch, dev, indptr, indices, feat, labels, node_cap):
    """Phase 5's scanned node step (capped sampler, B3 gather) on a
    graph built on ``dev``: ``(sampler, step)``."""
    from glt_tpu_torch.data import CSRTopo, Dataset, Graph
    from glt_tpu_torch.models import make_scanned_node_train_step
    from glt_tpu_torch.sampler import NeighborSampler

    ds = Dataset(graph=Graph(CSRTopo.from_csr_arrays(indptr, indices),
                             device=dev), device=dev)
    ds.init_node_features(feat)
    sampler = NeighborSampler(ds.get_graph(), FANOUTS,
                              node_capacity=node_cap, batch_size=TRAIN_BS,
                              frontier_cap=FRONTIER_CAP, with_edge=False)
    return sampler, make_scanned_node_train_step(
        sampler, ds.get_node_feature(), labels, TRAIN_BS,
        fused_frontier=True)


def node_step_loop(torch, dev, step, train_idx, epochs, checkpointer=None,
                   fault_plan=None, rng_seed=21, key_seed=22):
    """A TrainLoop over ``step`` (bf16 GraphSAGE, dropout 0.5, Adam) from
    a fresh model of numpy seed 0."""
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.ckpt import TrainLoop
    from glt_tpu_torch.models import GraphSAGE, adam, create_train_state

    state = create_train_state(
        random_model(torch, GraphSAGE, dev, dtype=torch.bfloat16), adam(LR))
    return TrainLoop(step, state, train_idx, TRAIN_BS, GROUP, epochs,
                     np.random.default_rng(rng_seed),
                     trandom.PRNGKey(key_seed, device=dev),
                     checkpointer=checkpointer, fault_plan=fault_plan)


def param_gap(a, b) -> float:
    """The L2 distance between two parameter lists (float64 sums)."""
    return float(sum(float((x.detach().double() - y.detach().double())
                           .pow(2).sum()) for x, y in zip(a, b))) ** 0.5


def state_mismatch(a, b) -> list:
    """Where two train states differ: parameters, Adam's state and the
    step compared exactly (a restore is a copy, so on the card too)."""
    bad = [] if a.step == b.step else [f"step {a.step} vs {b.step}"]
    pa, pb = list(a.model.parameters()), list(b.model.parameters())
    for i, (x, y) in enumerate(zip(pa, pb)):
        if not torch_equal(x, y):
            bad.append(f"param {i}")
        sa, sb = a.optimizer.state.get(x, {}), b.optimizer.state.get(y, {})
        if sorted(sa) != sorted(sb):
            bad.append(f"optimizer state {i}: keys {sorted(sa)} vs "
                       f"{sorted(sb)}")
            continue
        bad += [f"optimizer state {i}.{k}" for k in sa
                if not torch_equal(sa[k], sb[k])]
    return bad


def torch_equal(x, y) -> bool:
    import torch

    if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
        return x.shape == y.shape and x.dtype == y.dtype and bool(
            torch.equal(x, y.to(x.device)))
    return x == y


def param_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for v in state.model.state_dict().values():
        h.update(v.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def ckpt_worker(root: str, out: str, node_cap: int, kill_at=None) -> int:
    """``--ckpt-worker``: one training process of the SIGKILL leg on the
    SMALL_N graph: checkpoint every block, resume from ``root`` if it
    holds one, SIGKILL itself after block ``kill_at`` when given, else
    write the losses, a parameter digest and its launch counts to
    ``out``."""
    import torch
    from glt_tpu_torch import ops
    from glt_tpu_torch.ckpt import Checkpointer
    from glt_tpu_torch.ops import cuda_lib
    from glt_tpu_torch.testing import FaultPlan

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cuda_lib.library()                      # the parent's cached build
    dev = torch.device(DEVICE)
    _, step = node_step(torch, dev, *small_arrays(3), int(node_cap))
    train_idx = np.random.default_rng(5).permutation(SMALL_N)[
        : WORKER_BLOCKS * GROUP * TRAIN_BS]
    plan = (None if kill_at is None
            else FaultPlan(kill_at_train_step=int(kill_at)))
    loop = node_step_loop(torch, dev, step, train_idx, CKPT_EPOCHS,
                          Checkpointer(root, every_n_steps=1, keep=2), plan)
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    setup_s = time.perf_counter() - t0
    snap = loop.resume()
    state = loop.run()                      # a kill_at run dies in here
    torch.cuda.synchronize()
    res = {"resumed_from": None if snap is None else snap.step,
           "losses": loop.losses, "param_digest": param_digest(state),
           "launches": {k: fn.launches
                        for k, fn in kernel_wrappers(ops).items()},
           "setup_s": setup_s, "wall_s": time.perf_counter() - t0}
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(res, fh)
    os.replace(tmp, out)
    return 0


def run_sigkill(torch, node_cap: int, work: str) -> dict:
    """The SIGKILL leg: a worker run straight through, a worker that
    SIGKILLs itself after block WORKER_KILL_AT, and a worker that
    resumes from its checkpoints; the resumed losses against the
    straight run's."""
    from glt_tpu_torch.ckpt import latest_step

    script = os.path.abspath(__file__)

    def worker(root, out, *kill):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, script, "--ckpt-worker", root, out,
             str(node_cap), *map(str, kill)], capture_output=True,
            text=True, timeout=600, cwd=os.path.dirname(script))
        return proc, time.perf_counter() - t

    ref_out = os.path.join(work, "worker_ref.json")
    proc, ref_s = worker(os.path.join(work, "worker_ref"), ref_out)
    need(proc.returncode == 0, f"SIGKILL leg: the straight worker failed "
                               f"({proc.returncode}): {proc.stderr[-2000:]}")
    ref = json.load(open(ref_out))
    root = os.path.join(work, "worker_chaos")
    out = os.path.join(work, "worker_chaos.json")
    proc, kill_s = worker(root, out, WORKER_KILL_AT)
    need(proc.returncode == -signal.SIGKILL,
         f"SIGKILL leg: the worker exited {proc.returncode}, not by "
         f"SIGKILL: {proc.stderr[-2000:]}")
    need(not os.path.exists(out) and latest_step(root) == WORKER_KILL_AT,
         f"SIGKILL leg: newest checkpoint {latest_step(root)}, not "
         f"{WORKER_KILL_AT}")
    proc, resume_s = worker(root, out)
    need(proc.returncode == 0, f"SIGKILL leg: the resumed worker failed "
                               f"({proc.returncode}): {proc.stderr[-2000:]}")
    got = json.load(open(out))
    need(got["resumed_from"] == WORKER_KILL_AT, "SIGKILL leg: resume step")
    tail = ref["losses"][len(ref["losses"]) - len(got["losses"]):]
    need(len(got["losses"]) == (CKPT_EPOCHS * WORKER_BLOCKS
                                - WORKER_KILL_AT) * GROUP,
         f"SIGKILL leg: {len(got['losses'])} losses after the resume")
    diffs = [abs(a - b) for a, b in zip(got["losses"], tail)]
    rel = max(d / max(abs(b), 1e-30) for d, b in zip(diffs, tail))
    need(rel <= LOSS_RTOL, f"SIGKILL leg: resumed losses {got['losses']} "
                           f"vs the straight run's {tail}")
    for k in ("sample_neighbors_cuda", "fused_frontier_cuda",
              "threefry_hash_cuda"):
        need(got["launches"][k] > 0, f"SIGKILL leg: the resumed worker "
                                     f"never launched {k}")
    return {"nodes": SMALL_N, "blocks_per_epoch": WORKER_BLOCKS,
            "kill_at": WORKER_KILL_AT, "loss_max_abs_diff": max(diffs),
            "loss_max_rel_diff": rel,
            "losses_bit_identical": got["losses"] == tail,
            "params_bit_identical":
                got["param_digest"] == ref["param_digest"],
            "worker_s": {"straight": ref_s, "killed": kill_s,
                         "resumed": resume_s},
            "worker_setup_s": got["setup_s"],
            "resumed_launches": got["launches"]}


def run_refresh_resume(torch, dev, work: str) -> dict:
    """``RefreshDriver(checkpointer=)`` on the SMALL_N graph from an int8
    store (split 1.0: B4): a refresh straight through, one killed after
    its first sweep, and a fresh driver resumed from the checkpoints;
    the resumed rows within REFRESH_RTOL of the straight run's.  A second
    straight refresh is the control: each layer's rows, straight against
    straight and straight against resumed, with the sweeps that differ."""
    from glt_tpu_torch.ckpt import Checkpointer, latest_step
    from glt_tpu_torch.models import GraphSAGE
    from glt_tpu_torch.refresh import RefreshDriver, sage_refresh_layers
    from glt_tpu_torch.store import DiskFeatureStore, write_feature_store

    indptr, indices, feat, _ = small_arrays(7)
    root = write_feature_store(os.path.join(work, "int8"), feat,
                               codec="int8")
    layers = sage_refresh_layers(random_model(torch, GraphSAGE, dev,
                                              dropout_rate=0.0))
    ck_root = os.path.join(work, "refresh_ck")

    class Killed(Exception):
        pass

    def kill(drv, layer, sweep):
        raise Killed

    def driver(out, **kw):
        return RefreshDriver(indptr, indices, layers, DiskFeatureStore(root),
                             os.path.join(work, out),
                             block_size=REFRESH_BLOCK,
                             max_degree=REFRESH_MAX_DEGREE,
                             split_ratio=1.0, device=dev, **kw)

    t0 = time.perf_counter()
    straight = driver("straight").run()
    straight_s = time.perf_counter() - t0
    driver("straight2").run()
    try:
        driver("resumed", on_sweep=kill, checkpointer=Checkpointer(
            ck_root, every_n_steps=1, keep=2)).run()
        raise Failed("refresh leg: the kill did not fire")
    except Killed:
        pass
    need(latest_step(ck_root) == 1, "refresh leg: no checkpoint of sweep 1")
    t0 = time.perf_counter()
    resumed = driver("resumed", checkpointer=Checkpointer(
        ck_root, every_n_steps=1, keep=2)).run()
    resumed_s = time.perf_counter() - t0
    n_layers = len(layers)
    need(resumed["nodes"] == n_layers * SMALL_N - min(REFRESH_BLOCK,
                                                      SMALL_N),
         f"refresh leg: the resumed driver refreshed {resumed['nodes']} "
         f"nodes")
    want = DiskFeatureStore(straight["out_root"]).read_rows(
        np.arange(SMALL_N))
    got = DiskFeatureStore(resumed["out_root"]).read_rows(np.arange(SMALL_N))
    err = float(np.abs(got - want).max())
    rel = err / max(float(np.abs(want).max()), 1e-30)
    need(rel <= REFRESH_RTOL, f"refresh leg: resumed rows vs straight rel "
                              f"{rel}")

    def rows(run, layer):
        return DiskFeatureStore(os.path.join(work, run, f"layer_{layer}")
                                ).read_rows(np.arange(SMALL_N))

    per_layer = []
    for layer in range(n_layers):
        base = rows("straight", layer)
        entry = {}
        for run in ("straight2", "resumed"):
            d = np.abs(rows(run, layer) - base).max(axis=1)
            sweeps = np.unique(np.nonzero(d)[0] // REFRESH_BLOCK)
            entry[run] = {"max_abs_diff": float(d.max()),
                          "rows_differ": int(np.count_nonzero(d)),
                          "sweeps_differ": sweeps[:8].tolist(),
                          "n_sweeps_differ": int(sweeps.size)}
        per_layer.append(entry)
    return {"nodes": SMALL_N, "layers": n_layers,
            "num_sweeps": straight["num_sweeps"], "rows_max_abs_diff": err,
            "rows_rel_diff": rel, "bit_identical": err == 0.0,
            "control_max_abs_diff": per_layer[-1]["straight2"][
                "max_abs_diff"], "per_layer": per_layer,
            "straight_s": straight_s, "resumed_s": resumed_s}


def owner_bytes(owners: dict, owner: str) -> int:
    return owners.get(owner, {}).get("bytes", 0)


def spans_ms(tracer, name: str) -> list:
    return [e["dur"] / 1e3 for e in tracer.events
            if e.get("ph") == "X" and e["name"] == name]


def run_ckpt_obs(torch, dev, indptr, indices, feat, labels, node_cap,
                 rng) -> dict:
    """Phase 10 (see the module docstring)."""
    import shutil

    from glt_tpu_torch import obs, ops
    from glt_tpu_torch import random as trandom
    from glt_tpu_torch.ckpt import (Checkpointer, capture_key, capture_rng,
                                    restore_key, restore_rng)
    from glt_tpu_torch.models import (adam, node_seed_blocks,
                                      run_scanned_epoch)
    from glt_tpu_torch.obs import compilewatch, flight, profiler, roofline
    from glt_tpu_torch.obs import device as obs_device
    from glt_tpu_torch.sampler import NodeSamplerInput
    from glt_tpu_torch.testing import FaultPlan, SimulatedPreemption

    os.makedirs(WORK_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=WORK_DIR)
    rep = {}
    try:
        sampler, step = node_step(torch, dev, indptr, indices, feat, labels,
                                  node_cap)
        train_idx = rng.permutation(PRODUCTS_N)[
            : CKPT_BLOCKS * GROUP * TRAIN_BS]
        rep["train_set"] = {"seeds": int(train_idx.size),
                            "blocks_per_epoch": CKPT_BLOCKS,
                            "epochs": CKPT_EPOCHS}

        def loop(root, plan=None, epochs=CKPT_EPOCHS, **kw):
            ck = Checkpointer(os.path.join(work, root), every_n_steps=1,
                              keep=2)
            return node_step_loop(torch, dev, step, train_idx, epochs, ck,
                                  plan, **kw)

        # -- the main path: counts set to 0 just before, read just after --
        obs.metrics.reset()
        obs.metrics.enable()
        tracer = obs.start_trace(process_name="chip_smoke")
        compilewatch.reset_for_tests()
        for fn in kernel_wrappers(ops).values():
            fn.launches = 0
        trandom.threefry2x32.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The run without a kill, one epoch at a time.
        ref = loop("ref", epochs=1)
        init = [p.detach().clone() for p in ref.state.model.parameters()]
        ref.run()
        c1 = compilewatch.counts()
        ref.epochs = CKPT_EPOCHS
        ref.run()
        c2 = compilewatch.counts()
        captures_epoch = {
            "epoch1": c1, "epoch2": {k: c2[k] - c1.get(k, 0) for k in c2}}
        need(c1.get("scanned_node_step") == 1,
             f"epoch 1 captured {c1} (one block pattern)")
        need(captures_epoch["epoch2"].get("scanned_node_step") == 0,
             f"a steady epoch captured {captures_epoch['epoch2']}")
        # Killed in process after block KILL_AT, then a fresh model,
        # optimizer and TrainLoop (wrong seeds) resume.
        victim = loop("kill", FaultPlan(preempt_at_train_step=KILL_AT))
        try:
            victim.run()
            raise Failed("the in-process kill did not fire")
        except SimulatedPreemption:
            pass
        shutil.copytree(os.path.join(work, "kill"),
                        os.path.join(work, "fault"))
        before = compilewatch.counts("scanned_node_step")
        revived = loop("kill", rng_seed=999, key_seed=0)
        snap = revived.resume()
        need(snap is not None and snap.step == KILL_AT,
             f"resumed from {None if snap is None else snap.step}")
        need(all(st["step"].is_cuda for st in
                 revived.state.optimizer.state.values()),
             "Adam's step left the card in the restore")
        # The restore against the killed run's live state at its kill.
        restored_off = state_mismatch(revived.state, victim.state)
        need(not restored_off, f"the restore differs from the state at the "
                               f"kill: {restored_off[:5]}")
        final = revived.run()
        torch.cuda.synchronize()
        recaptures = compilewatch.counts("scanned_node_step") - before
        need(recaptures == 1, f"{recaptures} captures after the resume, "
                              f"not one per block pattern")
        main_s = time.perf_counter() - t0
        # What holds on the card: the integers exactly, the losses within
        # the node step's tolerance.
        need(revived.global_step == ref.global_step == CKPT_EPOCHS
             * CKPT_BLOCKS and revived.epoch == ref.epoch,
             "the resumed cursor differs")
        need(np.array_equal(capture_key(revived.base_key),
                             capture_key(ref.base_key)), "base keys differ")
        need(capture_rng(revived.rng) == capture_rng(ref.rng),
             "the shuffle streams differ after the resume")
        lp = snap.components["loop"]
        e, nb = int(lp["epoch"]), int(lp["next_block"])
        blk = list(node_seed_blocks(train_idx, TRAIN_BS, GROUP, restore_rng(
            lp["rng_at_epoch_start"])))[nb]
        fresh = np.random.default_rng(21)
        for _ in range(e):
            list(node_seed_blocks(train_idx, TRAIN_BS, GROUP, fresh))
        need(np.array_equal(blk, list(node_seed_blocks(
            train_idx, TRAIN_BS, GROUP, fresh))[nb]),
            "the resumed block's seeds differ")
        keys = [trandom.split(trandom.fold_in(trandom.fold_in(
            k, e), nb), GROUP)[0] for k in (
            restore_key(lp["base_key"], device=dev),
            trandom.PRNGKey(22, device=dev))]
        need(torch.equal(keys[0], keys[1]), "the resumed block's keys differ")
        outs = [sampler.sample_from_nodes(NodeSamplerInput(blk[0]), key=k)
                for k in keys]
        need(torch.equal(outs[0].node, outs[1].node)
             and torch.equal(outs[0].row, outs[1].row),
             "the resumed block's sampled ids differ")
        tail = ref.losses[len(ref.losses) - len(revived.losses):]
        diffs = [abs(a - b) for a, b in zip(revived.losses, tail)]
        loss_rel = max(d / max(abs(b), 1e-30) for d, b in zip(diffs, tail))
        need(loss_rel <= LOSS_RTOL, f"resumed losses {revived.losses} vs "
                                    f"the run without a kill {tail}")
        pdiff = max(float((a.detach().float() - b.detach().float()).abs().max())
                    for a, b in zip(final.model.parameters(),
                                    ref.state.model.parameters()))
        rep["in_process"] = ip = {
            "kill_at": KILL_AT, "resumed_blocks": len(revived.losses)
            // GROUP, "loss_max_abs_diff": max(diffs),
            "loss_max_rel_diff": loss_rel,
            "losses_bit_identical": revived.losses == tail,
            "param_max_abs_diff": pdiff, "main_s": main_s}
        rep["captures"] = {"per_epoch": captures_epoch,
                           "after_resume": recaptures,
                           "all": compilewatch.counts()}
        # The node step's checkpoints, from the trace (the refresh leg
        # saves cursors into the same trace).
        saves = spans_ms(tracer, "ckpt.save")
        resumes = spans_ms(tracer, "ckpt.resume")
        ck_dir = os.path.join(work, "ref", "step_%08d" % ref.global_step)
        rep["checkpoint"] = {
            "save_ms_median": statistics.median(saves), "saves": len(saves),
            "resume_ms_median": statistics.median(resumes),
            "resumes": len(resumes),
            "bytes": sum(os.path.getsize(os.path.join(ck_dir, f))
                         for f in os.listdir(ck_dir))}
        # The control: a second run without a kill, against the first.
        twin = loop("twin")
        twin_state = twin.run()
        ip["run_to_run_loss_max_abs_diff"] = max(
            abs(a - b) for a, b in zip(twin.losses, ref.losses))
        ip["run_to_run_param_max_abs_diff"] = max(
            float((a.detach().float() - b.detach().float()).abs().max())
            for a, b in zip(twin_state.model.parameters(),
                            ref.state.model.parameters()))
        # A planted fault: the same resume with Adam's state dropped.
        bad = loop("fault", rng_seed=999, key_seed=0)
        bad.resume()
        st = bad.state
        bad.state = type(st)(st.model, adam(LR)(st.model.parameters()),
                             st.step)
        fault_off = state_mismatch(bad.state, victim.state)
        need(fault_off, "the state check passes a restore without Adam's "
                        "state")
        bad_state = bad.run()
        # The parameter gaps, relative to how far the run moved them.
        ref_p = list(ref.state.model.parameters())
        moved = param_gap(ref_p, init)
        gaps = {k: param_gap(list(st.model.parameters()), ref_p) / moved
                for k, st in (("resumed", final), ("run_to_run", twin_state),
                              ("fault", bad_state))}
        gate = PARAM_DRIFT_X * max(gaps["run_to_run"], PARAM_GAP_FLOOR)
        ip.update(param_moved_l2=moved, param_rel_gap=gaps,
                  param_gate=gate, fault_state_mismatch=len(fault_off),
                  fault_loss_max_abs_diff=max(
                      abs(a - b) for a, b in zip(bad.losses, tail)))
        need(gaps["resumed"] <= gate,
             f"resumed parameters {gaps['resumed']:.3e} from the run "
             f"without a kill, over the gate {gate:.3e}")
        need(gaps["fault"] > gate,
             f"the planted fault's parameters sit {gaps['fault']:.3e} "
             f"from the run without a kill, inside the gate {gate:.3e}")
        rep["sigkill"] = run_sigkill(torch, node_cap, work)
        rep["refresh"] = run_refresh_resume(torch, dev, work)
        torch.cuda.synchronize()
        rep["launches"] = {k: fn.launches
                           for k, fn in kernel_wrappers(ops).items()}
        rep["plain_hash_calls"] = trandom.threefry2x32.calls
        need(rep["plain_hash_calls"] == 0,
             "phase 10 ran the plain threefry arithmetic on the card")
        for k in ("sample_neighbors_cuda", "fused_frontier_cuda",
                  "threefry_hash_cuda", "gather_rows_dequant_cuda"):
            need(rep["launches"][k] > 0, f"phase 10 never launched {k}")

        # -- readings ------------------------------------------------------
        gc.collect()
        torch.cuda.synchronize()
        gauges = obs_device.publish_device_stats()
        snap_mem = obs_device.snapshot()
        allocated = torch.cuda.memory_allocated()
        census = snap_mem["owners"]
        # The owners sum to the total by construction ("other" is the
        # rest of memory_allocated); what can fail is the claims.
        need(owner_bytes(census, "other") >= 0
             and all(v["bytes"] <= allocated for v in census.values()),
             f"owners {census} claim more than memory_allocated "
             f"{allocated}")
        live_params = sum(p.untyped_storage().nbytes()
                          for st in (ref.state, final, twin_state)
                          for p in st.model.parameters())
        need(owner_bytes(census, "params") >= live_params,
             f"params owner {census.get('params')} below the {live_params} "
             f"B of three live models")
        # A probe of known size is claimed while it lives, and only then.
        probe = torch.empty(PROBE_BYTES, dtype=torch.uint8, device=dev)
        obs_device.register_owner("probe", probe)
        held = obs_device.snapshot()["owners"]
        del probe
        gone = obs_device.snapshot()["owners"]
        drift = [owner_bytes(o, "other") - owner_bytes(census, "other")
                 for o in (held, gone)]
        need(owner_bytes(held, "probe") == PROBE_BYTES
             and "probe" not in gone
             and all(abs(d) < ALLOC_ROUNDING for d in drift),
             f"the probe's census: held {held}, released {gone}")
        rep["device"] = {"gauges": gauges, "owners": census,
                         "total": snap_mem["total"],
                         "memory_allocated": allocated,
                         "live_params": live_params,
                         "probe_other_drift": drift}
        roof = roofline.measure_memcpy_roofline()
        rep["roofline"] = dict(roof, datasheet=roofline.peak_hbm_gb_s())
        rep["span_summary"] = obs.format_summary(
            obs.summarize_trace(tracer.chrome_trace())).splitlines()
        prof = profiler.arm(os.path.join(OUT_DIR, "profiles"), millis=50,
                            min_interval_s=0.0)
        try:
            cap_dir = prof.trigger("phase10")
        finally:
            profiler.disarm()
        need(cap_dir is not None and os.path.isfile(
            os.path.join(cap_dir, "trace.json")),
            "the triggered profiler capture wrote nothing")
        index = [c for c in profiler.capture_index(flight.recorder().events())
                 if c["dir"] == cap_dir]
        need(len(index) == 1, "the capture is not in the flight index")
        rep["profiler_capture"] = {"dir": cap_dir, "flight_index": index[0]}
        # A replayed node step with tracing and metrics on, and off.
        state = final
        turns = {"on": [], "off": []}
        for j, mode in enumerate(OBS_TIMED_TURNS):
            if mode == "on":
                obs.metrics.enable()
                obs.install(tracer)
            else:
                obs.metrics.disable()
                obs.install(None)
            stamps = [time.perf_counter()]
            state = run_scanned_epoch(
                step, state, train_idx, TRAIN_BS, GROUP,
                np.random.default_rng(40 + j),
                trandom.PRNGKey(41 + j, device=dev),
                on_block=lambda st, i: stamps.append(time.perf_counter()))[0]
            turns[mode] += [(b - a) * 1e3 / GROUP
                            for a, b in zip(stamps[1:], stamps[2:])]
        rep["obs_overhead"] = {
            f"step_ms_{m}": statistics.median(v) for m, v in turns.items()}
        rep["obs_overhead"]["blocks_timed"] = {m: len(v)
                                              for m, v in turns.items()}
    finally:
        obs.stop_trace(os.path.join(OUT_DIR, "phase10_trace.json"))
        obs.metrics.disable()
        shutil.rmtree(work, ignore_errors=True)
    return rep


def log_ckpt_obs(co: dict, card: str, wall_s: float) -> None:
    """Phase 10's lines (each number measured on ``card``)."""
    ts, ip, sk, rf = (co["train_set"], co["in_process"], co["sigkill"],
                      co["refresh"])
    ck = co["checkpoint"]
    log(f"ckpt: [{card}] node step at the products settings through "
        f"TrainLoop, checkpoint every block; train set cut to "
        f"{ts['seeds']} seeds ({ts['blocks_per_epoch']} blocks of {GROUP} "
        f"x {TRAIN_BS}) x {ts['epochs']} epochs; save median "
        f"{ck['save_ms_median']:.2f} ms over {ck['saves']} saves, resume "
        f"median {ck['resume_ms_median']:.2f} ms over {ck['resumes']}, a "
        f"checkpoint {ck['bytes']} B")
    log(f"  killed in process after block {ip['kill_at']}, resumed in a "
        f"fresh model, optimizer and TrainLoop: keys, seeds, sampled ids "
        f"and cursors equal; losses bit-identical: "
        f"{ip['losses_bit_identical']}, max abs diff "
        f"{ip['loss_max_abs_diff']:.3e} (rel {ip['loss_max_rel_diff']:.3e}"
        f"); params max abs diff {ip['param_max_abs_diff']:.3e}; two runs "
        f"without a kill: losses {ip['run_to_run_loss_max_abs_diff']:.3e}, "
        f"params {ip['run_to_run_param_max_abs_diff']:.3e} apart")
    g = ip["param_rel_gap"]
    log(f"  restored state == the killed run's at its kill (params, Adam's "
        f"moments and step); params L2 from the run without a kill, over "
        f"the {ip['param_moved_l2']:.4e} training moved them: resumed "
        f"{g['resumed']:.3e}, a second run {g['run_to_run']:.3e}, gate "
        f"{ip['param_gate']:.3e}; planted fault (resume without Adam's "
        f"state): {ip['fault_state_mismatch']} state mismatches, params "
        f"{g['fault']:.3e}, losses {ip['fault_loss_max_abs_diff']:.3e} "
        f"apart")
    cap = co["captures"]
    log(f"  captures: epoch 1 {cap['per_epoch']['epoch1']}, epoch 2 "
        f"{cap['per_epoch']['epoch2']}; after the resume "
        f"{cap['after_resume']} (scanned_node_step); all {cap['all']}")
    log(f"  SIGKILL: {sk['nodes']}-node graph at the same widths, "
        f"{sk['blocks_per_epoch']} blocks an epoch, killed after block "
        f"{sk['kill_at']}, resumed in a new process: losses bit-identical: "
        f"{sk['losses_bit_identical']}, params bit-identical: "
        f"{sk['params_bit_identical']}, max abs diff "
        f"{sk['loss_max_abs_diff']:.3e} (rel {sk['loss_max_rel_diff']:.3e})"
        f"; workers " + ", ".join(f"{k} {v:.1f} s"
                                  for k, v in sk["worker_s"].items()))
    log(f"  refresh: {rf['nodes']} nodes x {rf['layers']} layers x "
        f"{rf['num_sweeps']} sweeps from int8 (B4), killed after one "
        f"sweep and resumed: rows max abs diff {rf['rows_max_abs_diff']:.3e}"
        f" (rel {rf['rows_rel_diff']:.3e}); a second straight refresh "
        f"{rf['control_max_abs_diff']:.3e} apart; straight "
        f"{rf['straight_s']:.1f} s, resumed {rf['resumed_s']:.1f} s")
    for layer, e in enumerate(rf["per_layer"]):
        log(f"    layer {layer}: " + "; ".join(
            f"{run} max abs {v['max_abs_diff']:.3e}, {v['rows_differ']} rows"
            f" in {v['n_sweeps_differ']} sweeps {v['sweeps_differ']}"
            for run, v in e.items()))
    dv = co["device"]
    log(f"  device gauges: " + ", ".join(
        f"{k}={v:.0f}" for k, v in sorted(dv["gauges"].items())))
    log(f"  owners: " + ", ".join(
        f"{k} {v['bytes']} B" for k, v in sorted(dv["owners"].items()))
        + f"; total {dv['total']['bytes']} B (memory_allocated "
        f"{dv['memory_allocated']} B; the sum holds by construction); "
        f"params >= the {dv['live_params']} B of three live models; a "
        f"{PROBE_BYTES} B probe claimed while alive, released after, "
        f"'other' moved {dv['probe_other_drift']} B")
    rl = co["roofline"]
    log(f"  memcpy roofline: {rl['memcpy_gb_s']:.1f} GB/s over "
        f"{rl['bytes']:.0f} B x {rl['iters']:.0f} passes; datasheet "
        f"{rl['datasheet']['gb_s']:.0f} GB/s ({rl['datasheet']['source']}):"
        f" {rl['memcpy_gb_s'] / rl['datasheet']['gb_s']:.1%}")
    log("  span summary:")
    for line in co["span_summary"]:
        log("    " + line)
    pc = co["profiler_capture"]
    log(f"  triggered torch.profiler capture: {pc['dir']}; flight index "
        f"{json.dumps(pc['flight_index'])}")
    oo = co["obs_overhead"]
    log(f"  replayed node step, host clock: tracing and metrics on "
        f"{oo['step_ms_on']:.3f} ms, off {oo['step_ms_off']:.3f} ms "
        f"(medians of {oo['blocks_timed']['on']} and "
        f"{oo['blocks_timed']['off']} blocks, in turns); launches "
        f"{co['launches']} ({wall_s:.1f} s)")


# -- phase 11: partition and train across a mesh of shards -----------------
def dist_batch(torch, ds, seeds, key, **kw):
    """The data half of one distributed step on ``ds``'s device
    (``sample_and_gather``): per shard ``(out, x, y)``."""
    from glt_tpu_torch.parallel.dist_train import sample_and_gather

    dev = ds.graph.indptr.device
    _, outs, xy = sample_and_gather(
        ds.graph, ds.feature, ds.labels,
        torch.from_numpy(np.asarray(seeds, np.int32)).to(dev), key,
        DIST_FANOUT, **kw)
    return [(o, x, y) for o, (x, y) in zip(outs, xy)]


def same_batches(torch, a, b, what: str) -> None:
    """Two per-shard batches ``torch.equal`` field by field."""
    for s, ((oa, xa, ya), (ob, xb, yb)) in enumerate(zip(a, b)):
        for f in ("node", "row", "col", "edge", "node_mask", "edge_mask",
                  "num_sampled_nodes", "num_sampled_edges"):
            need(torch.equal(getattr(oa, f).cpu(), getattr(ob, f).cpu()),
                 f"{what}: shard {s} {f} differs")
        need(torch.equal(xa.cpu(), xb.cpu()), f"{what}: shard {s} x differs")
        need(torch.equal(ya.cpu(), yb.cpu()), f"{what}: shard {s} y differs")


def check_dist_dataset(torch, ds, topo, papers, rng) -> int:
    """CHECK_ROWS relabelled rows of the loaded shards against the host
    arrays: each row's neighbors (relabelled, in CSR order) and edge ids,
    its feature row and its label.  Returns the edges checked."""
    rel = ds.relabel
    c = rel.nodes_per_shard
    live = np.flatnonzero(rel.new2old >= 0)
    new = np.sort(rng.choice(live, min(CHECK_ROWS, live.size),
                             replace=False))
    old = rel.new2old[new]
    shard, row = new // c, new % c
    ip = ds.graph.indptr.cpu().numpy().astype(np.int64)
    start, end = ip[shard, row], ip[shard, row + 1]
    ostart = topo.indptr[old]
    lens = end - start
    need((lens == topo.indptr[old + 1] - ostart).all(),
         "a loaded shard row has the wrong degree")
    width = ds.graph.indices.shape[1]
    within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.repeat(shard * width + start, lens) + within
    opos = np.repeat(ostart, lens) + within
    flat = torch.from_numpy(pos).to(ds.graph.indices.device)
    got_ix = ds.graph.indices.reshape(-1)[flat].cpu().numpy()
    got_ei = ds.graph.edge_ids.reshape(-1)[flat].cpu().numpy()
    need(np.array_equal(got_ix, rel.old2new[topo.indices[opos]]),
         "a loaded shard row's neighbors differ from the relabelled CSR")
    need(np.array_equal(got_ei, topo.edge_ids[opos]),
         "a loaded shard row's edge ids differ")
    idx = torch.from_numpy(new).to(ds.feature.rows.device)
    rows = ds.feature.rows.reshape(-1, ds.feature.rows.shape[-1])[idx]
    need(torch.equal(rows.cpu(), torch.from_numpy(papers.feat[old])),
         "a loaded feature row differs")
    need(np.array_equal(ds.labels.reshape(-1)[idx].cpu().numpy(),
                        papers.labels[old]), "a loaded label differs")
    return int(lens.sum())


def served_requests(torch, ds, frontiers):
    """Per shard, the local rows of the requests that landed on it after
    the all-to-all of ``frontiers`` (one id vector a shard; -1 where a
    slot carries no id of that shard)."""
    from glt_tpu_torch.parallel.dist_sampler import _all_to_all, build_routing

    g = ds.graph
    c, s_count = g.nodes_per_shard, g.num_shards
    req = _all_to_all([build_routing(f, c, s_count).buckets
                       for f in frontiers])
    out = []
    for s, r in enumerate(req):
        local = r - s * c
        ok = (r >= 0) & (local >= 0) & (local < c)
        out.append(torch.where(ok, local, -1).to(torch.int32).contiguous())
    return out


def time_dist_kernels(torch, ops, trandom, ds, batch, sm_mhz):
    """B1 at the widest served request block (shard 0's hop-1 requests,
    ``[S * 1536, 10]``, real edge ids) and B3 at shard 0's served feature
    requests (``[S * node capacity, 128]`` f32), against their bounds."""
    g = ds.graph
    w1 = DIST_BS * DIST_FANOUT[0]
    hop1 = []
    for out, _, _ in batch:
        c0 = int(out.num_sampled_nodes[0])
        hop1.append(torch.cat([out.node, torch.full(
            (w1,), -1, dtype=torch.int32, device=out.node.device)])
            [c0: c0 + w1])
    lid = served_requests(torch, ds, hop1)[0]
    f = DIST_FANOUT[1]
    key = trandom.PRNGKey(1, device=lid.device)

    def b1(fn=ops.sample_neighbors_cuda):
        return fn(g.indptr[0], g.indices[0], lid, f, key,
                  edge_ids=g.edge_ids[0])

    want = b1(ops.sample_neighbors_plain)
    got = b1()
    need(all(torch.equal(a, b) for a, b in zip(got, want)),
         "B1 differs from its plain version at phase 11's shape")
    nbytes, nops = b1_work(g.indptr[0], lid, f, want.mask)
    nbytes += int(want.mask.sum()) * 4          # the edge-id read
    bound, by = bound_of(nbytes, nops, sm_mhz)
    row_b1 = {"shape": [int(lid.shape[0]), f], "ms": cuda_ms(torch, b1),
              "plain_ms": cuda_ms(torch, lambda: b1(
                  ops.sample_neighbors_plain), reps=5, rounds=3),
              "bound_ms": bound, "bound_by": by, "bytes": nbytes,
              "int_ops": nops, "library_ms": None,
              "live_rows": int((lid >= 0).sum())}
    ids = served_requests(torch, ds, [o.node for o, _, _ in batch])[0]
    table = ds.feature.rows[0]
    _, inv, uidx = ops.frontier_plan(ids)
    need(torch.equal(ops.fused_frontier_cuda(table, uidx, inv),
                     ops.fused_frontier_plain(table, uidx, inv)),
         "B3 differs from its plain version at phase 11's shape")
    row_b3 = time_fused_kernel(torch, ops, table, ids)
    row_b3["bound_by"] = "bytes"
    return row_b1, row_b3


def run_dist(torch, ops, trandom, dev, sm_mhz, part_dir: str,
             keep: dict) -> dict:
    """Phase 11 (see the module docstring).  Partitions into
    ``part_dir`` (the caller deletes it) and leaves in ``keep`` what
    phase 13 reuses: the papers graph, the card's and the CPU's loads at
    hot ratio 1.0 and the seed batches."""
    import traceback
    import warnings

    from glt_tpu_torch.data import CSRTopo, Graph
    from glt_tpu_torch.examples import dist_train_papers100m as twin
    from glt_tpu_torch.parallel import Mesh, make_dist_train_step
    from glt_tpu_torch.sampler import NeighborSampler

    rep = {}
    cpu = torch.device("cpu")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    papers = twin.synthetic_papers(DIST_SCALE, DIST_SHARDS, DIST_BS,
                                   DIST_DIM, DIST_CLASSES)
    topo = CSRTopo(papers.edge_index, num_nodes=papers.n)
    rep.update(nodes=papers.n, edges=int(papers.edge_index.shape[1]),
               train_ids=int(papers.train_idx.size),
               build_s=time.perf_counter() - t0)

    # sample_prob of every rank on the card; rank 0 against the CPU.
    t0 = time.perf_counter()
    probs = twin.rank_probs(Graph(topo, device=dev), papers.train_idx,
                            DIST_SHARDS, DIST_FANOUT, DIST_BS)
    host_probs = [p.cpu().numpy() for p in probs]
    rep["sample_prob_s"] = time.perf_counter() - t0
    rank0 = np.array_split(papers.train_idx, DIST_SHARDS)[0]
    want = NeighborSampler(Graph(topo, device=cpu), DIST_FANOUT,
                           batch_size=DIST_BS).sample_prob(rank0, papers.n)
    rep["sample_prob_max_abs_err"] = float(np.abs(
        host_probs[0] - want.numpy()).max())
    need(rep["sample_prob_max_abs_err"] <= 1e-6,
         f"sample_prob on the card differs from the CPU's by "
         f"{rep['sample_prob_max_abs_err']:.3e}")

    rep["partition_s"] = twin.partition(papers, part_dir, DIST_SHARDS,
                                        host_probs)
    t0 = time.perf_counter()
    ds = twin.load(part_dir, papers.labels, 1.0, dev)
    torch.cuda.synchronize()
    rep["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds_cpu = twin.load(part_dir, papers.labels, 1.0, cpu)
    rep["cpu_load_s"] = time.perf_counter() - t0
    rep["nodes_per_shard"] = ds.relabel.nodes_per_shard
    rep["edge_width"] = int(ds.graph.indices.shape[1])
    rep["checked_edges"] = check_dist_dataset(torch, ds, topo, papers,
                                              np.random.default_rng(11))
    del topo

    mesh = Mesh([dev] * DIST_SHARDS)
    batches = ds.split_seeds(papers.train_idx, DIST_BS, shuffle=True,
                             rng=np.random.default_rng(0))
    need(batches.shape[0] >= DIST_STEPS + 4, "too few seed batches")
    step = make_dist_train_step(ds.graph, ds.feature, ds.labels, mesh,
                                DIST_FANOUT, DIST_BS, fused_frontier=True)
    rep["collective_bytes"] = step.collective_bytes
    state = twin.make_state(ds, DIST_FANOUT, DIST_BS, DIST_CLASSES, dev)
    key = trandom.PRNGKey(0, device=dev)

    # The main path: DIST_STEPS steps, counts set to 0 just before.
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    losses, step_ms = [], []
    for b in range(DIST_STEPS):
        t0 = time.perf_counter()
        state, loss, _ = step(state, batches[b], trandom.fold_in(key, b))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    rep["plain_hash_calls"] = trandom.threefry2x32.calls
    rep["main_launches"] = dict(launches)
    losses = torch.stack(losses).cpu().numpy()
    rep["losses"] = losses.tolist()
    rep["step_ms"] = step_ms
    rep["step_ms_median"] = statistics.median(step_ms[3:])
    rep["subgraphs_per_s"] = DIST_SHARDS / rep["step_ms_median"] * 1e3
    need(np.isfinite(losses).all(), "a distributed loss is not finite")
    need(losses[-5:].mean() < losses[:5].mean(),
         f"the distributed loss did not fall: {losses[:5].mean():.4f} -> "
         f"{losses[-5:].mean():.4f}")
    hops = len(DIST_FANOUT)
    need(launches["sample_neighbors_cuda"] == DIST_SHARDS * hops * DIST_STEPS,
         f"B1 ran {launches['sample_neighbors_cuda']} times in "
         f"{DIST_STEPS} steps, not {DIST_SHARDS * hops} a step")
    need(launches["fused_frontier_cuda"] == DIST_SHARDS * DIST_STEPS,
         f"B3 ran {launches['fused_frontier_cuda']} times in {DIST_STEPS} "
         f"steps, not {DIST_SHARDS} a step")
    need(launches["threefry_hash_cuda"] > 0, "phase 11 never launched the "
                                             "hash kernel")
    need(rep["plain_hash_calls"] == 0,
         "phase 11 ran the plain threefry arithmetic on the card")

    # Against the CPU: step 0's batch and loss from the same weights.
    k0, k0_cpu = trandom.fold_in(key, 0), trandom.fold_in(
        trandom.PRNGKey(0, device=cpu), 0)
    card0 = dist_batch(torch, ds, batches[0], k0, fused_frontier=True)
    same_batches(torch, card0, dist_batch(torch, ds_cpu, batches[0], k0_cpu),
                 "step 0's batch, card vs CPU")
    cpu_step = make_dist_train_step(
        ds_cpu.graph, ds_cpu.feature, ds_cpu.labels,
        Mesh([cpu] * DIST_SHARDS), DIST_FANOUT, DIST_BS)
    cpu_state = twin.make_state(ds_cpu, DIST_FANOUT, DIST_BS, DIST_CLASSES,
                                cpu)
    _, cpu_loss, _ = cpu_step(cpu_state, batches[0], k0_cpu)
    rep["card_loss"], rep["cpu_loss"] = float(losses[0]), float(cpu_loss)
    rep["cpu_loss_rel_err"] = abs(rep["card_loss"] - rep["cpu_loss"]) / max(
        abs(rep["cpu_loss"]), 1e-12)
    need(rep["cpu_loss_rel_err"] <= F32_LOSS_RTOL,
         f"step 0's loss on the card {rep['card_loss']} vs CPU "
         f"{rep['cpu_loss']}")

    # Variants, each equal to its counterpart.
    same_batches(torch, dist_batch(torch, ds, batches[0], k0, route="sort"),
                 dist_batch(torch, ds, batches[0], k0, route="onepass"),
                 "route sort vs onepass")
    same_batches(torch, card0, dist_batch(torch, ds, batches[0], k0),
                 "B3 vs the plain take")
    same_batches(torch, card0, dist_batch(torch, ds, batches[0], k0,
                                          dedup_gather=True,
                                          fused_frontier=True),
                 "dedup_gather vs not")
    capped = dist_batch(torch, ds, batches[0], k0, fused_frontier=True,
                        exchange_load_factor=DIST_LOAD_FACTOR)
    same_batches(torch, capped, dist_batch(
        torch, ds_cpu, batches[0], k0_cpu,
        exchange_load_factor=DIST_LOAD_FACTOR), "capped, card vs CPU")
    rep["capped_dropped"] = [int(o.metadata["exchange_dropped"])
                             for o, _, _ in capped]
    del cpu_step, cpu_state

    # The capped step: B1 twice a hop a shard.
    cstep = make_dist_train_step(ds.graph, ds.feature, ds.labels, mesh,
                                 DIST_FANOUT, DIST_BS, fused_frontier=True,
                                 exchange_load_factor=DIST_LOAD_FACTOR)
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    for b in range(DIST_STEPS, DIST_STEPS + 2):
        state, loss, _ = cstep(state, batches[b], trandom.fold_in(key, b))
    torch.cuda.synchronize()
    capped_launches = {k: fn.launches
                       for k, fn in kernel_wrappers(ops).items()}
    need(capped_launches["sample_neighbors_cuda"]
         == 2 * DIST_SHARDS * hops * 2,
         f"B1 ran {capped_launches['sample_neighbors_cuda']} times in 2 "
         f"capped steps, not {2 * DIST_SHARDS * hops} a step")
    rep["capped_launches"] = capped_launches
    rep["launches"] = {k: v + capped_launches[k]
                       for k, v in launches.items()}

    # Host syncs of a warm step, each by its innermost frames (only
    # those inside the step: switching the mode back warns as well).
    torch.cuda.synchronize()
    rep["syncs"] = []
    in_step = [False]

    def on_warning(message, category, filename, lineno, *rest):
        if in_step[0] and "synchroniz" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            rep["syncs"].append(" < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in frames[-4:][::-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_step[0] = True
            state, loss, _ = step(state, batches[DIST_STEPS + 2],
                                  trandom.fold_in(key, DIST_STEPS + 2))
            in_step[0] = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    # One profiled step.
    with profile_window(torch) as prof:
        t0 = time.perf_counter()
        state, loss, _ = step(state, batches[DIST_STEPS + 3],
                              trandom.fold_in(key, DIST_STEPS + 3))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rep["profile"] = device_profile(torch, prof, 1, wall)
    rep["profile"]["b1_kernels"] = b1_kernels(torch, prof)

    # The scanned step, its blocks captured into CUDA graphs.
    rep["scanned"] = sc = run_scanned_dist(torch, ops, trandom, ds, ds_cpu,
                                           mesh, state, batches)
    keep.update(papers=papers, ds=ds, ds_cpu=ds_cpu, batches=batches)
    rep["launches"] = {k: v + sc["launches"][k]
                       for k, v in rep["launches"].items()}
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    rep["kernels"] = dict(zip(("B1", "B3"), time_dist_kernels(
        torch, ops, trandom, ds, card0, sm_mhz)))
    return rep


def run_scanned_dist(torch, ops, trandom, ds, ds_cpu, mesh, state,
                     batches) -> dict:
    """Phase 11's scanned step at the eager step's settings, G = GROUP
    slots a block (see the module docstring)."""
    from glt_tpu_torch.examples import dist_train_papers100m as twin
    from glt_tpu_torch.models import adam
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import Mesh, make_scanned_dist_train_step

    dev, cpu = mesh.device, torch.device("cpu")
    hops, G, S = len(DIST_FANOUT), GROUP, DIST_SHARDS

    def make_step():
        return make_scanned_dist_train_step(
            ds.graph, ds.feature, ds.labels, mesh, DIST_FANOUT, DIST_BS,
            fused_frontier=True)

    def make_model():
        return twin.make_state(ds, DIST_FANOUT, DIST_BS, DIST_CLASSES,
                               dev).model

    # Seed batches the eager steps did not train on, G to a block.
    lo = DIST_STEPS + 4
    blocks = [batches[lo + i * G: lo + (i + 1) * G]
              for i in range(DIST_SCAN_BLOCKS + 1)]
    need(all(b.shape[0] == G and (b >= 0).any(axis=(1, 2)).all()
             for b in blocks), "too few seed batches for the scanned blocks")
    # The first block's slot 0 on the CPU, from the same weights.
    cpu_state = twin.make_state(ds_cpu, DIST_FANOUT, DIST_BS, DIST_CLASSES,
                                cpu)
    cpu_state.model.load_state_dict(state.model.state_dict())
    step = make_step()
    base = trandom.PRNGKey(200, device=dev)

    # The main path: counts set to 0 just before, read just after.
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    captures0 = compilewatch.counts("scanned_dist_step")
    torch.cuda.synchronize()
    block_ms, losses, eager = [], [], None
    for i, blk in enumerate(blocks[:DIST_SCAN_BLOCKS]):
        t0 = time.perf_counter()
        state, ls, _ = step(state, blk, trandom.fold_in(base, i))
        torch.cuda.synchronize()
        block_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(ls)
        if i == 0:
            eager = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    rep = {"plain_hash_calls": trandom.threefry2x32.calls,
           "captures": compilewatch.counts("scanned_dist_step") - captures0,
           "eager_block_launches": eager, "launches": launches,
           "block_ms": block_ms}
    need(rep["plain_hash_calls"] == 0,
         "the scanned step ran the plain threefry arithmetic on the card")
    need(rep["captures"] == 1, f"{rep['captures']} captures of the scanned "
                               f"step, not 1")
    need(eager["sample_neighbors_cuda"] == S * hops * G,
         f"B1 ran {eager['sample_neighbors_cuda']} times in an eager block "
         f"of {G} slots, not {S * hops} a slot")
    need(eager["fused_frontier_cuda"] == S * G,
         f"B3 ran {eager['fused_frontier_cuda']} times in an eager block of "
         f"{G} slots, not {S} a slot")
    # The capture records each launch once; a replay moves no counter.
    for k in ("sample_neighbors_cuda", "fused_frontier_cuda"):
        need(launches[k] == 2 * eager[k], f"{k}: {launches[k]} launches in "
             f"an eager block, its capture and replays, not {2 * eager[k]}")
    losses = torch.cat(losses).cpu().numpy()
    need(losses.shape == (DIST_SCAN_BLOCKS * G,)
         and bool(np.isfinite(losses).all()),
         f"scanned losses: {losses}")
    rep["losses"] = losses.tolist()
    rep["step_ms_median"] = statistics.median(block_ms[2:]) / G
    rep["subgraphs_per_s"] = S / rep["step_ms_median"] * 1e3

    one = np.full_like(blocks[0], -1)
    one[0] = blocks[0][0]
    cpu_step = make_scanned_dist_train_step(
        ds_cpu.graph, ds_cpu.feature, ds_cpu.labels, Mesh([cpu] * S),
        DIST_FANOUT, DIST_BS)
    _, cpu_ls, _ = cpu_step(cpu_state, one, trandom.fold_in(
        trandom.PRNGKey(200, device=cpu), 0))
    rep["cpu_slot_loss"], rep["card_slot_loss"] = (float(cpu_ls[0]),
                                                   float(losses[0]))
    rep["cpu_slot_rel_err"] = abs(rep["card_slot_loss"] - rep[
        "cpu_slot_loss"]) / max(abs(rep["cpu_slot_loss"]), 1e-30)
    need(rep["cpu_slot_rel_err"] <= F32_LOSS_RTOL,
         f"the first block's slot 0: card {rep['card_slot_loss']} vs CPU "
         f"{rep['cpu_slot_loss']}")
    del cpu_state, cpu_step

    # One block replayed and the same block eager from a copy of the
    # state (a fresh step's first call), both profiled.
    copy = copy_state(state, make_model, adam(LR))
    blk, key = blocks[-1], trandom.PRNGKey(201, device=dev)
    outs = {}
    for route, run in (("replayed", step), ("eager", make_step())):
        with profile_window(torch) as prof:
            t0 = time.perf_counter()
            if route == "replayed":
                state, ls, _ = run(state, blk, key)
            else:
                copy, ls, _ = run(copy, blk, key)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / G
        p = device_profile(torch, prof, G, wall)
        p["b1_kernels"] = b1_kernels(torch, prof) / G
        rep[f"{route}_profile"] = p
        outs[route] = ls.double().cpu()
    need(rep["replayed_profile"]["b1_kernels"] == S * hops,
         f"B1 ran {rep['replayed_profile']['b1_kernels']} times a replayed "
         f"step, not {S * hops}")
    rel = ((outs["replayed"] - outs["eager"]).abs()
           / outs["eager"].abs().clamp(min=1e-30)).tolist()
    need(max(rel) <= F32_LOSS_RTOL,
         f"replayed block's losses {outs['replayed'].tolist()} vs eager "
         f"{outs['eager'].tolist()}")
    rep["replay_vs_eager_rel"] = rel
    return rep


def log_dist(rep: dict, card: str) -> None:
    """Phase 11's lines (each number measured on ``card``)."""
    p, cb = rep["profile"], rep["collective_bytes"]
    log(f"dist: [{card}] {rep['nodes']} nodes, {rep['edges']} edges built "
        f"in {rep['build_s']:.1f} s; sample_prob of {DIST_SHARDS} ranks on "
        f"the card {rep['sample_prob_s']:.2f} s (rank 0 vs CPU max abs "
        f"{rep['sample_prob_max_abs_err']:.2e}); FrequencyPartitioner "
        f"{rep['partition_s']:.1f} s; DistDataset.load {rep['load_s']:.1f} s "
        f"(CPU {rep['cpu_load_s']:.1f} s): {DIST_SHARDS} shards x "
        f"{rep['nodes_per_shard']} nodes, edge width {rep['edge_width']}, "
        f"{CHECK_ROWS} rows ({rep['checked_edges']} edges) equal to the "
        f"relabelled host arrays")
    log(f"  {DIST_STEPS} steps (fused_frontier): losses "
        f"{rep['losses'][0]:.4f} -> {rep['losses'][-1]:.4f}; warm step "
        f"median {rep['step_ms_median']:.2f} ms "
        f"({rep['subgraphs_per_s']:.1f} subgraphs/s); launches "
        f"{rep['main_launches']}; plain threefry on the card "
        f"{rep['plain_hash_calls']}; peak memory "
        f"{rep['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  step 0 card vs CPU: batch equal, loss {rep['card_loss']:.6f} vs "
        f"{rep['cpu_loss']:.6f} (rel {rep['cpu_loss_rel_err']:.2e}); sort == "
        f"onepass, B3 == plain take, dedup_gather == not, capped (load "
        f"factor {DIST_LOAD_FACTOR}) == its CPU run, exchange_dropped "
        f"{rep['capped_dropped']}; capped step launches "
        f"{rep['capped_launches']}")
    log(f"  profiled step: wall {p['wall_ms']:.2f} ms, {p['kernels']:.0f} "
        f"kernels {p['kernels_ms']:.3f} ms ({p['kernel_share']:.1%}), B1 "
        f"{p['b1_kernels']}, {p['copies']:.0f} copies {p['copies_ms']:.3f} "
        f"ms, {p['memsets']:.0f} memsets {p['memsets_ms']:.3f} ms, "
        f"{p['launch_calls']:.0f} host launch calls; collective bytes "
        f"{cb['ici']} (ici) {cb['dcn']} (dcn) a step; syncs in a warm step "
        f"{len(rep['syncs'])}")
    for where in rep["syncs"][:8]:
        log(f"    sync at {where}")
    for k in p["top_kernels"][:5]:
        log(f"    {k['count']:.0f} x {k['name']}: {k['ms']:.3f} ms")
    sc = rep["scanned"]
    log(f"  scanned step [{card}]: {DIST_SCAN_BLOCKS} blocks of {GROUP} "
        f"slots (eager, captured, replays) in " + ", ".join(
            f"{b:.1f}" for b in sc["block_ms"]) + f" ms; replayed step "
        f"median {sc['step_ms_median']:.2f} ms "
        f"({sc['subgraphs_per_s']:.1f} subgraphs/s) against the eager "
        f"step's {rep['step_ms_median']:.2f} ms "
        f"({rep['subgraphs_per_s']:.1f} subgraphs/s); losses "
        f"{sc['losses'][0]:.4f} -> {sc['losses'][-1]:.4f}; eager block "
        f"B1 {sc['eager_block_launches']['sample_neighbors_cuda']}, B3 "
        f"{sc['eager_block_launches']['fused_frontier_cuda']} "
        f"({GROUP} slots); captures {sc['captures']}; slot 0 card vs CPU "
        f"{sc['card_slot_loss']:.6f} vs {sc['cpu_slot_loss']:.6f} (rel "
        f"{sc['cpu_slot_rel_err']:.2e}); replayed vs eager block rel max "
        f"{max(sc['replay_vs_eager_rel']):.2e}")
    for route in ("replayed", "eager"):
        p = sc[f"{route}_profile"]
        log(f"  profiled {route} scanned step: wall {p['wall_ms']:.2f} ms, "
            f"{p['launch_calls']:.2f} host launch calls, {p['kernels']:.1f} "
            f"kernels {p['kernels_ms']:.3f} ms ({p['kernel_share']:.1%}), "
            f"B1 {p['b1_kernels']:.0f}, {p['copies']:.1f} copies, "
            f"{p['memsets']:.1f} memsets")
    for name, k in rep["kernels"].items():
        lib = ("" if k["library_ms"] is None
               else f", library {k['library_ms']:.4f} ms")
        log(f"  {name} {k['shape']}: kernel {k['ms']:.5f} ms, plain "
            f"{k['plain_ms']:.4f} ms{lib}, bound {k['bound_ms']:.5f} ms by "
            f"{k['bound_by']}")


# -- phase 13: features that outgrow the card --------------------------------
STAGE_FIELDS = ("node", "row", "col", "edge", "batch", "node_mask",
                "edge_mask", "num_sampled_nodes", "num_sampled_edges",
                "slots", "ids", "dropped")


def sharded_is_edge(ip, ix, c: int, s: int, d: int) -> bool:
    """Whether ``(s, d)`` (relabelled ids) is an edge of the sharded CSR
    ``ip [S, c + 1]``, ``ix [S, E]`` (host arrays)."""
    sh, r = divmod(int(s), c)
    return bool((ix[sh, ip[sh, r]:ip[sh, r + 1]] == d).any())


def shard_edges(ip, ix, c: int, n: int, rng):
    """``[S, n]`` seed edges, every shard's from its own CSR block, the
    last 4 slots padding."""
    S = ip.shape[0]
    src = np.full((S, n), -1, np.int32)
    dst = np.full((S, n), -1, np.int32)
    for s in range(S):
        e = rng.choice(int(ip[s, -1]), n - 4, replace=False)
        src[s, : n - 4] = s * c + np.searchsorted(ip[s], e, side="right") - 1
        dst[s, : n - 4] = ix[s, e]
    return src, dst


def b3_kernels(torch, prof) -> int:
    """Device executions of kernel B3 (``fused_frontier_kernel``) in a
    profiled window, by name."""
    return sum(1 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and re.search(r"(^|[^A-Za-z_])fused_frontier_kernel",
                             ev.name))


def tiered_pipeline(ds, feature, mesh, cold_cap=None, cold_store=None):
    """The twin's tiered pipeline over ``ds``'s graph and labels at
    phase 11's settings (B3 serving the hot rows on the card)."""
    from glt_tpu_torch.parallel import (DistNeighborSampler,
                                        TieredTrainPipeline,
                                        make_tiered_train_step)

    sampler = DistNeighborSampler(ds.graph, mesh, num_neighbors=DIST_FANOUT,
                                  batch_size=DIST_BS)
    train = make_tiered_train_step(ds.graph, feature, ds.labels, mesh,
                                   DIST_BS,
                                   fused_frontier=mesh.device.type == "cuda")
    return TieredTrainPipeline(sampler, train, feature, mesh,
                               cold_cap=cold_cap, cold_store=cold_store)


def staged(torch, pipe, seeds, key):
    """One batch's stage 1 and cold staging through ``pipe``: ``(out,
    rows, slots)``, the rows on the mesh's device."""
    out, fut = pipe._sample_and_stage(seeds, key)
    rows, slots, copied, _ = fut.result()
    if copied is not None:
        torch.cuda.current_stream().wait_event(copied)
    return out, rows, slots


def run_tiered(torch, ops, trandom, dev, sm_mhz, keep: dict,
               part_dir: str) -> dict:
    """Phase 13 (see the module docstring)."""
    import threading
    import traceback
    import warnings

    from glt_tpu_torch.data import CSRTopo, Graph
    from glt_tpu_torch.examples import dist_train_papers100m as twin
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import (DistNeighborSampler, Mesh,
                                        TieredShardedFeature,
                                        exchange_gather_xy)
    from glt_tpu_torch.parallel.dist_sampler import seeds_on_mesh
    from glt_tpu_torch.sampler import NegativeSampling, SamplerOutput
    from glt_tpu_torch.store import (DiskColdStore, DiskFeatureStore,
                                     write_feature_store)

    rep = {}
    cpu = torch.device("cpu")
    S, hops = DIST_SHARDS, len(DIST_FANOUT)
    papers, ds_cpu, batches = keep["papers"], keep["ds_cpu"], keep["batches"]
    need(batches.shape[0] >= TIERED_STEPS + 12, "too few seed batches")

    # The tiered load on the card, the entry point a user calls.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = twin.load(part_dir, papers.labels, TIERED_RATIO, dev)
    torch.cuda.synchronize()
    rep["load_s"] = time.perf_counter() - t0
    f = ds.feature
    need(isinstance(f, TieredShardedFeature), "hot_ratio 0.25 loaded no "
                                              "TieredShardedFeature")
    c, h = f.nodes_per_shard, f.hot_per_shard
    rows = ds_cpu.feature.rows
    need(torch.equal(f.hot.cpu(), rows[:, :h])
         and np.array_equal(f.cold, rows[:, h:].numpy()),
         "the tiered load's rows differ from the whole load's")
    rep.update(nodes_per_shard=c, hot_per_shard=h,
               hot_bytes=f.hot.numel() * f.hot.element_size(),
               cold_bytes=int(f.cold.nbytes))
    # The CPU's tiered feature: the whole CPU load's rows, split.
    f_cpu = TieredShardedFeature(hot=rows[:, :h].contiguous(),
                                 cold=rows[:, h:].numpy(), nodes_per_shard=c,
                                 hot_per_shard=h, num_shards=S)
    mesh, cmesh = Mesh([dev] * S), Mesh([cpu] * S)
    key, ckey = (trandom.PRNGKey(300, device=d) for d in (dev, cpu))

    def sample_key(k, i):
        return trandom.fold_in(trandom.fold_in(k, i), 1)

    # Step 0 against the CPU and the whole table: its stage's outputs,
    # its tiered gather (== phase 11's hot_ratio-1.0 gather), a small
    # cold_cap's drops.  A probe pipeline, so the main path's counts and
    # captures start clean.
    probe = tiered_pipeline(ds, f, mesh)
    cprobe = tiered_pipeline(ds_cpu, f_cpu, cmesh)
    b0 = batches[0]
    got = probe._stage_prog(seeds_on_mesh(b0, mesh), sample_key(key, 0))
    want = cprobe._stage_prog(seeds_on_mesh(b0, cmesh), sample_key(ckey, 0))
    for name, a, b in zip(STAGE_FIELDS, got, want):
        need(torch.equal(a.cpu(), b), f"step 0's {name}, card vs CPU")
    rep["step0_cold_requests"] = int((got[10] >= 0).sum())
    out, srows, slots = staged(torch, probe, b0, sample_key(key, 0))
    full = keep["ds"]
    tiered_xy = exchange_gather_xy(list(out.node), f.hot, ds.labels, c, S,
                                   hot_per_shard=h, staged_rows=srows,
                                   staged_slots=slots, fused_frontier=True)
    full_xy = exchange_gather_xy(list(out.node), full.feature.rows,
                                 full.labels, c, S)
    for s, ((xt, yt), (xf, yf)) in enumerate(zip(tiered_xy, full_xy)):
        need(torch.equal(xt, xf) and torch.equal(yt, yf),
             f"step 0's tiered gather differs from the whole gather on "
             f"shard {s}")
    served = served_requests(torch, ds, list(out.node))[0]
    hot_ids = torch.where(served < h, served, -1).contiguous()
    _, inv, uidx = ops.frontier_plan(hot_ids)
    need(torch.equal(ops.fused_frontier_cuda(f.hot[0], uidx, inv),
                     ops.fused_frontier_plain(f.hot[0], uidx, inv)),
         "B3 differs from its plain version at phase 13's shape")
    rep["b3"] = time_fused_kernel(torch, ops, f.hot[0], hot_ids)
    rep["b3"]["bound_by"] = "bytes"
    small = [tiered_pipeline(d, ft, m, cold_cap=TIERED_SMALL_CAP)
             for d, ft, m in ((ds, f, mesh), (ds_cpu, f_cpu, cmesh))]
    (so, sr, ss), _ = (staged(torch, small[0], b0, sample_key(key, 0)),
                       staged(torch, small[1], b0, sample_key(ckey, 0)))
    rep["small_cap_dropped"] = [p.flush_dropped() for p in small]
    need(rep["small_cap_dropped"][0] == rep["small_cap_dropped"][1] > 0,
         f"cold_cap {TIERED_SMALL_CAP}: drops card vs CPU "
         f"{rep['small_cap_dropped']}")
    small_xy = exchange_gather_xy(list(so.node), f.hot, ds.labels, c, S,
                                  hot_per_shard=h, staged_rows=sr,
                                  staged_slots=ss, fused_frontier=True)
    zeroed = 0
    for (xs, _), (xf, _) in zip(small_xy, exchange_gather_xy(
            list(so.node), full.feature.rows, full.labels, c, S)):
        differ = (xs != xf).any(1)
        need(bool((xs[differ] == 0).all()), "a dropped cold request was "
                                            "served a nonzero row")
        zeroed += int(differ.sum())
    need(0 < zeroed <= rep["small_cap_dropped"][0],
         f"{zeroed} zero rows for {rep['small_cap_dropped'][0]} drops")
    rep["small_cap_zero_rows"] = zeroed
    for p in small + [probe]:
        p.close()
    del full, full_xy, small_xy, tiered_xy, small, probe, srows, sr
    keep.pop("ds")
    gc.collect()
    torch.cuda.empty_cache()

    # The main path: TIERED_STEPS batches of one epoch, counts set to 0
    # just before and read just after; the host stamps each train call
    # (the pipeline's period once it is full).
    pipe = tiered_pipeline(ds, f, mesh)
    state = twin.make_state(ds, DIST_FANOUT, DIST_BS, DIST_CLASSES, dev)
    rep["cold_cap"] = pipe.cold_cap
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rep["memory_allocated_before"] = torch.cuda.memory_allocated()
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0
    caps0 = [compilewatch.counts(k) for k in ("tiered_stage",
                                               "tiered_train_step")]
    # The main thread's own host time a batch: enqueueing stage 1 and
    # the train step, and waiting for the staging thread's result.
    stamps, host = [], {"stage": [], "wait": [], "train": []}
    train_step = pipe.train_step
    sample_and_stage, train_staged = pipe._sample_and_stage, \
        pipe._train_staged

    def stamped(*args):
        stamps.append(time.perf_counter())
        return train_step(*args)

    class TimedFuture:
        def __init__(self, fut):
            self.fut = fut

        def result(self):
            t1 = time.perf_counter()
            res = self.fut.result()
            host["wait"].append(time.perf_counter() - t1)
            return res

    def timed_stage(*args):
        t1 = time.perf_counter()
        out, fut = sample_and_stage(*args)
        host["stage"].append(time.perf_counter() - t1)
        return out, TimedFuture(fut)

    def timed_train(*args):
        t1 = time.perf_counter()
        res = train_staged(*args)
        host["train"].append(time.perf_counter() - t1)
        return res

    pipe.train_step = stamped
    pipe._sample_and_stage, pipe._train_staged = timed_stage, timed_train
    t0 = time.perf_counter()
    state, losses, _ = pipe.run_epoch(state, list(batches[:TIERED_STEPS]),
                                      key)
    torch.cuda.synchronize()
    rep["epoch_s"] = time.perf_counter() - t0
    pipe.train_step = train_step
    del pipe._sample_and_stage, pipe._train_staged
    rep["main_thread_ms"] = {k: float(np.median(v[4:])) * 1e3
                             for k, v in host.items()}
    launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
    rep["launches"] = launches
    rep["plain_hash_calls"] = trandom.threefry2x32.calls
    rep["captures"] = [compilewatch.counts(k) - c0 for k, c0 in zip(
        ("tiered_stage", "tiered_train_step"), caps0)]
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    rep["losses"] = losses.tolist()
    gaps = np.diff(np.asarray(stamps)) * 1e3
    rep["step_ms"] = gaps.tolist()
    rep["step_ms_median"] = float(np.median(gaps[4:]))
    rep["subgraphs_per_s"] = S / rep["step_ms_median"] * 1e3
    rep["dropped"] = pipe.flush_dropped()
    rep["max_cold_rows"] = pipe.max_cold_rows
    rep["h2d_bytes"] = S * pipe.cold_cap * f.dim * f.cold.itemsize
    need(np.isfinite(losses).all(), "a tiered loss is not finite")
    need(losses[-5:].mean() < losses[:5].mean(),
         f"the tiered loss did not fall: {losses[:5].mean():.4f} -> "
         f"{losses[-5:].mean():.4f}")
    need(rep["dropped"] == 0, f"{rep['dropped']} cold requests past the "
                              f"default cold_cap {pipe.cold_cap}")
    need(rep["captures"] == [1, 1], f"captures of the stage and the train "
                                    f"step: {rep['captures']}, not 1 each")
    # The eager first batch and each graph's capture count; a replay
    # moves no counter.
    need(launches["sample_neighbors_cuda"] == 2 * S * hops,
         f"B1 ran {launches['sample_neighbors_cuda']} times, not {S * hops} "
         f"in the eager batch and {S * hops} in the stage's capture")
    need(launches["fused_frontier_cuda"] == 2 * S,
         f"B3 ran {launches['fused_frontier_cuda']} times, not {S} in the "
         f"eager batch and {S} in the train step's capture")
    need(launches["threefry_hash_cuda"] > 0, "phase 13 never launched the "
                                             "hash kernel")
    need(rep["plain_hash_calls"] == 0,
         "phase 13 ran the plain threefry arithmetic on the card")

    # Step 0's loss on the CPU from the same weights and keys.
    cpipe = tiered_pipeline(ds_cpu, f_cpu, cmesh)
    cstate = twin.make_state(ds_cpu, DIST_FANOUT, DIST_BS, DIST_CLASSES, cpu)
    _, closs, _ = cpipe.run_epoch(cstate, [b0], ckey)
    rep["cpu_loss"], rep["card_loss"] = float(closs[0]), float(losses[0])
    rep["cpu_loss_rel_err"] = abs(rep["card_loss"] - rep["cpu_loss"]) / max(
        abs(rep["cpu_loss"]), 1e-30)
    need(rep["cpu_loss_rel_err"] <= F32_LOSS_RTOL,
         f"step 0's tiered loss on the card {rep['card_loss']} vs CPU "
         f"{rep['cpu_loss']}")
    cpipe.close()
    del cstate

    # Replayed steps: profiled (B1 and B3 by name, graph launches), then
    # one under the sync debug mode (the main thread's syncs only).
    lo = TIERED_STEPS
    key2 = trandom.PRNGKey(301, device=dev)
    with profile_window(torch) as prof:
        t0 = time.perf_counter()
        state, _, _ = pipe.run_epoch(state, list(batches[lo:lo + 3]), key2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
    p = device_profile(torch, prof, 3, wall)
    p["b1_kernels"] = b1_kernels(torch, prof) / 3
    p["b3_kernels"] = b3_kernels(torch, prof) / 3
    p["graph_launches"] = sum(
        n for name, n in runtime_calls(torch, prof).items()
        if "GraphLaunch" in name) / 3
    rep["profile"] = p
    need(p["b1_kernels"] == S * hops, f"B1 ran {p['b1_kernels']} times a "
                                      f"replayed step, not {S * hops}")
    need(p["b3_kernels"] == S, f"B3 ran {p['b3_kernels']} times a replayed "
                               f"step, not {S}")
    need(p["graph_launches"] == 2, f"{p['graph_launches']} graph launches a "
                                   f"replayed step, not 2 (stage, train)")
    rep["syncs"] = []
    main = threading.main_thread()
    in_step = [False]

    def on_warning(message, category, filename, lineno, *rest):
        if (in_step[0] and threading.current_thread() is main
                and "synchroniz" in str(message)):
            frames = [fr for fr in traceback.extract_stack()[:-1]
                      if not fr.filename.endswith("warnings.py")]
            rep["syncs"].append(" < ".join(
                f"{os.path.basename(fr.filename)}:{fr.lineno} {fr.name}"
                for fr in frames[-4:][::-1]))

    key3 = trandom.PRNGKey(302, device=dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_step[0] = True
            state, _, _ = pipe.run_epoch(state, list(batches[lo + 3:lo + 6]),
                                         key3)
            in_step[0] = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    need(not rep["syncs"], f"{len(rep['syncs'])} host syncs on the main "
                           f"thread in warm steps: {rep['syncs'][:3]}")

    # The stage split of one warm batch, each part alone: the main
    # stream's sample+route graph and train graph (device ms), the id
    # fetch and the host->device copy (device ms), the host gather.
    seeds = seeds_on_mesh(batches[lo + 6], mesh)
    k1 = sample_key(key, lo + 6)
    res = pipe._stage_prog(seeds, k1)
    ids = res[10]
    split = {"sample_route_ms": cuda_ms(
        torch, lambda: pipe._stage_prog(seeds, k1), reps=5, rounds=3)}
    pin = dev.type == "cuda"
    pinned = torch.empty(tuple(ids.shape), dtype=ids.dtype, pin_memory=pin)
    shape = (S, pipe.cold_cap, f.dim)
    hrows = torch.empty(shape, dtype=f.hot.dtype, pin_memory=pin)
    drows = torch.empty(shape, dtype=f.hot.dtype, device=dev)
    split["id_fetch_ms"] = cuda_ms(
        torch, lambda: pinned.copy_(ids, non_blocking=True), reps=5,
        rounds=3)
    req = ids.cpu().numpy()

    def gather():
        futs = []
        for s in range(S):
            futs += pipe.cold_store.serve_into(hrows[s].numpy(), s, req[s],
                                               pool=pipe._gather_pool)
        for fu in futs:
            fu.result()

    split["host_gather_ms"] = statistics.median(
        [host_ms(torch, gather, reps=1) for _ in range(5)])
    split["h2d_ms"] = cuda_ms(
        torch, lambda: drows.copy_(hrows, non_blocking=True), reps=5,
        rounds=3)
    out_w = SamplerOutput(node=res[0], row=res[1], col=res[2], edge=res[3],
                          batch=res[4], node_mask=res[5], edge_mask=res[6])
    slots_w = res[9]
    split["train_ms"] = cuda_ms(torch, lambda: pipe.train_step(
        state, out_w, (drows, slots_w), k1), reps=5, rounds=3)
    split["device_ms"] = split["sample_route_ms"] + split["train_ms"]
    split["stage_ms"] = (split["id_fetch_ms"] + split["host_gather_ms"]
                         + split["h2d_ms"])
    split["overlap"] = (split["device_ms"] + split["stage_ms"]
                        - rep["step_ms_median"]) / min(split["device_ms"],
                                                       split["stage_ms"])
    split["h2d_gb_per_s"] = rep["h2d_bytes"] / split["h2d_ms"] / 1e6
    rep["split"] = split
    pipe.close()
    del state

    # The disk tier: a ~SMALL_N-node graph of the same recipe, its
    # shard-major matrix as a raw store behind a DramStager holding an
    # eighth of the cold bytes; staged rows == HostColdStore's, losses
    # within the card's second-run drift.
    t0 = time.perf_counter()
    sp = twin.synthetic_papers(DISK_SCALE, S, DIST_BS, DIST_DIM, DIST_CLASSES)
    sdir = os.path.join(WORK_DIR, "tiered_small_parts")
    store_dir = os.path.join(WORK_DIR, "tiered_small_store")
    shutil.rmtree(sdir, ignore_errors=True)
    try:
        probs = twin.rank_probs(Graph(CSRTopo(sp.edge_index, num_nodes=sp.n),
                                      device=dev), sp.train_idx, S,
                                DIST_FANOUT, DIST_BS)
        twin.partition(sp, sdir, S, [q.cpu().numpy() for q in probs])
        sds = twin.load(sdir, sp.labels, TIERED_RATIO, dev)
        sf = sds.feature
        write_feature_store(store_dir, np.concatenate([
            np.concatenate([sf.hot[s].cpu().numpy(), sf.cold[s]])
            for s in range(S)]), overwrite=True)
        store = DiskFeatureStore(store_dir)
        disk = DiskColdStore(store, sf.nodes_per_shard, sf.hot_per_shard,
                             dram_budget_bytes=sf.cold.nbytes // 8,
                             stage_threads=4)
        dk = {"nodes": sp.n, "budget_bytes": sf.cold.nbytes // 8,
              "build_s": time.perf_counter() - t0}
        sbatches = sds.split_seeds(sp.train_idx, DIST_BS, shuffle=True,
                                   rng=np.random.default_rng(1))
        need(sbatches.shape[0] >= DISK_STEPS + 1, "too few small batches")
        hpipe = tiered_pipeline(sds, sf, mesh)
        dpipe = tiered_pipeline(sds, sf, mesh, cold_store=disk)
        kd = trandom.PRNGKey(400, device=dev)
        oh, rh, slh = staged(torch, hpipe, sbatches[0], sample_key(kd, 0))
        od, rd, sld = staged(torch, dpipe, sbatches[0], sample_key(kd, 0))
        live = slh >= 0
        need(torch.equal(slh, sld) and torch.equal(rh[live], rd[live])
             and int(live.sum()) > 0,
             "DiskColdStore staged other rows than HostColdStore")
        dk["staged_rows_checked"] = int(live.sum())
        runs = {}
        for name, pp in (("host", hpipe), ("host2", hpipe), ("disk", dpipe)):
            st = twin.make_state(sds, DIST_FANOUT, DIST_BS, DIST_CLASSES, dev)
            t1 = time.perf_counter()
            _, ls, _ = pp.run_epoch(st, list(sbatches[:DISK_STEPS]), kd)
            runs[name] = torch.stack(ls).double().cpu()
            dk[f"{name}_s"] = time.perf_counter() - t1

        def rel(a, b):
            return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())

        dk["disk_vs_host_rel"] = rel(runs["disk"], runs["host"])
        dk["host_second_run_rel"] = rel(runs["host2"], runs["host"])
        dk["losses"] = runs["disk"].tolist()
        dk["stager"] = disk.stager.stats()
        need(bool(torch.isfinite(runs["disk"]).all()),
             "a DiskColdStore loss is not finite")
        need(dk["disk_vs_host_rel"] <= TIERED_DRIFT_RTOL,
             f"DiskColdStore losses {dk['disk_vs_host_rel']:.2e} from "
             f"HostColdStore's, past the drift {TIERED_DRIFT_RTOL}")
        need(dk["stager"]["bytes_from_disk"] > 0, "the disk tier read "
                                                  "nothing")
        hpipe.close()
        dpipe.close()
        rep["disk"] = dk
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
        shutil.rmtree(store_dir, ignore_errors=True)

    # Part two on the same 4-shard mesh: seed edges (binary x1, strict
    # and not) and induced subgraphs, each shard == the CPU's.
    t0 = time.perf_counter()
    ip = ds_cpu.graph.indptr.numpy().astype(np.int64)
    ix = ds_cpu.graph.indices.numpy()
    gs = DistNeighborSampler(ds.graph, mesh, num_neighbors=DIST_FANOUT,
                             batch_size=DIST_BS, seed=5)
    cs = DistNeighborSampler(ds_cpu.graph, cmesh, num_neighbors=DIST_FANOUT,
                             batch_size=DIST_BS, seed=5)
    src, dst = shard_edges(ip, ix, c, DIST_BS, np.random.default_rng(13))
    neg = NegativeSampling("binary", 1)
    ed = {"checked_negatives": 0, "negatives_that_are_edges": 0}
    for strict in (False, True):
        outs = [smp.sample_from_edges(src, dst, neg, strict=strict,
                                      key=trandom.PRNGKey(7, device=d))
                for smp, d in ((gs, dev), (cs, cpu))]
        same_sampler_output(torch, *outs, f"sample_from_edges strict="
                                          f"{strict}")
        if strict:
            want = outs[1]
            for s in range(S):
                node = want.node[s].numpy()
                eli = want.metadata["edge_label_index"][s].numpy()
                lab = want.metadata["edge_label"][s].numpy()
                for (a, b), lb in zip(eli.T, lab):
                    if lb == 0 and a >= 0 and b >= 0:
                        ed["checked_negatives"] += 1
                        ed["negatives_that_are_edges"] += sharded_is_edge(
                            ip, ix, c, node[a], node[b])
    need(ed["checked_negatives"] == S * (DIST_BS - 4),
         f"{ed['checked_negatives']} strict negatives checked")
    need(ed["negatives_that_are_edges"] == 0,
         f"{ed['negatives_that_are_edges']} strict negatives are edges")
    subs = [smp.subgraph(batches[1], max_degree=SUB_MAX_DEGREE,
                         key=trandom.PRNGKey(8, device=d))
            for smp, d in ((gs, dev), (cs, cpu))]
    same_sampler_output(torch, *subs, "subgraph")
    induced = 0
    for s in range(S):
        node = subs[1].node[s].numpy()
        m = subs[1].edge_mask[s].numpy()
        r, cc = subs[1].row[s].numpy()[m], subs[1].col[s].numpy()[m]
        for a, b in zip(node[r][:SUB_CHECK_EDGES], node[cc][:SUB_CHECK_EDGES]):
            need(sharded_is_edge(ip, ix, c, a, b), "an induced edge is not "
                                                   "a CSR edge")
            induced += 1
    ed["induced_edges_checked"] = induced
    ed["seconds"] = time.perf_counter() - t0
    rep["edges"] = ed
    return rep


def same_sampler_output(torch, got, want, what: str) -> None:
    """Two stacked sampler outputs (card, CPU) ``torch.equal`` field by
    field, metadata included."""
    for fld in ("node", "row", "col", "edge", "batch", "node_mask",
                "edge_mask", "num_sampled_nodes", "num_sampled_edges"):
        a, b = getattr(got, fld), getattr(want, fld)
        need((a is None and b is None) or torch.equal(a.cpu(), b),
             f"{what}: {fld} differs from the CPU's")
    need(set(got.metadata) == set(want.metadata),
         f"{what}: metadata keys differ")
    for k, v in want.metadata.items():
        need(torch.equal(got.metadata[k].cpu(), v),
             f"{what}: metadata {k} differs from the CPU's")


def log_tiered(rep: dict, dist: dict, card: str) -> None:
    """Phase 13's lines (each number measured on ``card``)."""
    sp, p, dk, ed = rep["split"], rep["profile"], rep["disk"], rep["edges"]
    log(f"tiered: [{card}] DistDataset.load(hot_ratio={TIERED_RATIO}) "
        f"{rep['load_s']:.1f} s: {rep['hot_per_shard']} of "
        f"{rep['nodes_per_shard']} rows a shard on the card "
        f"({rep['hot_bytes']} B), {rep['cold_bytes']} B in host memory; "
        f"step 0 == CPU (stage outputs, {rep['step0_cold_requests']} cold "
        f"requests), tiered gather == whole gather; cold_cap "
        f"{TIERED_SMALL_CAP}: {rep['small_cap_dropped'][0]} drops on the "
        f"card and the CPU, {rep['small_cap_zero_rows']} zero rows")
    log(f"  {TIERED_STEPS} steps: losses {rep['losses'][0]:.4f} -> "
        f"{rep['losses'][-1]:.4f}; step median {rep['step_ms_median']:.2f} "
        f"ms ({rep['subgraphs_per_s']:.1f} subgraphs/s; epoch "
        f"{rep['epoch_s']:.2f} s); cold_cap {rep['cold_cap']}, H2D "
        f"{rep['h2d_bytes']} B a step, max cold rows {rep['max_cold_rows']}, "
        f"drops {rep['dropped']}; captures {rep['captures']}; launches "
        f"{rep['launches']}; card vs CPU step 0 loss {rep['card_loss']:.6f} "
        f"vs {rep['cpu_loss']:.6f} (rel {rep['cpu_loss_rel_err']:.2e})")
    mt = rep["main_thread_ms"]
    log(f"  main thread a warm step: stage 1 enqueue {mt['stage']:.3f} ms, "
        f"waiting for the staging thread {mt['wait']:.3f} ms, train "
        f"enqueue {mt['train']:.3f} ms")
    log(f"  peak memory {rep['max_memory_allocated'] / 2**30:.2f} GiB "
        f"({rep['memory_allocated_before'] / 2**30:.2f} GiB before) against "
        f"phase 11's {dist['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  stage split: sample+route {sp['sample_route_ms']:.3f} ms, train "
        f"{sp['train_ms']:.3f} ms (device {sp['device_ms']:.3f} ms); id "
        f"fetch {sp['id_fetch_ms']:.3f} ms, host gather "
        f"{sp['host_gather_ms']:.3f} ms, H2D {sp['h2d_ms']:.3f} ms "
        f"({sp['h2d_gb_per_s']:.1f} GB/s) (stage {sp['stage_ms']:.3f} ms); "
        f"overlap {sp['overlap']:.2f}")
    log(f"  profiled replayed step: wall {p['wall_ms']:.2f} ms, "
        f"{p['kernels']:.1f} kernels {p['kernels_ms']:.3f} ms "
        f"({p['kernel_share']:.1%}), B1 {p['b1_kernels']:.0f}, B3 "
        f"{p['b3_kernels']:.0f}, graph launches {p['graph_launches']:.0f}, "
        f"{p['launch_calls']:.1f} host launch calls, {p['copies']:.1f} "
        f"copies {p['copies_ms']:.3f} ms; main-thread syncs in warm steps "
        f"{len(rep['syncs'])}")
    b3 = rep["b3"]
    log(f"  B3 {b3['shape']} ({b3['unique_rows']} unique hot rows): kernel "
        f"{b3['ms']:.5f} ms, plain {b3['plain_ms']:.4f} ms, library "
        f"{b3['library_ms']:.4f} ms, bound {b3['bound_ms']:.5f} ms by bytes")
    log(f"  DiskColdStore: {dk['nodes']} nodes, DRAM budget "
        f"{dk['budget_bytes']} B, {dk['staged_rows_checked']} staged rows "
        f"== HostColdStore's; {DISK_STEPS} steps, losses vs HostColdStore "
        f"rel {dk['disk_vs_host_rel']:.2e} (a second host run "
        f"{dk['host_second_run_rel']:.2e}); stager hit rate "
        f"{dk['stager']['hit_rate']:.3f}, from disk "
        f"{dk['stager']['bytes_from_disk']} B; epochs host "
        f"{dk['host_s']:.2f} s, disk {dk['disk_s']:.2f} s")
    log(f"  edges and subgraphs on the mesh: sample_from_edges binary x1 "
        f"(strict and not) and subgraph (max degree {SUB_MAX_DEGREE}) == "
        f"CPU; {ed['negatives_that_are_edges']} of "
        f"{ed['checked_negatives']} strict negatives are edges; "
        f"{ed['induced_edges_checked']} induced edges are CSR edges "
        f"({ed['seconds']:.1f} s)")


# -- phase 12: the example twins ------------------------------------------
def run_twins(torch, ops, trandom) -> dict:
    """Each twin through its entry point on the card, at its own widths
    and a cut depth (see the module docstring), with the launch counts
    set to 0 just before and read just after each."""
    from glt_tpu_torch.examples import (
        bipartite_sage_unsup,
        dist_train_sage,
        train_sage_products,
    )
    from glt_tpu_torch.obs import compilewatch

    prod = ["--device", DEVICE, "--scale", str(TWIN_PRODUCTS_SCALE)]
    runs = {
        "train_sage_products": lambda: train_sage_products.main(
            prod + ["--epochs", "3"]),
        "train_sage_products_loader": lambda: train_sage_products.main(
            prod + ["--epochs", "1", "--group", "0"]),
        "bipartite_sage_unsup": lambda: bipartite_sage_unsup.main(
            ["--device", DEVICE, "--epochs", str(TWIN_EPOCHS)]),
        "dist_train_sage": lambda: dist_train_sage.main(
            ["--device", DEVICE, "--epochs", str(TWIN_EPOCHS)]),
    }
    # The kernels each path must launch.
    uses = {"train_sage_products": ("sample_neighbors_cuda",
                                    "gather_rows_cuda"),
            "train_sage_products_loader": ("sample_neighbors_cuda",
                                           "gather_rows_cuda"),
            "bipartite_sage_unsup": ("sample_neighbors_cuda",
                                     "gather_rows_cuda"),
            "dist_train_sage": ("sample_neighbors_cuda",)}
    rep = {"launches": {k: 0 for k in kernel_wrappers(ops)}}
    for name, run in runs.items():
        for fn in kernel_wrappers(ops).values():
            fn.launches = 0
        trandom.threefry2x32.calls = 0
        captures0 = compilewatch.counts("scanned_node_step")
        t0 = time.perf_counter()
        state, history = run()
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernel_wrappers(ops).items()}
        row = {"seconds": time.perf_counter() - t0, "steps": state.step,
               "history": [np.asarray(h).tolist() for h in history],
               "launches": launches,
               "captures": compilewatch.counts("scanned_node_step")
               - captures0}
        need(trandom.threefry2x32.calls == 0,
             f"{name}: the plain threefry arithmetic ran on the card")
        need(state.step > 0 and all(np.isfinite(h).all() for h in history),
             f"{name}: no step, or a loss not finite: {history}")
        for k in uses[name]:
            need(launches[k] > 0, f"{name} never launched {k}")
        rep[name] = row
        for k, v in launches.items():
            rep["launches"][k] += v
    # Two blocks an epoch of one real pattern each: captured in epoch 2.
    need(rep["train_sage_products"]["captures"] == 2,
         f"the products twin captured "
         f"{rep['train_sage_products']['captures']} blocks, not 2")
    bip = rep["bipartite_sage_unsup"]["history"]
    need(bip[-1] < bip[0], f"the bipartite twin's loss did not fall: {bip}")
    return rep


def log_twins(rep: dict, card: str) -> None:
    for name in ("train_sage_products", "train_sage_products_loader",
                 "bipartite_sage_unsup", "dist_train_sage"):
        r = rep[name]
        first, last = (np.mean(r["history"][0]), np.mean(r["history"][-1]))
        log(f"twin {name} [{card}]: {r['steps']} steps in "
            f"{r['seconds']:.1f} s, loss {first:.4f} -> {last:.4f}, "
            f"captures {r['captures']}, launches {r['launches']}")


# -- phase 14: the distributed path whole ------------------------------------
def counts_zero(ops, trandom) -> None:
    for fn in kernel_wrappers(ops).values():
        fn.launches = 0
    trandom.threefry2x32.calls = 0


def counts_read(ops) -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers(ops).items()}


def add_launches(*parts) -> dict:
    return {k: sum(p[k] for p in parts) for k in parts[0]}


def same_hetero(torch, a, b, what: str, fields=("node", "row", "col", "edge",
                                                 "node_mask", "edge_mask",
                                                 "num_sampled_nodes")):
    """Two hetero outputs (fields lead with the shard axis) equal."""
    for f in fields:
        da, db = getattr(a, f), getattr(b, f)
        need(set(da) == set(db), f"{what}: {f} keys differ")
        for k in da:
            need(torch.equal(da[k].cpu(), db[k].cpu()),
                 f"{what}: {f}[{k}] differs")


def watch_syncs(torch, run) -> list:
    """The host syncs ``run()`` makes on the main thread under the sync
    debug mode, each by its innermost frames."""
    import threading
    import traceback
    import warnings

    found, main, inside = [], threading.main_thread(), [False]

    def on_warning(message, category, filename, lineno, *rest):
        if (inside[0] and threading.current_thread() is main
                and "synchroniz" in str(message)):
            frames = [fr for fr in traceback.extract_stack()[:-1]
                      if not fr.filename.endswith("warnings.py")]
            found.append(" < ".join(
                f"{os.path.basename(fr.filename)}:{fr.lineno} {fr.name}"
                for fr in frames[-4:][::-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            run()
            inside[0] = False
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return found


def hetero_dist_setup(torch, dev):
    """Phase 9's synthetic IGBH (host build) sharded on the card and on
    the CPU (DW_SHARDS shards each), the per-shard seed batches and the
    model maker of the rgat_igbh twin."""
    import argparse

    from glt_tpu_torch.examples import rgat_igbh
    from glt_tpu_torch.examples.datasets import synthetic_igbh
    from glt_tpu_torch.parallel import shard_feature, shard_hetero_graph

    t0 = time.perf_counter()
    ds, train_idx, classes = synthetic_igbh(scale=HETERO["rgat"]["scale"],
                                            device="cpu")
    topos = {et: g.topo for et, g in ds.graph.items()}
    host = {t: ds.get_node_feature(t).hot_rows.numpy()
            for t in ds.get_node_types()}
    labels = np.asarray(ds.get_node_label("paper"))
    S = DW_SHARDS
    side = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        sh = shard_hetero_graph(topos, S, device=d)
        per = sh[("paper", "cites", "paper")].nodes_per_shard
        side[name] = {
            "sharded": sh, "per": per,
            "feats": {t: shard_feature(x, S, device=d)
                      for t, x in host.items()},
            "labels": torch.from_numpy(np.pad(
                labels, (0, S * per - labels.size),
                constant_values=-1).reshape(S, per)).to(d)}
    per = side["cpu"]["per"]
    owned = [train_idx[(train_idx // per) == s] for s in range(S)]
    rngs = [np.random.default_rng(s) for s in range(S)]
    batches = [np.stack([rngs[s].choice(owned[s], DW_BS, replace=False)
                         for s in range(S)]).astype(np.int32)
               for _ in range(DW_BATCHES)]

    def make(d=dev):
        return rgat_igbh.make_model(ds, classes, argparse.Namespace(
            bf16=False, device=str(d)))

    rep = {"build_s": time.perf_counter() - t0,
           "nodes": {t: int(x.shape[0]) for t, x in host.items()},
           "feature_bytes": int(sum(x.nbytes for x in host.values())),
           "edges": {"__".join(et): int(t.indices.shape[0])
                     for et, t in topos.items()},
           "nodes_per_shard": per}
    return rep, side, host, batches, make


def hetero_sampler(side, mesh, **kw):
    from glt_tpu_torch.parallel import DistHeteroNeighborSampler

    return DistHeteroNeighborSampler(side["sharded"], mesh, list(DW_FANOUT),
                                     "paper", batch_size=DW_BS,
                                     frontier_cap=DW_CAP, seed=0, **kw)


def run_hetero_dist(torch, ops, trandom, dev, setup) -> dict:
    """Phase 14's hetero distributed step (see the module docstring)."""
    from glt_tpu_torch.models import adam
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import (Mesh, init_hetero_dist_state,
                                        make_hetero_dist_train_step)

    rep, side, host, batches, make = setup
    cpu = torch.device("cpu")
    S = DW_SHARDS
    mesh, cmesh = Mesh([dev] * S), Mesh([cpu] * S)
    card, cside = side["card"], side["cpu"]
    gs, cs = hetero_sampler(card, mesh), hetero_sampler(cside, cmesh)
    rep["node_capacity"] = gs.node_capacity
    per_sample = b1_per_sample(gs)
    need(per_sample * S == DW_B1_PER_STEP, f"{per_sample} B1 launches a "
                                           f"shard's sample")
    # Batches against the CPU's at the same seeds and key.
    for i in range(2):
        same_hetero(torch, gs.sample_from_nodes(
            batches[i], key=trandom.PRNGKey(i, device=dev)),
            cs.sample_from_nodes(batches[i], key=trandom.PRNGKey(
                i, device=cpu)), f"hetero batch {i}, card vs CPU")

    init = make()
    state = init_hetero_dist_state(init, adam(DW_LR), gs, card["feats"])
    cstate = init_hetero_dist_state(make(cpu), adam(DW_LR), cs,
                                    cside["feats"])
    cstate.model.load_state_dict(state.model.state_dict())
    step = make_hetero_dist_train_step(gs, card["feats"], card["labels"],
                                       mesh, DW_BS)

    # The main path: counts set to 0 just before, read just after.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero(ops, trandom)
    caps0 = compilewatch.counts("hetero_dist_step")
    losses, step_ms, b1 = [], [], []
    for i in range(DW_STEPS):
        before = ops.sample_neighbors_cuda.launches
        t0 = time.perf_counter()
        state, loss, _ = step(state, batches[i], trandom.PRNGKey(
            i, device=dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        b1.append(ops.sample_neighbors_cuda.launches - before)
        losses.append(loss)
    launches = counts_read(ops)
    rep["plain_hash_calls"] = trandom.threefry2x32.calls
    rep["captures"] = compilewatch.counts("hetero_dist_step") - caps0
    rep["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    rep.update(losses=losses.tolist(), step_ms=step_ms, b1_per_step=b1,
               launches=launches)
    need(np.isfinite(losses).all(), "a hetero distributed loss is not "
                                    "finite")
    need(rep["plain_hash_calls"] == 0,
         "the hetero distributed step ran the plain threefry on the card")
    need(rep["captures"] == 1, f"{rep['captures']} captures of the hetero "
                               f"distributed step, not 1")
    need(b1[:2] == [DW_B1_PER_STEP] * 2 and not any(b1[2:]),
         f"B1 launches a step {b1}: not {DW_B1_PER_STEP} in the eager step "
         f"and the capture and none in a replay")
    need(launches["threefry_hash_cuda"] > 0, "the hetero distributed step "
                                             "never launched the hash kernel")

    # Step 0's loss on the CPU from the same weights and key.
    _, closs, _ = make_hetero_dist_train_step(
        cs, cside["feats"], cside["labels"], cmesh, DW_BS)(
        cstate, batches[0], trandom.PRNGKey(0, device=cpu))
    rep["card_loss"], rep["cpu_loss"] = float(losses[0]), float(closs)
    rep["cpu_loss_rel_err"] = abs(rep["card_loss"] - rep["cpu_loss"]) / max(
        abs(rep["cpu_loss"]), 1e-30)
    need(rep["cpu_loss_rel_err"] <= F32_LOSS_RTOL,
         f"step 0's hetero loss on the card {rep['card_loss']} vs CPU "
         f"{rep['cpu_loss']}")

    # Eager and replayed steps in turns from one state (the eager one a
    # fresh step's first call), the first pair profiled on one batch.
    twin = copy_state(state, make, adam(DW_LR))
    turns = {"eager": [], "replayed": []}
    pair = {}
    for j, route in enumerate(("replayed", "eager", "eager", "replayed",
                               "replayed", "eager")):
        i = DW_STEPS + (j // 2 if j < 2 else j)
        key = trandom.PRNGKey(1000 + i, device=dev)
        run = step if route == "replayed" else make_hetero_dist_train_step(
            gs, card["feats"], card["labels"], mesh, DW_BS)
        ctx = (profile_window(torch) if j < 2
               else contextlib.nullcontext())
        with ctx as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if route == "replayed":
                state, loss, _ = run(state, batches[i], key)
            else:
                twin, loss, _ = run(twin, batches[i], key)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        if j < 2:
            p = device_profile(torch, prof, 1, ms)
            p["b1_kernels"] = b1_kernels(torch, prof)
            rep[f"{route}_profile"] = p
            pair[route] = float(loss)
        else:
            turns[route].append(ms)
    rep["turn_ms"] = turns
    rep["replay_vs_eager_rel"] = abs(pair["replayed"] - pair["eager"]) / max(
        abs(pair["eager"]), 1e-30)
    need(rep["replay_vs_eager_rel"] <= F32_LOSS_RTOL,
         f"replayed step's loss {pair['replayed']} vs eager {pair['eager']}")
    need(rep["replayed_profile"]["b1_kernels"] == DW_B1_PER_STEP,
         f"B1 ran {rep['replayed_profile']['b1_kernels']} times in a "
         f"replayed step, not {DW_B1_PER_STEP}")
    rep["step_ms_median"] = statistics.median(step_ms[3:])
    rep["subgraphs_per_s"] = S * DW_BS / rep["step_ms_median"] * 1e3

    # Three replayed steps under the sync debug mode (their keys made
    # before: a key from a host int is a copy to the card).
    keys = [trandom.PRNGKey(i, device=dev)
            for i in range(DW_STEPS + 6, DW_STEPS + 9)]

    def three():
        nonlocal state
        for i, k in zip(range(DW_STEPS + 6, DW_STEPS + 9), keys):
            state, _, _ = step(state, batches[i], k)
    rep["syncs"] = watch_syncs(torch, three)
    need(not rep["syncs"], f"{len(rep['syncs'])} host syncs in replayed "
                           f"hetero steps: {rep['syncs'][:3]}")
    rep["state"] = state
    return rep


def run_hetero_tiered(torch, ops, trandom, dev, setup, state0) -> dict:
    """Phase 14's hetero tiered pipeline (see the module docstring)."""
    from glt_tpu_torch.models import adam
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import (HeteroTieredTrainPipeline, Mesh,
                                        make_hetero_tiered_train_step,
                                        shard_feature_tiered)

    _, side, host, batches, make = setup
    S = DW_SHARDS
    mesh = Mesh([dev] * S)
    card = side["card"]
    samp = hetero_sampler(card, mesh)
    feats = dict(card["feats"])
    feats["paper"] = shard_feature_tiered(host["paper"], S, DW_TIER_RATIO,
                                          device=dev)
    pf = feats["paper"]
    rep = {"hot_per_shard": pf.hot_per_shard,
           "nodes_per_shard": pf.nodes_per_shard,
           "host_bytes": int(pf.cold.nbytes)}
    pipes = {
        "tiered": HeteroTieredTrainPipeline(samp, make_hetero_tiered_train_step(
            samp, feats, card["labels"], mesh, DW_BS), feats, mesh),
        "full": HeteroTieredTrainPipeline(samp, make_hetero_tiered_train_step(
            samp, card["feats"], card["labels"], mesh, DW_BS),
            card["feats"], mesh)}
    run_batches = batches[:DW_TIERED_STEPS]
    key = trandom.PRNGKey(400, device=dev)
    try:
        losses = {}
        for name, pipe in pipes.items():
            st = copy_state(state0, make, adam(DW_LR))
            stamps = []
            train_step = pipe.train_step

            def stamped(*args, _t=train_step):
                stamps.append(time.perf_counter())
                return _t(*args)

            pipe.train_step = stamped
            torch.cuda.synchronize()
            counts_zero(ops, trandom)
            caps0 = [compilewatch.counts(k) for k in (
                "hetero_tiered_stage", "hetero_tiered_train_step")]
            st, ls, _ = pipe.run_epoch(st, run_batches, key)
            torch.cuda.synchronize()
            pipe.train_step = train_step
            rep[f"{name}_launches"] = counts_read(ops)
            rep[f"{name}_captures"] = [compilewatch.counts(k) - c for k, c in
                                       zip(("hetero_tiered_stage",
                                            "hetero_tiered_train_step"),
                                           caps0)]
            need(trandom.threefry2x32.calls == 0, f"{name}: the plain "
                                                  f"threefry on the card")
            losses[name] = torch.stack(ls).double().cpu().numpy()
            gaps = np.diff(np.asarray(stamps)) * 1e3
            rep[f"{name}_step_ms"] = gaps.tolist()
            rep[f"{name}_state"] = st
        rep["losses"] = {k: v.tolist() for k, v in losses.items()}
        rel = np.abs(losses["tiered"] - losses["full"]) / np.maximum(
            np.abs(losses["full"]), 1e-30)
        rep["tiered_vs_full_rel"] = rel.tolist()
        need(np.isfinite(losses["tiered"]).all()
             and rel.max() <= TIERED_DRIFT_RTOL,
             f"tiered losses {losses['tiered']} vs full-HBM "
             f"{losses['full']}")
        pipe = pipes["tiered"]
        rep["dropped"] = pipe.flush_dropped()
        rep["max_cold_rows"] = dict(pipe.max_cold_rows)
        rep["cold_cap"] = dict(pipe.cold_cap)
        rep["h2d_bytes"] = S * pipe.cold_cap["paper"] * pf.dim * 4
        need(rep["dropped"] == 0, f"{rep['dropped']} cold requests past the "
                                  f"default caps {pipe.cold_cap}")
        need(rep["tiered_captures"] == [1, 1],
             f"captures of the hetero stage and train step: "
             f"{rep['tiered_captures']}, not 1 each")
        need(rep["tiered_launches"]["sample_neighbors_cuda"]
             == 2 * DW_B1_PER_STEP,
             f"B1 ran {rep['tiered_launches']['sample_neighbors_cuda']} "
             f"times: not {DW_B1_PER_STEP} in the eager batch and in the "
             f"stage's capture")
        gaps = rep["tiered_step_ms"]
        rep["step_ms_median"] = float(np.median(gaps[2:]))
        rep["subgraphs_per_s"] = S * DW_BS / rep["step_ms_median"] * 1e3

        # Three replayed batches profiled: two graph launches a step.
        st = rep.pop("tiered_state")
        rep.pop("full_state")
        more = batches[DW_STEPS + 9: DW_STEPS + 12]
        with profile_window(torch) as prof:
            t0 = time.perf_counter()
            st, _, _ = pipe.run_epoch(st, more, trandom.PRNGKey(
                401, device=dev))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 3
        p = device_profile(torch, prof, 3, wall)
        p["b1_kernels"] = b1_kernels(torch, prof) / 3
        p["graph_launches"] = sum(
            n for name, n in runtime_calls(torch, prof).items()
            if "GraphLaunch" in name) / 3
        rep["profile"] = p
        need(p["graph_launches"] == 2, f"{p['graph_launches']} graph "
                                       f"launches a replayed tiered step")
        need(p["b1_kernels"] == DW_B1_PER_STEP, f"B1 ran {p['b1_kernels']} "
                                               f"times a replayed step")

        # One warm step's parts, each alone: the stage graph and the
        # train graph (device), the host side of the staging (id fetch,
        # gather, H2D copy).
        seeds = more[0]
        from glt_tpu_torch.parallel.dist_sampler import seeds_on_mesh
        sd = seeds_on_mesh(seeds, mesh)
        k1 = trandom.PRNGKey(402, device=dev)
        res = pipe._stage_prog(sd, k1)
        n = len(res) - 3
        slots, ids = {"paper": res[n]}, {"paper": res[n + 1]}
        split = {"sample_route_ms": cuda_ms(
            torch, lambda: pipe._stage_prog(sd, k1), reps=5, rounds=3)}

        def host_stage():
            staged, copied, _ = pipe._stage_cold_async(ids, slots).result()
            if copied is not None:
                copied.synchronize()
            return staged

        split["host_stage_ms"] = host_ms(torch, host_stage)
        out, fut = pipe._sample_and_stage(seeds, k1)
        staged, copied, _ = fut.result()
        if copied is not None:
            copied.synchronize()
        split["train_ms"] = host_ms(torch, lambda: pipe.train_step(
            st, out, staged, k1))
        device = split["sample_route_ms"] + split["train_ms"]
        stage = split["host_stage_ms"]
        split["overlap"] = (device + stage - rep["step_ms_median"]) / max(
            min(device, stage), 1e-9)
        rep["split"] = split
        return rep
    finally:
        for p in pipes.values():
            p.close()


def run_mesh2d(torch, ops, trandom, dev, keep, hsetup) -> dict:
    """Phase 14's 2 x 2 mesh (see the module docstring): phase 11's
    partition, the scanned step under both routes, the hetero step on
    the mesh, and the ring."""
    import types

    from glt_tpu_torch.examples import dist_train_papers100m as twin
    from glt_tpu_torch.models import adam
    from glt_tpu_torch.obs import compilewatch
    from glt_tpu_torch.parallel import (DistNeighborSampler, Mesh,
                                        global_mesh_2d,
                                        init_hetero_dist_state,
                                        make_hetero_dist_train_step,
                                        make_scanned_dist_train_step)

    cpu = torch.device("cpu")
    S, G, hops = DIST_SHARDS, GROUP, len(DIST_FANOUT)
    dc, batches = keep["ds_cpu"], keep["batches"]
    g, f = dc.graph, dc.feature
    ds = types.SimpleNamespace(
        graph=g._replace(indptr=g.indptr.to(dev), indices=g.indices.to(dev),
                         edge_ids=g.edge_ids.to(dev)),
        feature=f._replace(rows=f.rows.to(dev)), labels=dc.labels.to(dev))
    mesh2 = global_mesh_2d([dev] * S, num_hosts=2)
    m2 = dict(mesh_shape=(2, 2), axis_name=("host", "chip"))
    rep = {"mesh": mesh2.shape}

    # Sampled ids and gathered rows, route against route.
    key = trandom.PRNGKey(500, device=dev)
    hier = dist_batch(torch, ds, batches[0], key, route="hier",
                      fused_frontier=True, **m2)
    same_batches(torch, hier, dist_batch(torch, ds, batches[0], key,
                                         route="flat", fused_frontier=True,
                                         **m2), "2 x 2 mesh: hier vs flat")

    # One scanned block a route (eager), its capture and a replay.
    lo = DIST_STEPS + 4
    blocks = [batches[lo + i * G: lo + (i + 1) * G] for i in range(3)]
    need(all(b.shape[0] == G for b in blocks), "too few seed batches for "
                                               "the 2 x 2 mesh's blocks")
    st0 = twin.make_state(ds, DIST_FANOUT, DIST_BS, DIST_CLASSES, dev)

    def make_model():
        return twin.make_state(ds, DIST_FANOUT, DIST_BS, DIST_CLASSES,
                               dev).model

    first = {}
    rep["launches"] = {k: 0 for k in kernel_wrappers(ops)}
    for route in ("hier", "flat"):
        step = make_scanned_dist_train_step(
            ds.graph, ds.feature, ds.labels, mesh2, DIST_FANOUT, DIST_BS,
            fused_frontier=True, route=route)
        st = copy_state(st0, make_model, adam(LR))
        torch.cuda.synchronize()
        counts_zero(ops, trandom)
        caps0 = compilewatch.counts("scanned_dist_step")
        ms, eager = [], None
        for i, blk in enumerate(blocks):
            t0 = time.perf_counter()
            st, ls, _ = step(st, blk, trandom.fold_in(key, i))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first[route] = ls.double().cpu().numpy()
                eager = counts_read(ops)
        launches = counts_read(ops)
        need(trandom.threefry2x32.calls == 0, f"{route}: the plain threefry "
                                              f"on the card")
        need(compilewatch.counts("scanned_dist_step") - caps0 == 1,
             f"{route}: not one capture of the scanned step")
        need(eager["sample_neighbors_cuda"] == S * hops * G
             and eager["fused_frontier_cuda"] == S * G,
             f"{route}: B1 {eager['sample_neighbors_cuda']}, B3 "
             f"{eager['fused_frontier_cuda']} in an eager block of {G}")
        need(launches["sample_neighbors_cuda"]
             == 2 * eager["sample_neighbors_cuda"],
             f"{route}: B1 launched in a replay")
        rep[route] = {"block_ms": ms, "step_ms": ms[2] / G,
                      "eager_step_ms": ms[0] / G,
                      "collective_bytes": step.collective_bytes,
                      "eager_launches": eager}
        rep["launches"] = add_launches(rep["launches"], launches)
    rel = np.abs(first["hier"] - first["flat"]) / np.maximum(
        np.abs(first["flat"]), 1e-30)
    rep["hier_vs_flat_rel"] = rel.tolist()
    need(rel.max() <= F32_LOSS_RTOL, f"2 x 2 mesh scanned losses hier "
                                     f"{first['hier']} vs flat "
                                     f"{first['flat']}")

    # The hetero step on the 2 x 2 mesh: hier batches == flat, losses.
    _, side, _, hb, make = hsetup
    hm = global_mesh_2d([dev] * DW_SHARDS, num_hosts=2)
    outs, losses = {}, {}
    counts_zero(ops, trandom)
    for route in ("hier", "flat"):
        samp = hetero_sampler(side["card"], hm, route=route)
        outs[route] = samp.sample_from_nodes(hb[0], key=key)
        st = init_hetero_dist_state(make(), adam(DW_LR), samp,
                                    side["card"]["feats"])
        step = make_hetero_dist_train_step(
            samp, side["card"]["feats"], side["card"]["labels"], hm, DW_BS,
            route=route)
        _, loss, _ = step(st, hb[0], key)
        losses[route] = float(loss)
    rep["launches"] = add_launches(rep["launches"], counts_read(ops))
    same_hetero(torch, outs["hier"], outs["flat"], "hetero 2 x 2: hier vs "
                                                   "flat")
    rep["hetero_losses"] = losses
    rep["hetero_rel"] = abs(losses["hier"] - losses["flat"]) / max(
        abs(losses["flat"]), 1e-30)
    need(rep["hetero_rel"] <= F32_LOSS_RTOL, f"hetero 2 x 2 losses {losses}")

    # collective='ring' against the CPU's ring.
    counts_zero(ops, trandom)
    kw = dict(num_neighbors=DIST_FANOUT, batch_size=DIST_BS,
              collective="ring")
    got = DistNeighborSampler(ds.graph, Mesh([dev] * S), **kw
                              ).sample_from_nodes(batches[1], key=key)
    rep["launches"] = add_launches(rep["launches"], counts_read(ops))
    want = DistNeighborSampler(dc.graph, Mesh([cpu] * S), **kw
                               ).sample_from_nodes(
        batches[1], key=trandom.PRNGKey(500, device=cpu))
    for fld in ("node", "row", "col", "edge", "node_mask", "edge_mask",
                "num_sampled_nodes", "num_sampled_edges"):
        need(torch.equal(getattr(got, fld).cpu(), getattr(want, fld)),
             f"ring batch on the card vs CPU: {fld} differs")
    rep["ring_b1"] = rep["launches"]["sample_neighbors_cuda"]
    return rep


def run_dist_whole(torch, ops, trandom, dev, keep: dict) -> dict:
    """Phase 14 (see the module docstring)."""
    rep = {}
    t0 = time.perf_counter()
    setup = hetero_dist_setup(torch, dev)
    rep["hetero"] = het = run_hetero_dist(torch, ops, trandom, dev, setup)
    state = het.pop("state")
    rep["tiered"] = run_hetero_tiered(torch, ops, trandom, dev, setup,
                                      state)
    rep["mesh2d"] = run_mesh2d(torch, ops, trandom, dev, keep, setup)
    ti = rep["tiered"]
    rep["launches"] = add_launches(het["launches"], ti["tiered_launches"],
                                   ti["full_launches"],
                                   rep["mesh2d"]["launches"])
    rep["seconds"] = time.perf_counter() - t0
    return rep


def log_dist_whole(rep: dict, card: str) -> None:
    """Phase 14's lines (each number measured on ``card``)."""
    h, ti, m = rep["hetero"], rep["tiered"], rep["mesh2d"]
    log(f"dist whole: [{card}] IGBH x{HETERO['rgat']['scale']} built in "
        f"{h['build_s']:.1f} s ({h['nodes']}, {h['feature_bytes']} B of "
        f"features) on {DW_SHARDS} shards of {h['nodes_per_shard']} papers")
    p, e = h["replayed_profile"], h["eager_profile"]
    log(f"  hetero step: batches == CPU; {DW_STEPS} steps, losses "
        f"{h['losses'][0]:.4f} -> {h['losses'][-1]:.4f}, B1 a step "
        f"{h['b1_per_step']}, captures {h['captures']}; step 0 card vs CPU "
        f"{h['card_loss']:.6f} vs {h['cpu_loss']:.6f} (rel "
        f"{h['cpu_loss_rel_err']:.2e}); replayed step median "
        f"{h['step_ms_median']:.2f} ms ({h['subgraphs_per_s']:.1f} "
        f"subgraphs/s); in turns replayed " + ", ".join(
            f"{x:.2f}" for x in h["turn_ms"]["replayed"]) + " ms, eager "
        + ", ".join(f"{x:.2f}" for x in h["turn_ms"]["eager"])
        + f" ms; peak memory {h['max_memory_allocated'] / 2**30:.2f} GiB; "
        f"syncs in 3 replayed steps {len(h['syncs'])}")
    for name, q in (("replayed", p), ("eager", e)):
        log(f"  profiled {name} hetero step: wall {q['wall_ms']:.2f} ms, "
            f"{q['kernels']:.0f} kernels {q['kernels_ms']:.3f} ms "
            f"({q['kernel_share']:.1%}), B1 {q['b1_kernels']}, "
            f"{q['launch_calls']:.0f} host launch calls, {q['copies']:.0f} "
            f"copies, {q['memsets']:.0f} memsets")
    sp, tp = ti["split"], ti["profile"]
    log(f"  hetero tiered: papers {ti['hot_per_shard']} of "
        f"{ti['nodes_per_shard']} a shard on the card "
        f"({ti['host_bytes']} B in host memory); {DW_TIERED_STEPS} batches, "
        f"losses vs full-HBM rel max {max(ti['tiered_vs_full_rel']):.2e}; "
        f"drops {ti['dropped']}, cold caps {ti['cold_cap']}, max cold rows "
        f"{ti['max_cold_rows']}, H2D {ti['h2d_bytes']} B a step; step "
        f"median {ti['step_ms_median']:.2f} ms "
        f"({ti['subgraphs_per_s']:.1f} subgraphs/s); parts alone: "
        f"sample+route {sp['sample_route_ms']:.3f} ms, train "
        f"{sp['train_ms']:.3f} ms, host stage {sp['host_stage_ms']:.3f} ms, "
        f"overlap {sp['overlap']:.2f}; replayed step {tp['graph_launches']} "
        f"graph launches, {tp['kernels']:.0f} kernels "
        f"{tp['kernels_ms']:.3f} ms ({tp['kernel_share']:.1%}), wall "
        f"{tp['wall_ms']:.2f} ms")
    for route in ("hier", "flat"):
        r = m[route]
        log(f"  2 x 2 mesh {route}: scanned blocks " + ", ".join(
            f"{x:.1f}" for x in r["block_ms"]) + f" ms (eager, capture, "
            f"replay): step {r['step_ms']:.2f} ms replayed, "
            f"{r['eager_step_ms']:.2f} ms eager; bytes a step ici "
            f"{r['collective_bytes']['ici']} dcn "
            f"{r['collective_bytes']['dcn']}; eager block launches "
            f"{r['eager_launches']}")
    log(f"  2 x 2 mesh: batches hier == flat; scanned losses rel max "
        f"{max(m['hier_vs_flat_rel']):.2e}; hetero hier == flat batches, "
        f"losses {m['hetero_losses']} (rel {m['hetero_rel']:.2e}); ring "
        f"batch == CPU's; launches {rep['launches']} "
        f"({rep['seconds']:.1f} s)")


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
        from glt_tpu_torch.store import quant
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
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()
        try:
            sm_mhz, sm_now = (float(v) for v in clk[0].split(","))
        except (IndexError, ValueError):
            raise Failed(f"nvidia-smi gave no SM clock: {clk}") from None
        log(f"device: {kind} | count {torch.cuda.device_count()} | "
            f"torch {torch.__version__} cuda {torch.version.cuda} | SM "
            f"clock max {sm_mhz:.0f} MHz (now {sm_now:.0f})")
        report["device"] = {"kind": kind, "nvidia_smi": smi[0],
                            "sm_clock_max_mhz": sm_mhz,
                            "sm_clock_mhz": sm_now}
        count_plain_hashes(trandom)

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
            torch, ops, trandom, dev, (pip, pix), rng, sm_mhz)
        h_cases, hk = check_hash_kernel(torch, ops, trandom, dev, rng,
                                        sm_mhz)
        table = torch.from_numpy(feat).to(dev)
        cap = BUCKETS[-1] * (1 + 15 + 150 + 750)
        main_idx = rng.integers(0, PRODUCTS_N, cap).astype(np.int32)
        main_idx[rng.random(cap) < 0.3] = 0          # padding reads row 0
        b2_err, b2_cases, b2 = check_gather_kernel(
            torch, ops, dev, table, torch.from_numpy(main_idx).to(dev), rng)
        b3_err, b3_cases = check_fused_kernel(torch, ops, dev, table, rng)
        del pip, pix, table
        dq_err, dq_cases = check_dequant_kernels(torch, ops, quant, dev, rng)
        log(f"kernels: B1 {b1_cases} cases equal, hash {h_cases} cases "
            f"equal, B2 {b2_cases} cases equal, B3 {b3_cases} cases "
            f"equal, B4 {dq_cases['B4']} cases equal, B5 {dq_cases['B5']} "
            f"cases equal")
        for hop in b1["per_hop"]:
            log(f"  B1 {hop['shape']}: kernel {hop['ms']:.5f} ms, plain "
                f"draw + read {hop['plain_ms']:.4f} ms, bound "
                f"{hop['bound_ms']:.5f} ms by {hop['bound_by']} "
                f"({hop['bytes']} B, {hop['int_ops']} int ops); "
                f"torch.take of the read alone {hop['take_read_ms']:.5f} "
                f"ms; the earlier read-only B1: {B1_READ_ONLY_MS} ms at "
                f"[19200, 5]")
        log(f"  hash {hk['shape']}: kernel {hk['ms']:.5f} ms, plain "
            f"{hk['plain_ms']:.4f} ms, bound {hk['bound_ms']:.2e} ms by "
            f"{hk['bound_by']}")
        log(f"  B2 {b2['shape']}: kernel {b2['ms']:.4f} ms, plain "
            f"{b2['plain_ms']:.4f} ms, library {b2['library_ms']:.4f} ms, "
            f"bound {b2['bound_ms']:.4f} ms")

        # 4. serving
        t0 = time.perf_counter()
        sl = run_slice(torch, dev, indptr, indices, feat, labels, rng)
        report["slice"] = sl
        need(sl["launches"]["sample_neighbors_cuda"] > 0,
             "the serving path never launched B1")
        need(sl["launches"]["gather_rows_cuda"] > 0,
             "the serving path never launched B2")
        log(f"serving: warmup captured {len(BUCKETS)} buckets in "
            f"{sl['warmup_s']:.2f} s; {sl['micro_batches']} replayed "
            f"micro-batches, {sl['messages_checked']} messages checked, CPU "
            f"run equal, a replay per bucket == the eager route, launches "
            f"{sl['launches']} ({time.perf_counter() - t0:.1f} s)")
        for b, row in sl["per_bucket"].items():
            log(f"  bucket {b}: first replayed micro-batch "
                f"{row['latency_ms_first']:.2f} ms; two timed passes a "
                f"route, in turns:")
            for name, r in (("graph", row), ("eager", row["eager"])):
                p = r["profile"]
                log(f"  bucket {b} {name}: median "
                    f"{r['latency_ms_median']:.2f} ms (device stage "
                    f"{r['sample_ms_median']:.2f} ms, host scatter "
                    f"{r['scatter_ms_median']:.2f} ms); profiled wall "
                    f"{p['wall_ms']:.2f} ms, {p['launch_calls']:.0f} host "
                    f"launch calls ({p['runtime_calls']:.0f} runtime "
                    f"calls), {p['kernels']:.0f} kernels "
                    f"{p['kernels_ms']:.3f} ms ({p['kernel_share']:.1%}), "
                    f"B1 {p['b1_kernels']:.0f}, {p['copies']:.0f} copies "
                    f"{p['copies_ms']:.3f} ms, {p['memsets']:.0f} memsets")

        # 5. training
        t0 = time.perf_counter()
        tr, node_list, rows = run_train(torch, dev, indptr, indices, feat,
                                        labels, rng)
        report["train"] = tr
        for k in ("sample_neighbors_cuda", "threefry_hash_cuda",
                  "gather_rows_cuda", "fused_frontier_cuda"):
            need(tr["launches"][k] > 0, f"the training path never "
                                        f"launched {k}")
        b3 = time_fused_kernel(torch, ops, rows, node_list)
        del rows
        log(f"training: {tr['steps']} steps in {TRAIN_BLOCKS} blocks of "
            f"{GROUP}, node capacity {tr['node_capacity']} of "
            f"{tr['full_node_capacity']}, {tr['overflow_batches']} overflow "
            f"batches, losses {tr['losses'][0]:.4f} -> "
            f"{tr['losses'][-1]:.4f} (finite), launches {tr['launches']} "
            f"({time.perf_counter() - t0:.1f} s)")
        log(f"  step: median {tr['step_ms_median']:.2f} ms over replayed "
            f"blocks ({tr['steps_per_s']:.2f} steps/s; blocks "
            + ", ".join(f"{b:.1f}" for b in tr["block_ms"])
            + f" ms: eager, capture, replays); in turns, eager blocks "
            + ", ".join(f"{b:.1f}" for b in tr["eager_block_ms"])
            + " ms, replayed " + ", ".join(
                f"{b:.1f}" for b in tr["turn_graph_block_ms"])
            + f" ms (eager step median {tr['eager_step_ms_median']:.2f} "
            f"ms); peak memory "
            f"{tr['max_memory_allocated'] / 2**30:.2f} GiB; card vs CPU "
            f"loss {tr['card_loss']:.6f} vs {tr['cpu_loss']:.6f} (rel "
            f"{tr['cpu_loss_rel_err']:.2e}); x through B3 equal to the "
            f"plain gather; replayed vs eager block losses rel "
            f"{tr['replay_vs_eager_rel'][0]:.2e} (first), "
            f"{max(tr['replay_vs_eager_rel']):.2e} (max)")
        for name, p in (("replayed", tr["profile"]),
                        ("eager", tr["eager_profile"])):
            log(f"  profiled {name} step: wall {p['wall_ms']:.2f} ms, "
                f"{p['launch_calls']:.1f} host launch calls "
                f"({p['runtime_calls']:.1f} runtime calls), "
                f"{p['kernels']:.1f} kernels {p['kernels_ms']:.3f} ms "
                f"({p['kernel_share']:.1%}), B1 {p['b1_kernels']:.0f}, "
                f"{p['copies']:.0f} copies {p['copies_ms']:.3f} ms, "
                f"{p['memsets']:.0f} memsets {p['memsets_ms']:.3f} ms")
        fc, bs = tr["feature_cache_block"], tr["batched_sample"]
        log(f"  feature_cache block ({fc['cache_rows']} rows): eager, "
            f"captured, replayed in " + ", ".join(
                f"{b:.1f}" for b in fc["block_ms"]) + f" ms; the replay's x "
            f"== the uncached gather; hits {fc['stats']['hits']}, misses "
            f"{fc['stats']['misses']} (rate "
            f"{fc['stats']['hit_rate']:.4f})")
        log(f"  sample_from_nodes_batched G={bs['G']} x {bs['batch_size']}: "
            f"replay == the loop; replay {bs['replay_ms']:.2f} ms, loop of "
            f"{bs['G']} eager samples {bs['loop_ms']:.2f} ms")
        log(f"  B3 {b3['shape']}: kernel {b3['ms']:.4f} ms, plain "
            f"{b3['plain_ms']:.4f} ms, library {b3['library_ms']:.4f} ms, "
            f"bound {b3['bound_ms']:.4f} ms")

        # 6. the compressed feature store
        t0 = time.perf_counter()
        st, tables, serve_node = run_store(torch, dev, indptr, indices, feat,
                                           labels, node_list)
        report["store"] = st
        for k in ("sample_neighbors_cuda", "gather_rows_dequant_cuda",
                  "fused_frontier_dequant_cuda"):
            need(st["launches"][k] > 0, f"the store path never launched {k}")
        b4 = time_gather_dequant(torch, ops, quant, *tables["int8"],
                                 serve_node)
        b4_bf16 = time_gather_dequant(torch, ops, quant, *tables["bf16"],
                                      serve_node)
        b5 = time_fused_dequant(torch, ops, quant, *tables["int8"],
                                node_list)
        del tables, serve_node, node_list
        log(f"store: int8 {st['store_bytes']['int8']} B, bf16 "
            f"{st['store_bytes']['bf16']} B written in {st['write_s']:.1f} "
            f"s; served x == host decode; launches {st['launches']} "
            f"({time.perf_counter() - t0:.1f} s)")
        for b in map(str, BUCKETS):
            log(f"  bucket {b}: median " + ", ".join(
                f"{name} {st['serving'][name][b]['latency_ms_median']:.2f}"
                for name in ("raw",) + STORE_CODECS) + " ms")
        ti = st["tiered"]
        log(f"  split 0.5 (DRAM budget {ti['budget_bytes']} B, cold cache "
            f"{ti['cold_cache_rows']} rows) == split 1.0: gather median "
            f"{ti['gather_ms_median']:.2f} ms, stager hit rate "
            f"{ti['stager']['hit_rate']:.3f}, cold-cache hit rate "
            f"{ti['cold_cache']['hit_rate']:.3f}")
        rf = st["refresh"]
        log(f"  refresh: {rf['layers']} layers x {rf['num_sweeps']} sweeps "
            f"of {rf['block_size']}, {rf['nodes_per_s']:.0f} nodes/s, sweep "
            f"{rf['sweep_ms_mean']:.2f} ms, bytes hbm/dram/disk "
            f"{rf['bytes_from_hbm']}/{rf['bytes_from_dram']}/"
            f"{rf['bytes_from_disk']}, wall {rf['wall_s']:.1f} s; layer-0 "
            f"sweeps {st['refresh_checked_sweeps']} vs CPU rel "
            f"{st['refresh_cpu_rel_err']:.2e}")
        log(f"    between sweeps {rf['sweep_gap_ms_median']:.2f} ms "
            f"(frontier build {rf['frontier_ms_median']:.2f} ms), around "
            f"the layers " + ", ".join(
                f"{b:.1f}" for b in rf["layer_boundary_s"]) + " s")
        p = rf["profile"]
        log(f"    profiled layer-1 sweep: wall {p['wall_ms']:.2f} ms, "
            f"{p['kernels']:.0f} kernels {p['kernels_ms']:.3f} ms "
            f"({p['kernel_share']:.1%}), {p['copies']:.0f} copies "
            f"{p['copies_ms']:.3f} ms, {p['memsets']:.0f} memsets")
        for k in p["top_kernels"][:5]:
            log(f"      {k['count']:.1f} x {k['name']}: {k['ms']:.3f} ms")
        for name, row in (("B4 int8", b4), ("B4 bf16", b4_bf16),
                          ("B5 int8", b5)):
            log(f"  {name} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
                f"ms, bound {row['bound_ms']:.4f} ms")

        # 7. digits
        report["digits"] = dg = run_digits(torch, dev)
        par = dg["int8_parity"]
        log(f"digits: test accuracy {dg['test_acc']:.4f} (> 0.93); int8 "
            f"store {par['acc_int8_split0']:.4f} (split 0.0), "
            f"{par['acc_int8_split1']:.4f} (split 1.0) vs raw "
            f"{par['acc_raw']:.4f}, x equal; {dg['seconds']:.1f} s")

        # 8. link prediction and induced subgraphs
        t0 = time.perf_counter()
        report["link"] = lk = run_link(torch, dev, indptr, indices, feat,
                                       rng)
        ec, b2l = lk["edge_in_csr"], lk["b2_link"]
        log(f"link: sorted view built on the card in "
            f"{lk['sorted_view_s']:.2f} s (edge keys "
            f"{lk['edge_keys_bytes']} B), equal to np.sort over "
            f"{lk['sorted_rows_checked']['rows']} rows (max degree "
            f"{lk['sorted_rows_checked']['max_degree']}); CPU view "
            f"{lk['cpu_sorted_view_s']:.1f} s, equal")
        log(f"  edge_in_csr over {ec['pairs']} pairs == its 32-step plain "
            f"version: {ec['ms']:.4f} ms ({ec['kernels_per_call']:.0f} "
            f"kernels a call), plain {ec['plain_ms']:.4f} ms")
        log(f"  LinkNeighborLoader binary x1: {LINK_BATCHES} batches of "
            f"{LINK_BS}, node capacity {lk['link_node_capacity']}, "
            f"{lk['loader_negatives_that_are_edges']} of "
            f"{lk['loader_negatives']} negatives are edges; batch 0 == CPU; "
            f"triplet x2 and weighted binary checked")
        log(f"  scanned link step: {LINK_BLOCKS} blocks of {GROUP} (eager, "
            f"captured, replays), losses "
            f"{lk['link_losses'][0]:.4f} -> {lk['link_losses'][-1]:.4f}, "
            f"replayed step median {lk['link_step_ms_median']:.2f} ms; "
            f"card vs CPU "
            f"loss {lk['link_card_loss']:.6f} vs {lk['link_cpu_loss']:.6f} "
            f"(rel {lk['link_cpu_loss_rel_err']:.2e})")
        log(f"  scanned subgraph step: {SEAL_BLOCKS} blocks of {GROUP} "
            f"(eager, captured, replays), "
            f"losses {lk['seal_losses'][0]:.4f} -> "
            f"{lk['seal_losses'][-1]:.4f}, replayed step median "
            f"{lk['seal_step_ms_median']:.2f} ms; batch 0 == CPU, its "
            f"induced edges ({lk['seal_checked']['nodes']} nodes, "
            f"{lk['seal_checked']['induced_edges']} edges) exact; card vs "
            f"CPU loss {lk['seal_card_loss']:.6f} vs "
            f"{lk['seal_cpu_loss']:.6f} (rel "
            f"{lk['seal_cpu_loss_rel_err']:.2e})")
        for name in ("link", "subgraph"):
            tm = lk["turn_ms"][name]
            log(f"  {name}: captures {lk['captures']}; replayed vs eager "
                f"block losses rel max "
                f"{max(lk['replay_vs_eager_rel'][name]):.2e}; in turns, "
                f"eager blocks " + ", ".join(f"{b:.1f}" for b in tm["eager"])
                + " ms, replayed " + ", ".join(
                    f"{b:.1f}" for b in tm["graph"]) + f" ms (step "
                f"{statistics.median(tm['graph']) / GROUP:.2f} vs "
                f"{statistics.median(tm['eager']) / GROUP:.2f} ms)")
            for route in ("replayed", "eager"):
                p = lk["profile"][f"{name}_{route}"]
                log(f"  profiled {route} {name} step: wall "
                    f"{p['wall_ms']:.2f} ms, {p['launch_calls']:.1f} host "
                    f"launch calls, {p['kernels']:.1f} kernels "
                    f"{p['kernels_ms']:.3f} ms ({p['kernel_share']:.1%}), "
                    f"{p['copies']:.1f} copies, {p['memsets']:.1f} memsets")
        log(f"  launches {lk['launches']} over {lk['samples']} samples (B1 "
            f"twice a sample); plain threefry on the card: "
            f"{lk['plain_hash_calls']}; B2 {b2l['shape']}: kernel "
            f"{b2l['ms']:.4f} ms, plain {b2l['plain_ms']:.4f} ms, library "
            f"{b2l['library_ms']:.4f} ms, bound {b2l['bound_ms']:.4f} ms "
            f"({time.perf_counter() - t0:.1f} s)")

        # 9. heterogeneous graphs
        t0 = time.perf_counter()
        report["hetero"] = het = run_hetero(torch, ops, trandom, dev, sm_mhz)
        for name in ("rgat", "hgt"):
            h = het[name]
            log(f"hetero {name}: {h['nodes']} nodes built in "
                f"{h['build_s']:.1f} s; {h['loader_batches']} loader "
                f"batches ({h['edges_checked']} edges checked against the "
                f"CSR, x and y equal), batch 0 == CPU; {len(h['losses'])} "
                f"steps, losses {h['losses'][0]:.4f} -> "
                f"{h['losses'][-1]:.4f}; B1 {h['b1_per_sample']} a sample; "
                f"card vs CPU loss rel {h['cpu_loss_rel_err']:.2e}; "
                f"replayed vs eager rel {h['replay_vs_eager_rel'][0]:.2e} "
                f"(first), {max(h['replay_vs_eager_rel']):.2e} (max)"
                + ("" if h["attention_mass_err"] is None else
                   f"; attention mass within {h['attention_mass_err']:.1e}"))
            log(f"  step: replayed {h['step_ms_median']:.2f} ms, eager "
                f"{h['eager_step_ms_median']:.2f} ms (blocks " + ", ".join(
                    f"{b:.1f}" for b in h["block_ms"]) + " ms: eager, "
                f"capture, replays); peak memory "
                f"{h['max_memory_allocated'] / 2**30:.2f} GiB")
            for route, p in (("replayed", h["profile"]),
                             ("eager", h["eager_profile"])):
                log(f"  profiled {route} step: wall {p['wall_ms']:.2f} ms, "
                    f"{p['launch_calls']:.1f} host launch calls, "
                    f"{p['kernels']:.1f} kernels {p['kernels_ms']:.3f} ms "
                    f"({p['kernel_share']:.1%}), B1 {p['b1_kernels']:.0f}")
            for k in h["kernels"]["B1"] + h["kernels"]["B2"]:
                log(f"  {'B1' if 'edge_type' in k else 'B2'} {k['shape']}: "
                    f"kernel {k['ms']:.5f} ms, plain {k['plain_ms']:.4f} ms, "
                    f"bound {k['bound_ms']:.5f} ms by {k['bound_by']}")
        hl = het["link"]
        log(f"  hetero link loader: {HET_BATCHES} batches, positives == seed "
            f"edges, {hl['negatives_that_are_edges']} of {hl['negatives']} "
            f"negatives are edges; launches {het['launches']} "
            f"({time.perf_counter() - t0:.1f} s)")

        # 10. checkpoints and observability
        t0 = time.perf_counter()
        report["ckpt_obs"] = co = run_ckpt_obs(
            torch, dev, indptr, indices, feat, labels, tr["node_capacity"],
            np.random.default_rng(50))
        log_ckpt_obs(co, smi[0], time.perf_counter() - t0)

        # 11. partition and train across a mesh of shards; phase 13
        # reuses its partition directory and loads.
        part_dir = os.path.join(WORK_DIR, "dist_parts")
        shutil.rmtree(part_dir, ignore_errors=True)
        os.makedirs(WORK_DIR, exist_ok=True)
        keep = {}
        try:
            t0 = time.perf_counter()
            report["dist"] = dd = run_dist(torch, ops, trandom, dev, sm_mhz,
                                           part_dir, keep)
            dd["seconds"] = time.perf_counter() - t0
            log_dist(dd, smi[0])
            log(f"  phase 11: {dd['seconds']:.1f} s")

            # 12. the example twins
            t0 = time.perf_counter()
            report["twins"] = tw = run_twins(torch, ops, trandom)
            log_twins(tw, smi[0])
            log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

            # 13. features that outgrow the card
            t0 = time.perf_counter()
            report["tiered"] = ti = run_tiered(torch, ops, trandom, dev,
                                               sm_mhz, keep, part_dir)
            ti["seconds"] = time.perf_counter() - t0
            log_tiered(ti, dd, smi[0])
            log(f"  phase 13: {ti['seconds']:.1f} s")

            # 14. the distributed path whole
            report["dist_whole"] = dw = run_dist_whole(torch, ops, trandom,
                                                       dev, keep)
            log_dist_whole(dw, smi[0])
            log(f"  phase 14: {dw['seconds']:.1f} s")
        finally:
            keep.clear()
            shutil.rmtree(part_dir, ignore_errors=True)
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    launches = {k: sum(p["launches"].get(k, 0)
                       for p in (sl, tr, st, report["digits"], lk, het, co,
                                 dd, tw, ti, dw))
                for k in kernel_wrappers(ops)}
    kernels = [
        {"name": "sample_neighbors_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/sample.cu",
         "replaces": "glt_tpu/ops/sample_pallas.py:162",
         "launches": launches["sample_neighbors_cuda"],
         "max_abs_err": b1_err, "ms": b1["ms"], "plain_ms": b1["plain_ms"],
         "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": b1["library_ms"]},
        {"name": "threefry_hash_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/threefry.cu",
         "replaces": "jax.random threefry (XLA)",
         "launches": launches["threefry_hash_cuda"],
         "max_abs_err": 0, "ms": hk["ms"], "plain_ms": hk["plain_ms"],
         "bound_ms": hk["bound_ms"], "bound_by": hk["bound_by"],
         "library_ms": hk["library_ms"]},
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
        {"name": "gather_rows_dequant_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/gather_dequant.cu",
         "replaces": "glt_tpu/ops/gather_pallas.py:259",
         "launches": launches["gather_rows_dequant_cuda"],
         "max_abs_err": dq_err["B4"], "ms": b4["ms"],
         "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"],
         "bound_by": "bytes", "library_ms": b4["library_ms"]},
        {"name": "fused_frontier_dequant_cuda", "route": "cuda",
         "source": "glt_tpu_torch/csrc/fused_frontier_dequant.cu",
         "replaces": "glt_tpu/ops/fused_frontier.py:184",
         "launches": launches["fused_frontier_dequant_cuda"],
         "max_abs_err": dq_err["B5"], "ms": b5["ms"],
         "plain_ms": b5["plain_ms"], "bound_ms": b5["bound_ms"],
         "bound_by": "bytes", "library_ms": b5["library_ms"]},
    ]
    report["kernels"] = kernels
    report["kernel_detail"] = {"B1": b1, "hash": hk, "B2": b2, "B3": b3,
                               "B4": b4, "B4_bf16": b4_bf16, "B5": b5,
                               "B2_link": lk["b2_link"],
                               "hetero": {n: het[n]["kernels"]
                                          for n in ("rgat", "hgt")},
                               "dist": dd["kernels"],
                               "tiered": {"B3": ti["b3"]}}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(report["device"]["nvidia_smi"])
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profiler_settle_check(windows: int) -> int:
    """``--profiler-settle-check N``: serve PROFILED replayed micro-batches
    per window, N windows per bucket with and without the settle time,
    and count the windows whose profile lacks a B1 kernel, the graph
    replays with no kernel record, and those with no device record at
    all.  Prints one JSON line; not part of the smoke."""
    import torch
    from glt_tpu_torch.data import CSRTopo, Dataset, Graph
    from glt_tpu_torch.ops import cuda_lib
    from glt_tpu_torch.serving import ServingOptions, SubgraphEngine

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cuda_lib.library()
    indptr, indices = build_graph(0)
    drng = np.random.default_rng(1)
    ds = Dataset(graph=Graph(CSRTopo.from_csr_arrays(indptr, indices),
                             device="cuda"), device="cuda")
    ds.init_node_features(drng.standard_normal((PRODUCTS_N, FEAT_DIM),
                                               dtype=np.float32))
    ds.init_node_labels(drng.integers(0, CLASSES, PRODUCTS_N)
                        .astype(np.int32))
    engine = SubgraphEngine(ds, ServingOptions(num_neighbors=FANOUTS,
                                               seed_buckets=BUCKETS))
    engine.warmup()
    lists = request_lists(np.random.default_rng(2), PRODUCTS_N)
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for bucket in BUCKETS:
        for settle_s in (0.0, PROFILER_SETTLE_S):
            short = no_kernels = empty = 0
            for _ in range(windows):
                with profile_window(torch, settle_s) as prof:
                    for reqs in lists[bucket][-PROFILED:]:
                        engine.scatter(engine.sample(
                            [engine.validate_seeds(r) for r in reqs]))
                    torch.cuda.synchronize()
                evs = list(prof.events())
                dev_evs = [ev for ev in evs if ev.device_type == cuda]
                any_rec = {ev.id for ev in dev_evs}
                kern_rec = {ev.id for ev in dev_evs
                            if not ev.name.startswith(("Memcpy", "Memset"))}
                replays = [ev.id for ev in evs if ev.device_type != cuda
                           and ev.name == "cudaGraphLaunch"]
                no_kernels += sum(i not in kern_rec for i in replays)
                empty += sum(i not in any_rec for i in replays)
                short += b1_kernels(torch, prof) != PROFILED * len(FANOUTS)
            rows.append({"bucket": bucket, "settle_s": settle_s,
                         "windows": windows, "windows_short_of_b1": short,
                         "replays_without_kernel_records": no_kernels,
                         "replays_without_records": empty})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"profiler_settle_check": rows, "device": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-worker"]:
        sys.exit(ckpt_worker(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--profiler-settle-check"]:
        sys.exit(profiler_settle_check(int(sys.argv[2])))
    sys.exit(main())
