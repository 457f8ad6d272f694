"""Layer-wise whole-graph embedding refresh driver (cf.
``glt_tpu/refresh/driver.py``).

Whole-graph inference layer by layer: layer ``l`` is computed for *all*
nodes before layer ``l+1`` starts, so each node is touched once per layer
and the working set of a step is one node partition plus its 1-hop
frontier.

Data path per sweep (one partition of ``block_size`` nodes):

1. the host builds the frontier: the partition's nodes first, then the
   sorted set of their CSR neighbors not already in the partition,
   -1-padded to the static cap ``block_size * (max_degree + 1)``;
2. ``feature.gather`` pulls the frontier rows through the device / DRAM
   / disk tiers (a compressed store decodes on the device, through
   kernel B4 for the device-resident rows);
3. the step expands the frontier's induced edges with
   :func:`~glt_tpu_torch.ops.subgraph.node_subgraph` and applies one
   layer; messages flow neighbor → owner, so rows ``[:block_len]`` (the
   partition) are exact layer-``l`` outputs;
4. while the device runs the step, the host builds the *next* sweep's
   frontier and hands it to
   :meth:`~glt_tpu_torch.data.feature.Feature.stage_ahead`, so the DRAM
   stager fills ahead of the next gather (``glt_tpu`` builds it before
   the gather; the card would idle while the host works);
5. the partition's rows stream into a
   :class:`~glt_tpu_torch.store.disk.FeatureStoreWriter`; finalize
   publishes ``workdir/layer_{l}`` atomically and the next layer reads it
   back through a fresh tiered ``Feature``.

Sweeps cover disjoint row ranges and row encoding is a pure function, so
rewriting a range after an interruption is bit-identical: a driver given
the :meth:`RefreshDriver.state_dict` of an interrupted one resumes at
its next sweep, the writer re-attaches to its deterministic partial
file, and the published sha256 equals an uninterrupted run's.

Nodes whose degree exceeds ``max_degree`` are truncated to their first
``max_degree`` CSR neighbors; size it to the graph's max degree for an
exact refresh.
"""
from __future__ import annotations

import math
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ops.subgraph import node_subgraph
from ..store.disk import DiskFeatureStore, FeatureStoreWriter
from ..utils.device import DeviceLike, resolve_device

LayerFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class RefreshReport(dict):
    """``run()`` summary: plain dict with attribute sugar."""

    __getattr__ = dict.__getitem__


def sage_refresh_layers(model) -> List[LayerFn]:
    """Split a :class:`~glt_tpu_torch.models.sage.GraphSAGE` into
    per-layer inference callables ``fn(x, edge_index, edge_mask) -> h``:
    ``convs[i]`` then ReLU on every non-last layer, the model's forward
    without dropout."""
    fns: List[LayerFn] = []
    last_i = len(model.convs) - 1
    for i, conv in enumerate(model.convs):
        def fn(x, edge_index, edge_mask, *, _conv=conv, _last=i == last_i):
            h = _conv(x, edge_index, edge_mask)
            return h if _last else torch.relu(h)

        fns.append(fn)
    return fns


class RefreshDriver:
    """Drive a layer-wise whole-graph refresh over a tiered store.

    Parameters
    ----------
    indptr, indices:
        Whole-graph CSR (host numpy; copied to the device once).
    layer_fns:
        One inference callable per layer, ``fn(x, edge_index,
        edge_mask) -> h`` on tensors (see :func:`sage_refresh_layers`).
    store:
        Layer-0 input :class:`~glt_tpu_torch.store.disk.DiskFeatureStore`
        (any codec).
    workdir:
        Output directory; layer ``l`` publishes to ``workdir/layer_{l}``.
    out_codec:
        Codec of the published embedding stores — ``raw`` or ``bf16``
        (``int8`` needs a whole-matrix calibration a streaming writer
        cannot do).
    checkpointer:
        Not ported yet: anything but None raises.  Resume through
        :meth:`state_dict` / :meth:`load_state_dict` instead.
    on_sweep:
        Optional ``hook(driver, layer, sweep)`` called after each sweep's
        rows are written.
    device:
        Where the gathers and the layers run (default ``"cuda"``).
    """

    def __init__(self, indptr, indices, layer_fns: Sequence[LayerFn],
                 store: DiskFeatureStore, workdir: str, *,
                 block_size: int = 256, max_degree: int = 32,
                 out_codec: str = "raw",
                 dram_budget_bytes: int = 64 << 20,
                 split_ratio: float = 0.0, stage_threads: int = 1,
                 checkpointer=None,
                 on_sweep: Optional[Callable] = None,
                 device: DeviceLike = None):
        if out_codec not in ("raw", "bf16"):
            raise ValueError(
                f"refresh out_codec must be raw|bf16, got {out_codec!r}")
        if checkpointer is not None:
            raise NotImplementedError(
                "RefreshDriver(checkpointer=...) needs the checkpoint "
                "store, which is not ported yet; resume with "
                "state_dict()/load_state_dict()")
        self.device = resolve_device(device)
        self._indptr_np = np.asarray(indptr, np.int64)
        # int32 node ids (the engine's id width): the host frontier
        # build sorts them, and 32-bit keys sort faster.
        self._indices_np = np.asarray(indices).astype(np.int32)
        self._indptr = torch.from_numpy(
            self._indptr_np.astype(np.int32)).to(self.device)
        self._indices = torch.from_numpy(self._indices_np).to(self.device)
        self.num_nodes = int(self._indptr_np.shape[0] - 1)
        if store.num_rows != self.num_nodes:
            raise ValueError(
                f"store has {store.num_rows} rows but CSR has "
                f"{self.num_nodes} nodes")
        self.layer_fns = list(layer_fns)
        self.store = store
        self.workdir = os.path.abspath(workdir)
        self.block_size = int(block_size)
        self.max_degree = int(max_degree)
        self.out_codec = out_codec
        self.dram_budget_bytes = int(dram_budget_bytes)
        self.split_ratio = float(split_ratio)
        self.stage_threads = int(stage_threads)
        self.on_sweep = on_sweep
        self.num_sweeps = max(
            1, math.ceil(self.num_nodes / self.block_size))
        self.frontier_cap = self.block_size * (self.max_degree + 1)
        # Resume cursor: the next (layer, sweep) to run.
        self._layer = 0
        self._sweep = 0
        self.totals = {"nodes": 0, "seconds": 0.0, "bytes_from_hbm": 0,
                       "bytes_from_dram": 0, "bytes_from_disk": 0,
                       "stage_errors": 0, "hits": 0, "misses": 0}

    # -- resume protocol ------------------------------------------------
    def state_dict(self) -> dict:
        return {"layer": self._layer, "sweep": self._sweep}

    def load_state_dict(self, state: dict) -> None:
        self._layer = int(state["layer"])
        self._sweep = int(state["sweep"])

    # -- host-side frontier construction -----------------------------
    def frontier(self, sweep: int):
        """``(frontier, block_len, lo)`` of one sweep: the partition's
        nodes first, then their sorted out-of-partition CSR neighbors,
        -1-padded to the static ``frontier_cap``."""
        lo = sweep * self.block_size
        hi = min(self.num_nodes, lo + self.block_size)
        start = self._indptr_np[lo:hi]
        deg = np.minimum(self._indptr_np[lo + 1:hi + 1] - start,
                         self.max_degree)
        offs = np.arange(self.max_degree, dtype=np.int64)[None, :]
        flat = (start[:, None] + offs)[offs < deg[:, None]]
        nbrs = np.unique(self._indices_np[flat])
        # The partition is the id range [lo, hi): drop it from the
        # sorted neighbors (glt_tpu's setdiff1d, without its re-sort).
        ext = nbrs[(nbrs < lo) | (nbrs >= hi)]
        frontier = np.full(self.frontier_cap, -1, np.int32)
        frontier[: hi - lo] = np.arange(lo, hi, dtype=np.int32)
        frontier[hi - lo: hi - lo + ext.size] = ext
        return frontier, int(hi - lo), int(lo)

    # -- device step --------------------------------------------------
    def step(self, layer_fn: LayerFn, x: torch.Tensor,
             frontier: torch.Tensor) -> torch.Tensor:
        """One layer over one frontier: its induced edges, neighbor →
        owner, then ``layer_fn``."""
        sub = node_subgraph(self._indptr, self._indices, frontier,
                            self.max_degree)
        # CSR rows own their neighbor lists; messages flow
        # neighbor -> owner, so src = cols, dst = rows.
        edge_index = torch.stack([sub.cols, sub.rows])
        with torch.no_grad():
            return layer_fn(x, edge_index, sub.mask)

    def _out_dim(self, layer_fn: LayerFn, in_dim: int) -> int:
        x = torch.zeros((1, in_dim), dtype=torch.float32, device=self.device)
        ei = torch.full((2, 1), -1, dtype=torch.int32, device=self.device)
        em = torch.zeros((1,), dtype=torch.bool, device=self.device)
        with torch.no_grad():
            return int(layer_fn(x, ei, em).shape[-1])

    def _layer_root(self, layer: int) -> str:
        return os.path.join(self.workdir, f"layer_{layer}")

    # -- main loop -----------------------------------------------------
    def run(self) -> RefreshReport:
        """Refresh every layer from the resume cursor on; returns a
        summary report."""
        os.makedirs(self.workdir, exist_ok=True)
        from ..data.feature import Feature

        start_layer = self._layer
        for layer in range(start_layer, len(self.layer_fns)):
            layer_fn = self.layer_fns[layer]
            src = (self.store if layer == 0
                   else DiskFeatureStore(self._layer_root(layer - 1)))
            feature = Feature.from_store(
                src, self.dram_budget_bytes,
                split_ratio=self.split_ratio,
                stage_threads=self.stage_threads, device=self.device)
            out_dim = self._out_dim(layer_fn, src.dim)
            writer = FeatureStoreWriter(
                self._layer_root(layer), self.num_nodes, out_dim,
                logical_dtype=np.float32, codec=self.out_codec,
                overwrite=True)
            try:
                first = self._sweep if layer == self._layer else 0
                if first > 0 and not writer.reattached:
                    # The cursor says sweeps [0, first) are done but their
                    # partial output did not survive; sweeps are
                    # idempotent, so redo the layer.
                    first = 0
                nxt = self.frontier(first) if first < self.num_sweeps \
                    else None
                for sweep in range(first, self.num_sweeps):
                    frontier_np, block_len, lo = nxt
                    stats0 = feature.store_stats() or {}
                    t0 = time.perf_counter()
                    frontier = torch.from_numpy(frontier_np).to(self.device)
                    x = feature.gather(frontier)
                    h = self.step(layer_fn, x, frontier)
                    if sweep + 1 < self.num_sweeps:
                        # Overlaps the step queued on the device.
                        nxt = self.frontier(sweep + 1)
                        feature.stage_ahead(nxt[0])
                    writer.write_rows(
                        lo, h[:block_len].float().cpu().numpy())
                    dt = time.perf_counter() - t0
                    stats1 = feature.store_stats() or {}
                    for k in ("hbm", "dram", "disk"):
                        self.totals[f"bytes_from_{k}"] += (
                            stats1.get(f"bytes_from_{k}", 0)
                            - stats0.get(f"bytes_from_{k}", 0))
                    self.totals["nodes"] += block_len
                    self.totals["seconds"] += dt
                    self._layer, self._sweep = layer, sweep + 1
                    if self.on_sweep is not None:
                        self.on_sweep(self, layer, sweep)
                end_stats = feature.store_stats() or {}
                for k in ("stage_errors", "hits", "misses"):
                    self.totals[k] += end_stats.get(k, 0)
            except BaseException:
                feature.close()
                raise
            feature.close()
            writer.finalize()
            self._layer, self._sweep = layer + 1, 0
        secs = self.totals["seconds"]
        lookups = self.totals["hits"] + self.totals["misses"]
        return RefreshReport(
            out_root=self._layer_root(len(self.layer_fns) - 1),
            layers=len(self.layer_fns), num_sweeps=self.num_sweeps,
            nodes=self.totals["nodes"],
            nodes_per_s=self.totals["nodes"] / secs if secs else 0.0,
            bytes_from_hbm=self.totals["bytes_from_hbm"],
            bytes_from_dram=self.totals["bytes_from_dram"],
            bytes_from_disk=self.totals["bytes_from_disk"],
            stage_errors=self.totals["stage_errors"],
            dram_hit_rate=(self.totals["hits"] / lookups if lookups
                           else 0.0))
