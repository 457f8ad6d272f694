"""Coalesced ego-subgraph engine: one device pass serves N requests (cf.
``glt_tpu/serving/engine.py``).

* **Buckets.**  All outstanding requests' seeds are concatenated into
  one -1-padded seed vector, padded to the smallest configured bucket
  that holds it, so the device sees a few fixed shapes.
* **Shared dedup.**  Seeds and frontiers dedup across requests inside
  the one sample: a node two clients both reach is sampled once and its
  feature row is gathered once.
* **Per-request scatter.**  The merged sample is split back per request
  on the host: a depth-limited BFS over the sampled COO from each
  request's seed slots selects the edges within ``num_hops`` of its
  seeds, nodes are relabeled request-locally (seeds first), and each
  client receives a flat ``SampleMessage`` that
  :func:`~glt_tpu_torch.distributed.sample_message.message_to_batch`
  turns into a :class:`~glt_tpu_torch.loader.transform.Batch`.

The device stage runs on the dataset's device: the sampler (kernel B1
per hop on the card) and one feature gather (kernel B2, or B4 from a
compressed store), then one host fetch of the results.  On the card
that stage is one CUDA graph per bucket, as ``glt_tpu`` compiles one
program per bucket: :meth:`SubgraphEngine.warmup` (or a bucket's first
micro-batch) captures it, and every micro-batch replays it over static
seed and key buffers, then takes the pinned copies and the one wait.  A
tiered feature (``split_ratio < 1``) reads its ids on the host, so its
gather runs eagerly after the replayed sample.  On the CPU the stage
runs eagerly.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..distributed.sample_message import SampleMessage
from ..sampler.neighbor_sampler import NeighborSampler
from ..typing import PADDING_ID
from ..utils.graphs import CapturedProgram
from .errors import BadRequest
from .options import ServingOptions

_META_BS = "#META.batch_size"


class CoalescedSample:
    """Host-side view of one dispatched micro-batch plus the seed-slot
    bookkeeping :meth:`SubgraphEngine.scatter` splits results back by."""

    __slots__ = ("seed_lists", "bucket", "node", "row", "col", "edge",
                 "edge_mask", "x", "y", "num_hops")

    def __init__(self, seed_lists, bucket, node, row, col, edge,
                 edge_mask, x, y, num_hops):
        self.seed_lists = seed_lists
        self.bucket = bucket
        self.node = node
        self.row = row
        self.col = col
        self.edge = edge
        self.edge_mask = edge_mask
        self.x = x
        self.y = y
        self.num_hops = num_hops


def _fetch(*tensors: Optional[torch.Tensor]) -> List[Optional[np.ndarray]]:
    """``tensors`` as host numpy arrays after ONE wait, as
    ``jax.device_get`` does: every device->host copy is queued without
    blocking (into pinned host memory when the source is on the card),
    then the stream is waited on once.  numpy has no bfloat16, so bf16
    rows travel as their raw 16-bit patterns (``uint16``, the same
    bytes);
    :func:`~glt_tpu_torch.distributed.sample_message.message_to_batch`
    views them back as ``torch.bfloat16``."""
    host, wait = [], None
    for t in tensors:
        if t is None:
            host.append(None)
            continue
        bf16 = t.dtype == torch.bfloat16
        host.append((bf16, (t.view(torch.int16) if bf16 else t).to(
            "cpu", non_blocking=True)))
        if t.is_cuda:
            wait = t.device
    if wait is not None:
        torch.cuda.current_stream(wait).synchronize()
    return [None if h is None else
            h[1].numpy().view(np.uint16) if h[0] else h[1].numpy()
            for h in host]


class SubgraphEngine:
    """Bucketed sample->dedup->gather passes + per-request splitting.

    Driven from one dispatcher thread; the lock only guards lazy sampler
    construction.
    """

    def __init__(self, dataset, options: ServingOptions):
        self.dataset = dataset
        self.options = options
        self.graph = dataset.get_graph()
        self.num_nodes = int(self.graph.num_nodes)
        self.num_neighbors = list(options.num_neighbors)
        self.buckets = tuple(options.seed_buckets)
        self._feature = (dataset.get_node_feature()
                         if options.with_features else None)
        labels = (dataset.get_node_label()
                  if options.with_labels else None)
        self._labels = None if labels is None else np.asarray(labels)
        self._samplers: Dict[int, NeighborSampler] = {}
        self._programs: Dict[int, CapturedProgram] = {}
        self._lock = threading.Lock()

    # -- request validation -------------------------------------------------
    def validate_seeds(self, seeds) -> np.ndarray:
        """Canonicalize one request's seed set (dedup, order-preserving).

        Raises :class:`BadRequest` on an empty/oversized set or ids
        outside the graph.
        """
        arr = np.asarray(seeds)
        if arr.ndim != 1 or arr.size == 0:
            raise BadRequest(
                f"seed set must be a non-empty 1-D id list, got shape "
                f"{arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            raise BadRequest(f"seed ids must be integers, got {arr.dtype}")
        arr = arr.astype(np.int64)
        if arr.min() < 0 or arr.max() >= self.num_nodes:
            raise BadRequest(
                f"seed ids must lie in [0, {self.num_nodes}), got range "
                f"[{arr.min()}, {arr.max()}]")
        _, first = np.unique(arr, return_index=True)
        arr = arr[np.sort(first)]
        if arr.size > self.options.max_seeds_per_request:
            raise BadRequest(
                f"{arr.size} distinct seeds exceeds the per-request bound "
                f"{self.options.max_seeds_per_request}; split the request")
        return arr.astype(np.int32)

    def bucket_for(self, total_seeds: int) -> int:
        for b in self.buckets:
            if total_seeds <= b:
                return b
        raise BadRequest(
            f"{total_seeds} coalesced seeds exceed the largest bucket "
            f"{self.buckets[-1]}")

    def _sampler(self, bucket: int) -> NeighborSampler:
        with self._lock:
            s = self._samplers.get(bucket)
            if s is None:
                s = NeighborSampler(
                    self.graph, self.num_neighbors, batch_size=bucket,
                    frontier_cap=self.options.frontier_cap,
                    with_edge=self.options.with_edge,
                    seed=self.options.seed + bucket)
                self._samplers[bucket] = s
            return s

    def compiled_buckets(self) -> List[int]:
        """The buckets with a program: captured graphs on the card,
        samplers on the CPU."""
        with self._lock:
            if self.graph.device.type == "cuda":
                return sorted(self._programs)
            return sorted(self._samplers)

    def warmup(self) -> None:
        """Build every bucket's program up front (optional; the first
        real micro-batch per bucket otherwise pays the capture).  Serves
        one single-seed micro-batch per bucket, so each bucket's key
        counter advances once, as in ``glt_tpu``."""
        for b in self.buckets:
            self.sample([np.zeros((1,), np.int32)], bucket=b)

    # -- device stage -------------------------------------------------------
    def _device_stage(self, sampler: NeighborSampler, seeds: torch.Tensor,
                      key: torch.Tensor):
        """Sample, and gather where the feature lives on the device (x
        is None for a tiered feature): ``(node, row, col, edge,
        edge_mask, x)``."""
        g = self.graph
        out = sampler._sample_impl(g.indptr, g.indices, g.gather_edge_ids,
                                   seeds, key)
        f = self._feature
        x = (f.gather(out.node) if f is not None and f.hot_count == f.size
             else None)
        return out.node, out.row, out.col, out.edge, out.edge_mask, x

    def _program(self, bucket: int, sampler: NeighborSampler,
                 seeds: np.ndarray, key: torch.Tensor) -> CapturedProgram:
        """The bucket's captured device stage, captured now at this
        micro-batch's seeds and key if it has none (the warm-up run uses
        that explicit key and leaves the key counter alone)."""
        prog = self._programs.get(bucket)
        if prog is None:
            buf = torch.from_numpy(seeds).to(self.graph.device)
            prog = CapturedProgram(
                lambda sd, k: self._device_stage(sampler, sd, k),
                [buf, key.clone()])
            with self._lock:
                self._programs[bucket] = prog
        return prog

    def sample(self, seed_lists: Sequence[np.ndarray],
               bucket: Optional[int] = None) -> CoalescedSample:
        """Run one coalesced micro-batch through the shared sampler and
        gather, then copy the merged sample to the host: on the card one
        graph replay and one device->host wait for the whole micro-batch,
        however many requests ride it.

        ``seed_lists``: per-request canonical seed arrays (see
        :meth:`validate_seeds`).
        """
        total = int(sum(s.size for s in seed_lists))
        if bucket is None:
            bucket = self.bucket_for(total)
        seeds = np.full((bucket,), PADDING_ID, np.int32)
        off = 0
        for s in seed_lists:
            seeds[off: off + s.size] = s
            off += s.size
        sampler = self._sampler(bucket)
        key = sampler._next_key()
        if self.graph.device.type == "cuda":
            node, row, col, edge, edge_mask, x = self._program(
                bucket, sampler, seeds, key)(seeds, key)
        else:
            node, row, col, edge, edge_mask, x = self._device_stage(
                sampler, torch.from_numpy(seeds), key)
        if self._feature is not None and x is None:
            x = self._feature.gather(node)
        node, row, col, edge, edge_mask, x_h = _fetch(
            node, row, col, edge, edge_mask, x)
        y = None
        if self._labels is not None:
            safe = np.clip(node, 0, self._labels.shape[0] - 1)
            y = np.where(node >= 0, self._labels[safe],
                         PADDING_ID).astype(np.int32)
        return CoalescedSample(
            seed_lists=list(seed_lists), bucket=bucket, node=node, row=row,
            col=col, edge=edge, edge_mask=edge_mask, x=x_h, y=y,
            num_hops=len(self.num_neighbors))

    # -- host scatter stage -------------------------------------------------
    def scatter(self, coal: CoalescedSample) -> List[SampleMessage]:
        """Scatter the merged sample back into per-request messages.

        Per request: a ``num_hops``-bounded BFS over the sampled COO
        from its seed slots, then request-local relabeling with the
        request's seeds in the first slots.
        """
        node, row, col = coal.node, coal.row, coal.col
        cap = node.shape[0]
        bucket = coal.bucket
        # Unique seeds land in the first `bucket` node-buffer slots
        # (first-occurrence order); map id -> local once per micro-batch.
        pos: Dict[int, int] = {}
        for i in range(bucket):
            v = int(node[i])
            if v >= 0 and v not in pos:
                pos[v] = i
        valid = coal.edge_mask & (row >= 0) & (col >= 0)
        row_c = np.where(valid, row, 0)
        col_c = np.where(valid, col, 0)
        out: List[SampleMessage] = []
        for seeds in coal.seed_lists:
            member = np.zeros((cap,), bool)
            seed_locs = np.asarray([pos[int(s)] for s in seeds], np.int64)
            member[seed_locs] = True
            frontier = member.copy()
            sel = np.zeros(valid.shape, bool)
            for _ in range(coal.num_hops):
                new_e = valid & frontier[col_c] & ~sel
                if not new_e.any():
                    break
                sel |= new_e
                reached = np.zeros((cap,), bool)
                reached[row_c[new_e]] = True
                frontier = reached & ~member
                member |= reached
            rest = member.copy()
            rest[seed_locs] = False
            order = np.concatenate([seed_locs, np.flatnonzero(rest)])
            local = np.full((cap,), PADDING_ID, np.int32)
            local[order] = np.arange(order.size, dtype=np.int32)
            n = order.size
            e_idx = np.flatnonzero(sel)
            msg: SampleMessage = {
                "node": node[order].astype(np.int32),
                "row": local[row_c[e_idx]],
                "col": local[col_c[e_idx]],
                "node_mask": np.ones((n,), bool),
                "edge_mask": np.ones((e_idx.size,), bool),
                "batch": np.asarray(seeds, np.int32),
                _META_BS: np.array(seeds.size, np.int64),
            }
            if coal.edge is not None:
                msg["edge"] = coal.edge[e_idx].astype(np.int32)
            if coal.x is not None:
                msg["x"] = coal.x[order]
            if coal.y is not None:
                msg["y"] = coal.y[order]
            out.append(msg)
        return out
