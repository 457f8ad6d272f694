"""What both drivers share: the system under test built from the seed,
the block clock, and the work counted from re-drawn samples.

From the program (``glt_tpu_torch``) the benchmark takes the system
under test and nothing of its yardstick: the graph container, the
sampler and its capacity calibration, the model, the train step and the
gather.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import gen, roofline, traffic

ROLE_RANGES = ("portbench.sample", "portbench.gather")


def build_graph(config: dict, seed: int, dev: torch.device):
    """``(GraphData, Graph)``: the benchmark's arrays and the program's
    graph over them (the program's ``CSRTopo`` takes host arrays, so
    the CSR goes through the host once)."""
    from glt_tpu_torch.data import CSRTopo, Graph

    gd = gen.make_graph(config["graph"], traffic.sub_seeds(seed)["graph"],
                        dev)
    topo = CSRTopo.from_csr_arrays(
        gd.indptr, gd.indices,
        edge_ids=np.arange(gd.num_edges, dtype=np.int32))
    return gd, Graph(topo, device=dev)


def build_sampler(graph, gd, mix: dict, seed: int):
    """The sampler as ``examples/train_sage_products.py`` builds it: its
    node capacity at the ``pct`` percentile of the unique-node counts of
    calibration batches, times ``margin``; the uncapped probe when that
    leaves no room.  Every frontier node is expanded (no frontier cap),
    as GLT's loader does."""
    from glt_tpu_torch.sampler import NeighborSampler, calibrate_node_capacity

    cap = mix["node_capacity"]
    kw = dict(batch_size=int(mix["batch_size"]),
              frontier_cap=None, with_edge=False,
              last_hop_dedup=True)
    probe = NeighborSampler(graph, mix["fanout"], **kw)
    cal = traffic.distinct_batches(gd.train_idx, int(cap["batches"]),
                                   int(mix["batch_size"]), seed, "warm")
    node_cap = calibrate_node_capacity(probe, list(cal.astype(np.int32)),
                                       pct=float(cap["pct"]),
                                       margin=float(cap["margin"]))
    if node_cap >= probe.full_node_capacity:
        return probe
    return NeighborSampler(graph, mix["fanout"], node_capacity=node_cap,
                           **kw)


def init_params(names_shapes, seed: int, dev: torch.device
                ) -> Dict[str, torch.Tensor]:
    """Weights uniform in ``±1/sqrt(fan_in)`` (``nn.Linear``'s bound),
    biases with their layer's bound, drawn on the device in one call."""
    total = sum(int(np.prod(s)) for _, s, _ in names_shapes)
    g = gen.generator(traffic.sub_seeds(seed)["weights"], dev)
    flat = torch.rand(total, generator=g, device=dev) * 2 - 1
    out, lo = {}, 0
    for name, shape, fan_in in names_shapes:
        n = int(np.prod(shape))
        out[name] = (flat[lo: lo + n].reshape(shape) / fan_in ** 0.5)
        lo += n
    return out


class BlockClock:
    """Each block's time as the device sees it: events recorded on the
    stream before and after its dispatch, read once after the window (a
    host clock on the CPU, where only the tests run)."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.pairs: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, a, b) -> None:
        self.pairs.append((a, b))

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def batch_work(out, g: int, indptr: torch.Tensor, fanouts, dims,
               feat_dim: int) -> Dict[str, float]:
    """Work of batch ``g`` of a stacked sample: the roofline bounds of its
    hops (B1) and of its frontier gather (B3), and its GraphSAGE FLOPs."""
    levels = [int(c) for c in out.num_sampled_nodes[g].tolist()]
    edges = [int(c) for c in out.num_sampled_edges[g].tolist()]
    node = out.node[g].long()
    b1 = 0.0
    lo = 0
    for k, f in enumerate(fanouts):
        front = node[lo: lo + levels[k]]
        deg = indptr[front + 1] - indptr[front]
        b1 += roofline.bound_s(roofline.hop_work(
            levels[k], int(deg.clamp(max=f).sum()), int((deg > f).sum()),
            f))
        lo += levels[k]
    count = sum(levels)
    b3 = roofline.bound_s(roofline.frontier_work(count, count, feat_dim))
    flops = roofline.sage_flops(levels, edges, dims) if dims else 0.0
    return {"b1_bound_s": b1, "b3_bound_s": b3, "flops": flops}


def traced_work(sampler, blocks, indptr: torch.Tensor, fanouts,
                dims: Optional[List[int]], feat_dim: int) -> Dict[str, float]:
    """The summed work of the traced blocks, drawn again: batch ``g`` of
    a block under ``split(key, G)[g]``, as the window drew it."""
    tot = {"b1_bound_s": 0.0, "b3_bound_s": 0.0, "flops": 0.0,
           "batches": 0}
    for blk, key in blocks:
        out = sampler.sample_from_nodes_batched(blk, key)
        for g in range(blk.shape[0]):
            if not (blk[g] >= 0).any():
                continue
            w = batch_work(out, g, indptr, fanouts, dims, feat_dim)
            for k, v in w.items():
                tot[k] += v
            tot["batches"] += 1
    return tot
