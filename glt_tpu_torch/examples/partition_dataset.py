"""Offline dataset partitioning.

The port's twin of ``examples/partition_dataset.py``: partition a graph
and its features into the on-disk layout ``DistDataset.load`` reads
(``META.json``, ``node_pb``/``edge_pb``, ``part{i}/graph|node_feat``),
by uniform random assignment or by the hotness-aware frequency
partitioner (each trainer's access probabilities from
``NeighborSampler.sample_prob``, computed on ``--device``).  The graph is
the synthetic ogbn-products-shaped one of ``--scale``.

    python -m glt_tpu_torch.examples.partition_dataset --out DIR \\
        --num-parts 4 --device cpu
    python -m glt_tpu_torch.examples.partition_dataset --out DIR \\
        --num-parts 4 --partitioner frequency --cache-ratio 0.1
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..partition import FrequencyPartitioner, RandomPartitioner, load_partition
from ..sampler import NeighborSampler
from .datasets import synthetic_products


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-parts", type=int, default=4)
    ap.add_argument("--scale", type=float, default=0.01,
                    help="synthetic ogbn-products scale")
    ap.add_argument("--partitioner", choices=["random", "frequency"],
                    default="random")
    ap.add_argument("--fanout", type=int, nargs="+", default=[15, 10, 5])
    ap.add_argument("--cache-ratio", type=float, default=0.1,
                    help="hot-cache fraction per partition (frequency)")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="greedy-assignment granularity; 0 = adaptive "
                         "(>= 20 chunks per partition)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    ds, train_idx = synthetic_products(scale=args.scale, device=args.device)
    topo = ds.get_graph().topo
    n = topo.num_nodes
    feat = ds.get_node_feature().cpu_get(np.arange(n))
    edge_index = np.stack(topo.to_coo())
    chunk = args.chunk_size or min(10000, max(n // (20 * args.num_parts), 1))
    print(f"partitioning {n} nodes / {topo.num_edges} edges "
          f"into {args.num_parts} parts ({args.partitioner})")
    if args.partitioner == "random":
        part = RandomPartitioner(args.out, args.num_parts, n, edge_index,
                                 node_feat=feat, chunk_size=chunk)
    else:
        # Per-trainer hotness: each rank's seed slice drives sample_prob.
        sampler = NeighborSampler(ds.get_graph(), args.fanout,
                                  batch_size=1024)
        probs = [sampler.sample_prob(train_idx[r::args.num_parts], n)
                 .cpu().numpy() for r in range(args.num_parts)]
        part = FrequencyPartitioner(args.out, args.num_parts, n, edge_index,
                                    probs=probs, node_feat=feat,
                                    cache_ratio=args.cache_ratio,
                                    chunk_size=chunk)
    part.partition()
    print(f"wrote partition layout to {args.out}")
    graph, node_feat, _, _, _, meta = load_partition(args.out, 0)
    print(f"verified part0: {node_feat.ids.shape[0]} owned feature rows, "
          f"{graph.eids.shape[0]} edges, meta={meta}")
    return meta


if __name__ == "__main__":
    main()
