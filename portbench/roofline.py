"""Peaks of the card and the work of each measured piece, from shapes.

The work is what the inputs need, counted once, whatever an
implementation reads again or pads:

* a hop's draw-and-read (kernel B1's job): for each valid frontier node
  its two row pointers and ``min(deg, fanout)`` neighbour ids read, its
  ``fanout`` output slots written (an int32 id and a one-byte mask
  each), and, where ``deg > fanout``, ``fanout`` uniform draws of
  ``jax.random.randint``, the draw the sampler is specified to make: two
  32-bit words a value, each one threefry2x32-20 block;
* a frontier's dedup-and-gather (kernel B3's job): the ids read, each
  distinct row read once and each position's row written;
* GraphSAGE's forward and backward over a sampled batch: only what the
  loss on the seeds needs.  Layer ``l`` of ``L`` is needed on the nodes
  within ``L - l`` hops of the seeds and aggregates the edges of those
  hops; the backward forms every weight's gradient and the input
  gradient of every layer but the first.

The peaks are NVIDIA's data-sheet figures for the H100 SXM5, dense,
at the full 700 W (the rate a card set below it is judged against).
"""
from __future__ import annotations

from typing import Dict, Sequence

#: HBM3 bandwidth, bytes/s (H100 SXM5 data sheet).
HBM_BYTES_S = 3.35e12
#: Dense bf16 tensor-core rate, FLOP/s (H100 SXM5 data sheet).
BF16_FLOPS = 989e12
#: int32 rate, op/s: 132 SMs x 64 int32 results a clock an SM (CUDA C++
#: Programming Guide, arithmetic-instruction throughput, compute
#: capability 9.0) x 1,980 MHz boost clock (H100 SXM5 data sheet).
INT32_OPS_S = 132 * 64 * 1.98e9
#: The card the peaks belong to (matched against the device name).
PEAK_CARD = "H100"

#: int32 operations of one threefry2x32-20 block: 20 rounds of an add, a
#: rotate and a xor, and 5 key injections of three adds.
THREEFRY_OPS = 20 * 3 + 5 * 3
#: Hash blocks a drawn position needs (randint's two 32-bit words).
BLOCKS_PER_DRAW = 2

ID_BYTES = 4
MASK_BYTES = 1
PTR_BYTES = 4


def hop_work(valid_rows: int, read_nbrs: int, drawing_rows: int,
             fanout: int) -> Dict[str, float]:
    """Bytes and int32 operations of one hop's draw-and-read.

    ``valid_rows``: frontier nodes (not padding); ``read_nbrs``: the sum
    of ``min(deg, fanout)`` over them; ``drawing_rows``: those with
    ``deg > fanout``."""
    nbytes = (valid_rows * (ID_BYTES + 2 * PTR_BYTES)
              + read_nbrs * ID_BYTES
              + valid_rows * fanout * (ID_BYTES + MASK_BYTES))
    ops = drawing_rows * fanout * BLOCKS_PER_DRAW * THREEFRY_OPS
    return {"bytes": float(nbytes), "ops": float(ops)}


def frontier_work(positions: int, distinct: int, dim: int,
                  elem_bytes: int = 4) -> Dict[str, float]:
    """Bytes of a dedup-and-gather of ``positions`` real ids holding
    ``distinct`` distinct rows of ``dim`` elements."""
    row = dim * elem_bytes
    return {"bytes": float(positions * ID_BYTES + distinct * row
                           + positions * row), "ops": 0.0}


def bound_s(work: Dict[str, float]) -> float:
    """The least time the card could take: the larger of bytes over the
    HBM rate and int32 operations over the int32 rate."""
    return max(work["bytes"] / HBM_BYTES_S, work["ops"] / INT32_OPS_S)


def sage_flops(level_nodes: Sequence[int], hop_edges: Sequence[int],
               dims: Sequence[int]) -> float:
    """Forward and backward FLOPs of a ``len(dims) - 1``-layer GraphSAGE
    (mean aggregator, a self and a neighbour map) on one sampled batch.

    ``level_nodes[k]``: nodes first reached at hop ``k`` (the seeds are
    level 0); ``hop_edges[k]``: valid edges sampled at hop ``k``;
    ``dims``: the layer widths, input first."""
    layers = len(dims) - 1
    total = 0.0
    for l in range(1, layers + 1):
        reach = layers - l              # hops whose nodes layer l serves
        n = sum(level_nodes[: reach + 1])
        e = sum(hop_edges[: reach + 1])
        din, dout = dims[l - 1], dims[l]
        mm = 2.0 * 2.0 * n * din * dout          # two maps, 2 FLOP a MAC
        agg = float(e * din)                     # the sum over edges
        total += mm + agg                        # forward
        total += mm                              # weight gradients
        if l > 1:
            total += mm + agg                    # input gradient
    return total
