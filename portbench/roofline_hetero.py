"""The work of the hetero train cell's pieces, from the sampled shapes
(beside :mod:`.roofline`, whose peaks and hop work it uses).

* a row gather (kernel B2's job): the ids read, and each position's row
  read and written (every position of the type's static buffer: the
  kernel is asked for each);
* R-GAT's forward and backward over a sampled batch: the matmul FLOPs
  of what the loss on the seeds reads.  Layer ``l`` of ``L`` is needed
  on the destination nodes within ``L - l`` hops of the seeds; its
  relation ``(s, rel, d)`` projects those ``d`` rows and the ``s`` rows
  within ``L - l + 1`` hops (once, when ``s`` is ``d``): ``2 x rows x
  d_in x width``.  The head maps the seeds: ``2 x B x width x
  classes``.  The backward is counted at twice the forward (the weight
  and the input gradients) on every layer but the first, whose input
  rows are gathered features that need no gradient: its backward is
  the weight gradient alone, once its forward (as
  :func:`.roofline.sage_flops` counts layer 1).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from .roofline import ID_BYTES


def gather_work(positions: int, row_bytes: int) -> Dict[str, float]:
    """Bytes of a row gather of ``positions`` ids of ``row_bytes`` rows."""
    return {"bytes": float(positions * ID_BYTES + 2 * positions * row_bytes),
            "ops": 0.0}


def rgnn_flops(levels: Dict[str, Sequence[int]],
               relations: Sequence[Tuple[str, str, str]],
               dims: Sequence[int], width: int, classes: int,
               seeds: int) -> float:
    """Forward and backward matmul FLOPs of R-GAT on one sampled batch.

    ``levels[t][k]``: valid nodes of type ``t`` first reached at hop
    ``k`` (level 0 the seeds); ``relations``: the model's ``(s, rel,
    d)``; ``dims``: each layer's input width (``len(dims)`` layers);
    ``width``: the layers' output width."""
    layers = len(dims)

    def within(t: str, hops: int) -> int:
        return sum(levels.get(t, [])[: hops + 1])

    total = 0.0
    for l in range(1, layers + 1):
        reach = layers - l
        fwd = 0.0
        for s, _, d in relations:
            rows = within(s, reach + 1)
            if s != d:
                rows += within(d, reach)
            fwd += 2.0 * rows * dims[l - 1] * width
        total += (2.0 if l == 1 else 3.0) * fwd
    return total + 3.0 * 2.0 * seeds * width * classes
