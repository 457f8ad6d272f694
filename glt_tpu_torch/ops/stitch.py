"""Stitch per-partition sampling results back into seed order (cf.
``glt_tpu/ops/stitch.py``).

With static ``[b_p, fanout]`` blocks, stitching is one row scatter per
partition into a ``[B, fanout]`` output.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..typing import PADDING_ID


def stitch_sample_results(num_seeds: int,
                          idx_list: Sequence[torch.Tensor],
                          nbrs_list: Sequence[torch.Tensor],
                          eids_list: Sequence[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter partition-local ``[b_p, fanout]`` blocks into seed order.

    ``idx_list[p]`` holds each row's seed position (-1 padded); the
    result ``(nbrs, eids)`` is ``[num_seeds, fanout]`` int32, -1 where no
    partition wrote.  A later partition overwrites an earlier one at the
    same position.
    """
    fanout = nbrs_list[0].shape[1]
    dev = nbrs_list[0].device
    nbrs = torch.full((num_seeds + 1, fanout), PADDING_ID,
                      dtype=torch.int32, device=dev)
    eids = torch.full_like(nbrs, PADDING_ID)
    for idx, nb, ei in zip(idx_list, nbrs_list, eids_list):
        # -1 positions write the spill row (num_seeds), cut off below.
        at = torch.where(idx >= 0, idx, num_seeds).long()
        nbrs[at] = nb.to(torch.int32)
        eids[at] = ei.to(torch.int32)
    return nbrs[:num_seeds], eids[:num_seeds]
