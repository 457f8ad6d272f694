"""Fixed-fanout random neighbor sampling over CSR (cf.
``glt_tpu/ops/neighbor_sample.py``).

Output is static ``[num_seeds, fanout]`` with -1 padding; without
replacement the draw is Floyd's k-subset algorithm (O(fanout^2) per row,
independent of degree); rows with ``degree <= fanout`` return their full
neighbor list in CSR order.  The draw runs on the port's threefry
(:mod:`glt_tpu_torch.random`), bit-exact with ``jax.random``, so with the
same key the port and ``glt_tpu`` pick the same neighbors.

On a CUDA tensor the whole hop — the draw and the neighbor read — is
one launch of kernel B1 (:mod:`.sample_cuda`), at the launch point
``autotune_sample`` memoized for its exact (batch, fanout, dtype), else
the default point; on a CPU tensor it is B1's plain version:
:func:`draw_positions` (this module, plain threefry arithmetic) followed
by the read.

Floyd's steps all draw from keys known up front (``split(key,
fanout)``) against bounds known up front (``deg - fanout + i``), so the
port draws every step's candidate in one batched threefry pass and
keeps only the duplicate test sequential.  The bits are those of
``glt_tpu``'s step-by-step loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import random as trandom


class NeighborOutput(NamedTuple):
    """One-hop sampling result."""
    nbrs: torch.Tensor               # [B, fanout] neighbor ids, -1 padded
    eids: Optional[torch.Tensor]     # [B, fanout] edge ids, -1 padded
    mask: torch.Tensor               # [B, fanout] bool validity


def _row_offsets_and_degrees(indptr: torch.Tensor, seeds: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-seed CSR offsets/degrees; invalid (negative) seeds get degree
    0.  Ids past the last row clamp to it (degree 0), as a jax gather
    clamps."""
    valid = seeds >= 0
    last = indptr.shape[0] - 1
    safe = torch.where(valid, seeds, 0).long()
    start = indptr[safe.clamp(max=last)]
    deg = indptr[(safe + 1).clamp(max=last)] - start
    deg = torch.where(valid, deg, 0)
    return start, deg.to(torch.int32)


def _floyd(deg: torch.Tensor, fanout: int, t: torch.Tensor) -> torch.Tensor:
    """Floyd's k-subset over pre-drawn candidates ``t [B, fanout]``
    (``t[:, i] < max(deg - fanout + i + 1, 1)``)."""
    b = deg.shape[0]
    steps = torch.arange(fanout, dtype=torch.int32, device=deg.device)
    j = deg[:, None] - fanout + steps[None, :]              # [B, F]
    chosen = torch.full((b, fanout), -1, dtype=torch.int32,
                        device=deg.device)
    big = deg > fanout
    for i in range(fanout):
        ti = t[:, i]
        dup = (chosen == ti[:, None]).any(dim=1)
        floyd_pos = torch.where(dup, j[:, i], ti)
        chosen[:, i] = torch.where(big, floyd_pos, i)
    return chosen


def _mask(deg: torch.Tensor, fanout: int, with_replacement: bool
          ) -> torch.Tensor:
    slots = torch.arange(fanout, dtype=torch.int32, device=deg.device)
    if with_replacement:
        width = torch.where(deg > 0, fanout, 0)
    else:
        width = deg.clamp(max=fanout)
    return slots[None, :] < width[:, None]


def _draw_positions(deg: torch.Tensor, fanout: int, key: torch.Tensor,
                    with_replacement: bool):
    """Per-(key, buffer slot) draw: ``(pos [B, F], mask [B, F])``."""
    b = deg.shape[0]
    if with_replacement:
        pos = trandom.randint(key, (b, fanout), 0,
                              deg.clamp(min=1)[:, None], plain=True)
        return pos, _mask(deg, fanout, True)
    keys = trandom.split(key, fanout, plain=True)             # [F, 2]
    steps = torch.arange(fanout, dtype=torch.int32, device=deg.device)
    bound = (deg[None, :] - fanout + steps[:, None] + 1).clamp(min=1)
    t = trandom.randint(keys, (b,), 0, bound, plain=True)     # [F, B]
    return _floyd(deg, fanout, t.t()), _mask(deg, fanout, False)


def _draw_positions_by_id(deg: torch.Tensor, fanout: int, key: torch.Tensor,
                          with_replacement: bool, seeds: torch.Tensor):
    """Layout-invariant draw: each row keys its own stream with
    ``fold_in(key, seed id)``, so an id draws the same positions wherever
    it sits in the request buffer."""
    row_keys = trandom.fold_in(key, torch.where(seeds >= 0, seeds, 0),
                               plain=True)
    if with_replacement:
        pos = trandom.randint(row_keys, (fanout,), 0,
                              deg.clamp(min=1)[:, None], plain=True)
        return pos, _mask(deg, fanout, True)
    keys = trandom.split(row_keys, fanout, plain=True)        # [B, F, 2]
    steps = torch.arange(fanout, dtype=torch.int32, device=deg.device)
    bound = (deg[:, None] - fanout + steps[None, :] + 1).clamp(min=1)
    t = trandom.randint(keys, (), 0, bound, plain=True)       # [B, F]
    return _floyd(deg, fanout, t), _mask(deg, fanout, False)


def draw_positions(deg: torch.Tensor, fanout: int, key: torch.Tensor,
                   with_replacement: bool, seeds: torch.Tensor,
                   key_by: str = "slot"):
    """The plain draw, ``(pos [B, F], mask [B, F])``: ``key_by='slot'``
    keys per (key, buffer slot); ``key_by='id'`` keys per (key, seed
    id).  Plain threefry arithmetic on any device; kernel B1 draws the
    same bits on the card."""
    if key_by == "slot":
        return _draw_positions(deg, fanout, key, with_replacement)
    if key_by == "id":
        return _draw_positions_by_id(deg, fanout, key, with_replacement,
                                     seeds)
    raise ValueError(f"key_by must be 'slot' or 'id', got {key_by!r}")


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     seeds: torch.Tensor, fanout: int, key: torch.Tensor,
                     edge_ids: Optional[torch.Tensor] = None,
                     with_replacement: bool = False, with_edge: bool = True,
                     key_by: str = "slot") -> NeighborOutput:
    """Sample up to ``fanout`` neighbors per seed from a CSR graph:
    kernel B1 for CUDA tensors, its plain version for CPU tensors.

    Args:
      indptr: ``[N+1]`` int32 CSR row pointers.
      indices: ``[E]`` int32 CSR neighbor ids.
      seeds: ``[B]`` seed ids; negative entries are padding.
      fanout: static per-seed sample size (> 0).
      key: threefry key (:func:`glt_tpu_torch.random.PRNGKey`).
      edge_ids: optional ``[E]`` int32 global edge ids; ``None`` means
        positional ids (CSR positions are emitted without a read).
      with_replacement: i.i.d. uniform neighbors instead of a subset.
      with_edge: when False, ``eids`` is None.
      key_by: 'slot' or 'id' (see :func:`draw_positions`).
    """
    if fanout <= 0:
        raise ValueError(f"fanout must be positive, got {fanout}")
    # sample_cuda builds its plain version from this module's draw.
    from . import sample_cuda

    seeds = seeds.to(torch.int32).contiguous()
    kw = dict(edge_ids=edge_ids, with_replacement=with_replacement,
              with_edge=with_edge, key_by=key_by)
    if indices.device.type == "cuda":
        return sample_cuda.sample_neighbors_cuda(
            indptr, indices, seeds, fanout, key, **kw,
            params=sample_cuda.auto_params(seeds.shape[0], fanout,
                                           indices.dtype))
    return sample_cuda.sample_neighbors_plain(indptr, indices, seeds,
                                              fanout, key, **kw)


def lookup_degrees(indptr: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """Per-seed out-degree (int32; 0 for padding)."""
    _, deg = _row_offsets_and_degrees(indptr, seeds.to(torch.int32))
    return deg
