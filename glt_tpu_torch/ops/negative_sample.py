"""Random negative edge sampling (cf. ``glt_tpu/ops/negative_sample.py``).

All ``trials x num`` candidate pairs are drawn at once, tested for
membership in the graph, and each slot keeps its first passing trial;
with ``padding`` a slot that no trial filled keeps its first draw, so
the output always holds ``num`` pairs.  The draws are the port's
threefry (:mod:`glt_tpu_torch.random`), bit-exact with ``jax.random``,
so with the same key both packages draw the same pairs.

Membership: ``glt_tpu`` runs a branchless 32-step binary search per
pair over the column-sorted CSR rows, which is ~250 launches in eager
PyTorch.  Here the graph's sorted int64 edge keys ``row << 32 | col``
(:attr:`~glt_tpu_torch.data.graph.Graph.edge_keys`) make it one
``searchsorted`` and one compare, with the same booleans.  The 32-step
search stays beside it as :func:`edge_in_csr_plain`, the oracle the
card's checks hold the route to.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import random as trandom
from ..typing import PADDING_ID

_INT32_MAX = (1 << 31) - 1


def _pair_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return (src.long() << 32) | dst.long()


def edge_keys_of(indptr: torch.Tensor,
                 sorted_indices: torch.Tensor) -> torch.Tensor:
    """The int64 key ``row << 32 | col`` of every CSR entry: ascending
    when the rows are column-sorted (``Graph.edge_keys``)."""
    rows = torch.repeat_interleave(
        torch.arange(indptr.shape[0] - 1, dtype=torch.int64,
                     device=indptr.device),
        (indptr[1:] - indptr[:-1]).long(),
        output_size=sorted_indices.shape[0])
    return _pair_keys(rows, sorted_indices)


def edge_in_csr(indptr: torch.Tensor, sorted_indices: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor,
                edge_keys: torch.Tensor) -> torch.Tensor:
    """Does edge ``(src, dst)`` exist?  Bool, False for padding (-1).

    ``sorted_indices`` has its columns sorted within each CSR row;
    ``edge_keys`` are its keys (``Graph.edge_keys``), the one array the
    search reads (the first two arguments keep the signature of
    :func:`edge_in_csr_plain` and ``glt_tpu``'s).
    """
    valid = (src >= 0) & (dst >= 0)
    q = _pair_keys(src.clamp(min=0), dst.clamp(min=0))
    n = edge_keys.shape[0]
    if n == 0:
        return torch.zeros_like(valid)
    pos = torch.searchsorted(edge_keys, q).clamp(max=n - 1)
    return (edge_keys[pos] == q) & valid


def edge_in_csr_plain(indptr: torch.Tensor, sorted_indices: torch.Tensor,
                      src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``glt_tpu``'s branchless lower bound over ``[indptr[s],
    indptr[s+1])``, 32 halving steps: the oracle of :func:`edge_in_csr`.
    Ids past the last row read it as a jax gather clamps (an empty
    row)."""
    valid = (src >= 0) & (dst >= 0)
    last_row = indptr.shape[0] - 1
    s = torch.where(valid, src, 0).long()
    lo = indptr[s.clamp(max=last_row)].long()
    hi = indptr[(s + 1).clamp(max=last_row)].long()
    row_end = hi
    d = dst.to(torch.int32)
    last = max(sorted_indices.shape[0] - 1, 0)
    col = (sorted_indices if sorted_indices.shape[0]
           else torch.zeros(1, dtype=torch.int32, device=indptr.device))
    for _ in range(32):
        cond = lo < hi
        mid = lo + (hi - lo) // 2
        mid_val = col[mid.clamp(0, last)]
        go_right = cond & (mid_val < d)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(cond & ~go_right, mid, hi)
    exists = (lo < row_end) & (col[lo.clamp(0, last)] == d)
    return exists & valid


def weighted_draw(key: torch.Tensor, cdf: torch.Tensor, shape
                  ) -> torch.Tensor:
    """Categorical draw with replacement by inverse-CDF lookup: the
    first index whose ``cdf`` entry exceeds a uniform float32, clipped
    to the last node (int32)."""
    u = trandom.uniform(key, shape)
    idx = torch.searchsorted(cdf, u, right=True)
    return idx.clamp(0, cdf.shape[0] - 1).to(torch.int32)


def _cumsum_f32(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum in XLA:CPU's order for ``jnp.cumsum``:
    blocks of ``base`` summed left to right, each block offset by the
    same scan of the block totals (exclusive).  Every add is a float32
    add, so the bits match on every device."""
    n = x.shape[0]
    nb = -(-n // base)
    blk = torch.zeros(nb * base, dtype=torch.float32, device=x.device)
    blk[:n] = x
    blk = blk.reshape(nb, base)
    out = torch.empty_like(blk)
    acc = torch.zeros(nb, dtype=torch.float32, device=x.device)
    for k in range(base):
        acc = acc + blk[:, k]
        out[:, k] = acc
    if nb > 1:
        prefix = _cumsum_f32(acc, base)
        out[1:] += prefix[:-1, None]
    return out.reshape(-1)[:n]


def weight_to_cdf(weight) -> torch.Tensor:
    """Normalised inclusive float32 cumsum of a non-negative node-weight
    vector (a tensor, or a host array summed on the CPU), in the order
    of ``glt_tpu``'s on the CPU (bit for bit)."""
    w = torch.as_tensor(weight, dtype=torch.float32)
    c = _cumsum_f32(w)
    return c / c[-1]


class NegativeSampleOutput(NamedTuple):
    src: torch.Tensor   # [num] sampled source ids (-1 where nothing found)
    dst: torch.Tensor   # [num]
    mask: torch.Tensor  # [num] bool


def sample_negative_edges(indptr: torch.Tensor, sorted_indices: torch.Tensor,
                          num: int, key: torch.Tensor, num_nodes: int,
                          trials: int = 5, padding: bool = True,
                          num_dst_nodes: Optional[int] = None,
                          src_cdf: Optional[torch.Tensor] = None,
                          dst_cdf: Optional[torch.Tensor] = None, *,
                          edge_keys: torch.Tensor
                          ) -> NegativeSampleOutput:
    """Draw ``num`` node pairs that are (probably) not edges.

    ``trials`` strict rounds; each slot keeps its first pair that is no
    edge.  With ``padding`` a slot that found none keeps its first draw
    (the mask is all True); without, it is -1 and masked off.
    ``num_dst_nodes`` bounds the destination draw (default
    ``num_nodes``); ``src_cdf``/``dst_cdf`` switch a side's uniform draw
    to a weighted one.  ``edge_keys`` (``Graph.edge_keys``) as for
    :func:`edge_in_csr`.
    """
    if num_dst_nodes is None:
        num_dst_nodes = num_nodes
    k = trandom.split(key)
    ks, kd = k[0], k[1]
    if src_cdf is not None:
        src = weighted_draw(ks, src_cdf, (trials, num))
    else:
        src = trandom.randint(ks, (trials, num), 0, num_nodes)
    if dst_cdf is not None:
        dst = weighted_draw(kd, dst_cdf, (trials, num))
    else:
        dst = trandom.randint(kd, (trials, num), 0, num_dst_nodes)
    exists = edge_in_csr(indptr, sorted_indices, src.reshape(-1),
                         dst.reshape(-1), edge_keys).reshape(trials, num)
    # The first passing trial per slot (trial 0 when none passes).
    trial_idx = torch.arange(trials, dtype=torch.int32,
                             device=src.device)[:, None]
    score = torch.where(exists, _INT32_MAX, trial_idx)
    best = score.argmin(dim=0, keepdim=True)

    def pick(a):
        return a.gather(0, best)[0]

    ok = pick(~exists)
    out_src, out_dst = pick(src), pick(dst)
    if padding:
        return NegativeSampleOutput(out_src, out_dst, torch.ones_like(ok))
    return NegativeSampleOutput(torch.where(ok, out_src, PADDING_ID),
                                torch.where(ok, out_dst, PADDING_ID), ok)
