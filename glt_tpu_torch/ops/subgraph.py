"""Induced-subgraph extraction over a node set (cf.
``glt_tpu/ops/subgraph.py``).

Each node's CSR row is scanned up to a static ``max_degree`` cap;
neighbors present in the node set are kept and relabeled to their
position in it (:func:`~glt_tpu_torch.ops.unique.relabel_by_reference`),
so the output has the fixed shape ``[S * max_degree]``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..typing import PADDING_ID
from .neighbor_sample import _row_offsets_and_degrees
from .unique import relabel_by_reference


class SubGraphOutput(NamedTuple):
    """Relabeled induced subgraph."""
    rows: torch.Tensor  # [S * max_degree] local src index, -1 padded
    cols: torch.Tensor  # [S * max_degree] local dst index, -1 padded
    eids: torch.Tensor  # [S * max_degree] global edge ids, -1 padded
    mask: torch.Tensor  # [S * max_degree] bool


def node_subgraph(indptr: torch.Tensor, indices: torch.Tensor,
                  nodes: torch.Tensor, max_degree: int,
                  edge_ids: Optional[torch.Tensor] = None
                  ) -> SubGraphOutput:
    """The subgraph induced by ``nodes`` (unique, -1 padded).

    Edges beyond ``max_degree`` entries into their source's CSR row are
    dropped; pick ``max_degree`` >= the node set's max degree for an
    exact subgraph.
    """
    s = nodes.shape[0]
    nodes = nodes.to(torch.int32)
    start, deg = _row_offsets_and_degrees(indptr, nodes)
    start = start.to(torch.int64)
    offs = torch.arange(max_degree, dtype=torch.int64,
                        device=nodes.device)[None, :]          # [1, D]
    in_row = offs < deg[:, None]                               # [S, D]
    flat = start[:, None] + torch.where(in_row, offs, 0)
    n_idx = indices.shape[0]
    nbr = indices[flat.clamp(0, max(n_idx - 1, 0))] if n_idx else \
        torch.zeros_like(flat)
    dst_global = torch.where(in_row, nbr.to(torch.int32), PADDING_ID)
    local_dst = relabel_by_reference(
        nodes, dst_global.reshape(-1)).reshape(s, max_degree)
    keep = in_row & (local_dst >= 0)
    local_src = torch.arange(s, dtype=torch.int32,
                             device=nodes.device)[:, None].expand(
                                 s, max_degree)
    rows = torch.where(keep, local_src, PADDING_ID).reshape(-1)
    cols = torch.where(keep, local_dst, PADDING_ID).reshape(-1)
    if edge_ids is None:
        eids = torch.where(keep, flat.to(torch.int32), PADDING_ID)
    else:
        eid = edge_ids[flat.clamp(0, max(n_idx - 1, 0))].to(torch.int32)
        eids = torch.where(keep, eid, PADDING_ID)
    return SubGraphOutput(rows=rows, cols=cols, eids=eids.reshape(-1),
                          mask=keep.reshape(-1))
