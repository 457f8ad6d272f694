"""Device-resident CSR graph (cf. ``glt_tpu/data/graph.py``).

``indptr`` / ``indices`` / ``edge_ids`` are int32 tensors on ``device``.
When the edge ids are positional (``edge_ids[e] == e``), samplers emit
CSR positions directly and skip one random read over the edge array per
hop (:attr:`Graph.gather_edge_ids` is then ``None``).

The column-sorted view that the negative sampler's membership test reads
(:attr:`Graph.sorted_indices`) is built on the graph's device by one
sort of the int64 edge keys ``row << 32 | col``
(:attr:`Graph.edge_keys`): sorted, those keys order the rows as CSR does
and the columns within each row, so the view is their low words, and
membership is a binary search over them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .topology import CSRTopo


class Graph:
    """CSR graph on one device.

    Args:
      topo: host :class:`CSRTopo`.
      device: where the CSR tensors live (default ``"cuda"``).
      with_sorted_columns: build the column-sorted view (and its edge
        keys) now rather than at its first use.
    """

    def __init__(self, topo: CSRTopo, device: DeviceLike = None,
                 with_sorted_columns: bool = False):
        self.topo = topo
        self.device = resolve_device(device)
        self._sorted_indices: Optional[torch.Tensor] = None
        self._edge_keys: Optional[torch.Tensor] = None
        host_eids = topo.edge_ids.astype(np.int32, copy=False)
        # copy=False: int32 arrays (a shared-memory attach) stay views.
        self.indptr = torch.from_numpy(
            topo.indptr.astype(np.int32, copy=False)).to(self.device)
        self.indices = torch.from_numpy(
            topo.indices.astype(np.int32, copy=False)).to(self.device)
        self.edge_ids = torch.from_numpy(
            host_eids.astype(np.int32, copy=True)).to(self.device)
        self._trivial_edge_ids = bool(
            host_eids.shape[0] == 0
            or (host_eids[0] == 0
                and host_eids[-1] == host_eids.shape[0] - 1
                and np.array_equal(
                    host_eids, np.arange(host_eids.shape[0], dtype=np.int32))))
        if with_sorted_columns:
            self._build_sorted_view()

    def _build_sorted_view(self) -> None:
        from ..ops.negative_sample import edge_keys_of

        keys = torch.sort(edge_keys_of(self.indptr, self.indices),
                          stable=True).values
        self._sorted_indices = (keys & 0xFFFFFFFF).to(torch.int32)
        self._edge_keys = keys

    @property
    def sorted_indices(self) -> torch.Tensor:
        """``indices`` with the columns of each CSR row sorted ascending
        (int32, built on first use)."""
        if self._sorted_indices is None:
            self._build_sorted_view()
        return self._sorted_indices

    @property
    def edge_keys(self) -> torch.Tensor:
        """``[E]`` int64 ``row << 32 | sorted_col``, ascending: the keys
        :func:`~glt_tpu_torch.ops.negative_sample.edge_in_csr` searches
        (8 bytes an edge, built with :attr:`sorted_indices`)."""
        if self._edge_keys is None:
            self._build_sorted_view()
        return self._edge_keys

    @property
    def gather_edge_ids(self) -> Optional[torch.Tensor]:
        """Edge-id tensor for samplers, or None when ids are positional
        (the sampler then emits CSR positions without a read)."""
        return None if self._trivial_edge_ids else self.edge_ids

    @property
    def num_nodes(self) -> int:
        return self.topo.num_nodes

    @property
    def num_edges(self) -> int:
        return self.topo.num_edges

    def __repr__(self) -> str:
        return (f"Graph(num_nodes={self.num_nodes}, "
                f"num_edges={self.num_edges}, device={str(self.device)!r})")
