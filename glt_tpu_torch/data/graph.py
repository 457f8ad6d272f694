"""Device-resident CSR graph (cf. ``glt_tpu/data/graph.py``).

``indptr`` / ``indices`` / ``edge_ids`` are int32 tensors on ``device``.
When the edge ids are positional (``edge_ids[e] == e``), samplers emit
CSR positions directly and skip one random read over the edge array per
hop (:attr:`Graph.gather_edge_ids` is then ``None``).
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
    """

    def __init__(self, topo: CSRTopo, device: DeviceLike = None):
        self.topo = topo
        self.device = resolve_device(device)
        host_eids = topo.edge_ids.astype(np.int32, copy=False)
        self.indptr = torch.from_numpy(
            topo.indptr.astype(np.int32)).to(self.device)
        self.indices = torch.from_numpy(
            topo.indices.astype(np.int32)).to(self.device)
        self.edge_ids = torch.from_numpy(
            host_eids.astype(np.int32, copy=True)).to(self.device)
        self._trivial_edge_ids = bool(
            host_eids.shape[0] == 0
            or (host_eids[0] == 0
                and host_eids[-1] == host_eids.shape[0] - 1
                and np.array_equal(
                    host_eids, np.arange(host_eids.shape[0], dtype=np.int32))))

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
