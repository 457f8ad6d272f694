"""Dataset — graph topology, node features and labels (cf.
``glt_tpu/data/dataset.py``, homogeneous half).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .feature import Feature
from .graph import Graph
from .reorder import sort_by_in_degree
from .topology import CSRTopo


class Dataset:
    """One graph + node features + node labels on one device.

    ``device`` (default ``"cuda"``) is where :meth:`init_graph` and
    :meth:`init_node_features` place their tensors; labels stay host
    numpy, as in ``glt_tpu``.
    """

    def __init__(self, graph: Optional[Graph] = None,
                 node_features: Optional[Feature] = None,
                 node_labels: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.node_features = node_features
        self.node_labels = node_labels

    def init_graph(self, edge_index=None, edge_ids=None, layout: str = "COO",
                   num_nodes: Optional[int] = None,
                   with_sorted_columns: bool = False) -> "Dataset":
        if isinstance(edge_index, dict):
            raise NotImplementedError(
                "heterogeneous graphs are not ported yet")
        if edge_index is not None:
            topo = CSRTopo(edge_index, edge_ids=edge_ids, layout=layout,
                           num_nodes=num_nodes)
            self.graph = Graph(topo, device=self.device,
                               with_sorted_columns=with_sorted_columns)
        return self

    def init_node_features(self, node_feature_data=None, id2idx=None,
                           sort_func=None, split_ratio: float = 1.0,
                           dtype: Optional[torch.dtype] = None,
                           dedup: bool = False) -> "Dataset":
        """Build the (tiered) node feature store.

        With ``split_ratio < 1``, no ``id2idx`` and a graph, the rows are
        reordered hottest-first by ``sort_func`` (default
        :func:`~glt_tpu_torch.data.reorder.sort_by_in_degree`), so the
        device-resident prefix holds the most-sampled nodes.
        """
        if isinstance(node_feature_data, dict):
            raise NotImplementedError(
                "heterogeneous features are not ported yet")
        if node_feature_data is not None:
            arr, i2i = np.asarray(node_feature_data), id2idx
            if i2i is None and split_ratio < 1.0 and self.graph is not None:
                fn = sort_func or sort_by_in_degree
                arr, i2i = fn(arr, split_ratio, self.graph.topo)
            self.node_features = Feature(
                arr, split_ratio=split_ratio, id2index=i2i, dtype=dtype,
                dedup=dedup, device=self.device)
        return self

    def init_node_labels(self, node_label_data=None) -> "Dataset":
        if node_label_data is not None:
            self.node_labels = np.asarray(node_label_data)
        return self

    @property
    def is_hetero(self) -> bool:
        return False

    def get_graph(self, etype=None) -> Optional[Graph]:
        return self.graph

    def get_node_feature(self, ntype=None) -> Optional[Feature]:
        return self.node_features

    def get_node_label(self, ntype=None) -> Optional[np.ndarray]:
        return self.node_labels
