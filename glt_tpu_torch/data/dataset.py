"""Dataset — graph topology, node and edge features and labels, homo and
hetero (cf. ``glt_tpu/data/dataset.py``).

Every init method takes either one object (homogeneous) or a dict keyed
by node or edge type (heterogeneous), as ``glt_tpu``'s does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..typing import EdgeType, NodeType
from ..utils.device import DeviceLike, resolve_device
from .feature import Feature
from .graph import Graph
from .reorder import sort_by_in_degree
from .topology import CSRTopo

GraphLike = Union[Graph, Dict[EdgeType, Graph]]
FeatureLike = Union[Feature, Dict[Union[NodeType, EdgeType], Feature]]


class Dataset:
    """Graph(s), node and edge features and node labels on one device.

    ``device`` (default ``"cuda"``) is where the init methods place
    their tensors; labels stay host numpy, as in ``glt_tpu``.
    """

    def __init__(self, graph: Optional[GraphLike] = None,
                 node_features: Optional[FeatureLike] = None,
                 node_labels=None, edge_features: Optional[FeatureLike] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.graph = graph
        self.node_features = node_features
        self.edge_features = edge_features
        self.node_labels = node_labels

    def init_graph(self, edge_index=None, edge_ids=None, layout="COO",
                   num_nodes=None,
                   with_sorted_columns: bool = False) -> "Dataset":
        """One graph, or with a dict ``edge_type -> edge_index`` one
        graph per edge type; then ``edge_ids`` and ``layout`` may be
        dicts too, and ``num_nodes`` a dict ``node_type -> count`` whose
        source-type entry sizes each edge type's CSR rows."""
        if isinstance(edge_index, dict):
            graphs: Dict[EdgeType, Graph] = {}
            for etype, ei in edge_index.items():
                eids = None if edge_ids is None else edge_ids.get(etype)
                lo = layout[etype] if isinstance(layout, dict) else layout
                nn = (num_nodes.get(etype[0]) if isinstance(num_nodes, dict)
                      else None)
                topo = CSRTopo(ei, edge_ids=eids, layout=lo, num_nodes=nn)
                graphs[etype] = Graph(topo, device=self.device,
                                      with_sorted_columns=with_sorted_columns)
            self.graph = graphs
        elif edge_index is not None:
            topo = CSRTopo(edge_index, edge_ids=edge_ids, layout=layout,
                           num_nodes=num_nodes)
            self.graph = Graph(topo, device=self.device,
                               with_sorted_columns=with_sorted_columns)
        return self

    def init_node_features(self, node_feature_data=None, id2idx=None,
                           sort_func=None, split_ratio: float = 1.0,
                           dtype: Optional[torch.dtype] = None,
                           dedup: bool = False) -> "Dataset":
        """Build the (tiered) node feature store, or with a dict one
        store per node type.

        With ``split_ratio < 1``, no ``id2idx`` and a homogeneous graph,
        the rows are reordered hottest-first by ``sort_func`` (default
        :func:`~glt_tpu_torch.data.reorder.sort_by_in_degree`), so the
        device-resident prefix holds the most-sampled nodes.
        """
        if isinstance(node_feature_data, dict):
            self.node_features = {
                ntype: Feature(arr, split_ratio=split_ratio,
                               id2index=None if id2idx is None
                               else id2idx.get(ntype),
                               dtype=dtype, dedup=dedup, device=self.device)
                for ntype, arr in node_feature_data.items()}
        elif node_feature_data is not None:
            arr, i2i = np.asarray(node_feature_data), id2idx
            if (i2i is None and split_ratio < 1.0
                    and isinstance(self.graph, Graph)):
                fn = sort_func or sort_by_in_degree
                arr, i2i = fn(arr, split_ratio, self.graph.topo)
            self.node_features = Feature(
                arr, split_ratio=split_ratio, id2index=i2i, dtype=dtype,
                dedup=dedup, device=self.device)
        return self

    def init_edge_features(self, edge_feature_data=None, id2idx=None,
                           split_ratio: float = 1.0,
                           dtype: Optional[torch.dtype] = None) -> "Dataset":
        if isinstance(edge_feature_data, dict):
            self.edge_features = {
                etype: Feature(arr, split_ratio=split_ratio,
                               id2index=None if id2idx is None
                               else id2idx.get(etype),
                               dtype=dtype, device=self.device)
                for etype, arr in edge_feature_data.items()}
        elif edge_feature_data is not None:
            self.edge_features = Feature(
                np.asarray(edge_feature_data), split_ratio=split_ratio,
                id2index=id2idx, dtype=dtype, device=self.device)
        return self

    def init_node_labels(self, node_label_data=None) -> "Dataset":
        if isinstance(node_label_data, dict):
            self.node_labels = {k: np.asarray(v)
                                for k, v in node_label_data.items()}
        elif node_label_data is not None:
            self.node_labels = np.asarray(node_label_data)
        return self

    # -- hetero accessors ----------------------------------------------------
    @property
    def is_hetero(self) -> bool:
        return isinstance(self.graph, dict)

    def get_node_types(self) -> List[NodeType]:
        if not self.is_hetero:
            return []
        return sorted({t for (src, _, dst) in self.graph for t in (src, dst)})

    def get_edge_types(self) -> List[EdgeType]:
        if not self.is_hetero:
            return []
        return sorted(self.graph.keys())

    def get_graph(self, etype: Optional[EdgeType] = None) -> Optional[Graph]:
        if isinstance(self.graph, dict):
            return self.graph.get(etype)
        return self.graph

    def get_node_feature(self, ntype: Optional[NodeType] = None
                         ) -> Optional[Feature]:
        if isinstance(self.node_features, dict):
            return self.node_features.get(ntype)
        return self.node_features

    def get_edge_feature(self, etype: Optional[EdgeType] = None
                         ) -> Optional[Feature]:
        if isinstance(self.edge_features, dict):
            return self.edge_features.get(etype)
        return self.edge_features

    def get_node_label(self, ntype: Optional[NodeType] = None
                       ) -> Optional[np.ndarray]:
        if isinstance(self.node_labels, dict):
            return self.node_labels.get(ntype)
        return self.node_labels
