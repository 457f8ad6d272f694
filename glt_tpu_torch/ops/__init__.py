from .dedup_gather import dedup_counts, dedup_gather_rows
from .fused_frontier import (
    FusedFrontier,
    frontier_plan,
    fused_frontier,
    fused_frontier_supported,
)
from .fused_frontier_cuda import fused_frontier_cuda, fused_frontier_plain
from .fused_frontier_dequant_cuda import (
    fused_frontier_dequant_cuda,
    fused_frontier_dequant_plain,
)
from .gather_cuda import (
    autotune_gather_rows,
    autotune_table,
    gather_rows,
    gather_rows_cuda,
    gather_rows_plain,
)
from .gather_dequant_cuda import (
    gather_rows_dequant_cuda,
    gather_rows_dequant_plain,
)
from .negative_sample import (
    NegativeSampleOutput,
    edge_in_csr,
    edge_in_csr_plain,
    sample_negative_edges,
    weight_to_cdf,
    weighted_draw,
)
from .neighbor_sample import (
    NeighborOutput,
    draw_positions,
    lookup_degrees,
    sample_neighbors,
)
from .sample_cuda import (
    autotune_sample,
    sample_autotune_table,
    sample_neighbors_cuda,
    sample_neighbors_plain,
)
from .stitch import stitch_sample_results
from .subgraph import SubGraphOutput, node_subgraph
from .threefry_cuda import threefry_hash_cuda, threefry_hash_plain
from .unique import (
    DenseInduceState,
    UniqueResult,
    dense_induce,
    dense_induce_final,
    dense_induce_init,
    dense_map_fits,
    relabel_by_reference,
    unique_first_occurrence,
)

__all__ = [
    "DenseInduceState", "FusedFrontier", "NegativeSampleOutput",
    "NeighborOutput", "SubGraphOutput", "UniqueResult",
    "autotune_gather_rows", "autotune_sample", "autotune_table",
    "dedup_counts", "dedup_gather_rows", "dense_induce",
    "dense_induce_final", "dense_induce_init", "dense_map_fits",
    "draw_positions",
    "edge_in_csr", "edge_in_csr_plain", "frontier_plan",
    "fused_frontier",
    "fused_frontier_cuda", "fused_frontier_dequant_cuda",
    "fused_frontier_dequant_plain", "fused_frontier_plain",
    "fused_frontier_supported", "gather_rows", "gather_rows_cuda",
    "gather_rows_dequant_cuda", "gather_rows_dequant_plain",
    "gather_rows_plain", "lookup_degrees", "node_subgraph",
    "relabel_by_reference", "sample_autotune_table", "sample_neighbors",
    "sample_neighbors_cuda",
    "sample_negative_edges", "sample_neighbors_plain",
    "stitch_sample_results", "threefry_hash_cuda", "threefry_hash_plain",
    "unique_first_occurrence", "weight_to_cdf", "weighted_draw",
]
