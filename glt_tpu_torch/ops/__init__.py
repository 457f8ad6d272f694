from .dedup_gather import dedup_gather_rows
from .fused_frontier import (
    FusedFrontier,
    frontier_plan,
    fused_frontier,
    fused_frontier_supported,
)
from .fused_frontier_cuda import fused_frontier_cuda, fused_frontier_plain
from .gather_cuda import gather_rows, gather_rows_cuda, gather_rows_plain
from .neighbor_sample import (
    NeighborOutput,
    draw_positions,
    lookup_degrees,
    sample_neighbors,
)
from .sample_cuda import sample_neighbors_cuda, sample_neighbors_plain
from .unique import (
    DenseInduceState,
    UniqueResult,
    dense_induce,
    dense_induce_final,
    dense_induce_init,
    dense_map_fits,
    unique_first_occurrence,
)

__all__ = [
    "DenseInduceState", "FusedFrontier", "NeighborOutput", "UniqueResult",
    "dedup_gather_rows", "dense_induce", "dense_induce_final",
    "dense_induce_init", "dense_map_fits", "draw_positions",
    "frontier_plan", "fused_frontier", "fused_frontier_cuda", "fused_frontier_plain",
    "fused_frontier_supported", "gather_rows",
    "gather_rows_cuda", "gather_rows_plain", "lookup_degrees",
    "sample_neighbors", "sample_neighbors_cuda", "sample_neighbors_plain",
    "unique_first_occurrence",
]
