"""Offline graph partitioning on the host (cf. ``glt_tpu/partition``):
the partitioners (whole-graph, and per-rank chunks or table slices
merged through the filesystem), the on-disk layout and the contiguous
relabel that turns a partition book into arithmetic ownership.  numpy
only; a partition directory written by either package loads in the
other."""
from .base import PartitionerBase, cat_feature_cache, load_partition
from .contiguous import (
    ContiguousRelabel,
    contiguous_relabel,
    relabel_rows,
    relabel_topology,
)
from .dist_random_partitioner import DistRandomPartitioner, hash_partition
from .dist_table_partitioner import DistTableRandomPartitioner
from .frequency_partitioner import FrequencyPartitioner, residency_scores
from .random_partitioner import RandomPartitioner

__all__ = [
    "ContiguousRelabel",
    "DistRandomPartitioner",
    "DistTableRandomPartitioner",
    "FrequencyPartitioner",
    "PartitionerBase",
    "RandomPartitioner",
    "cat_feature_cache",
    "contiguous_relabel",
    "hash_partition",
    "load_partition",
    "relabel_rows",
    "relabel_topology",
    "residency_scores",
]
