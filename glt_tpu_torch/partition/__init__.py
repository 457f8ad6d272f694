"""Offline graph partitioning on the host (cf. ``glt_tpu/partition``):
the partitioners, the on-disk layout and the contiguous relabel that
turns a partition book into arithmetic ownership.  numpy only; a
partition directory written by either package loads in the other."""
from .base import PartitionerBase, cat_feature_cache, load_partition
from .contiguous import (
    ContiguousRelabel,
    contiguous_relabel,
    relabel_rows,
    relabel_topology,
)
from .frequency_partitioner import FrequencyPartitioner, residency_scores
from .random_partitioner import RandomPartitioner

__all__ = [
    "ContiguousRelabel",
    "FrequencyPartitioner",
    "PartitionerBase",
    "RandomPartitioner",
    "cat_feature_cache",
    "contiguous_relabel",
    "load_partition",
    "relabel_rows",
    "relabel_topology",
    "residency_scores",
]
