"""Serving configuration: the coalescing policy (cf.
``glt_tpu/serving/options.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class ServingOptions:
    """Policy knobs of the serving engine (the fields of
    ``glt_tpu.serving.ServingOptions`` that the engine reads; the
    admission front's knobs come with the front).

    Attributes:
      num_neighbors: per-hop fanouts of the shared serving sampler.
      seed_buckets: ascending padded seed-vector widths; a micro-batch is
        padded to the smallest bucket holding its total seed count, so
        the device sees one shape per bucket.
      max_seeds_per_request: per-request seed-set bound; larger requests
        are rejected ``bad_request``.
      with_features / with_labels: gather node features/labels into the
        response (one shared gather per micro-batch).
      with_edge: include global edge ids in responses.
      frontier_cap: optional per-hop frontier cap for the sampler.
      seed: base RNG seed for the serving samplers.
    """

    num_neighbors: Sequence[int] = (10, 5)
    seed_buckets: Tuple[int, ...] = (8, 32, 128)
    max_seeds_per_request: int = 100
    with_features: bool = True
    with_labels: bool = True
    with_edge: bool = True
    frontier_cap: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        buckets = tuple(sorted(int(b) for b in self.seed_buckets))
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"seed_buckets must be positive, got "
                             f"{self.seed_buckets!r}")
        self.seed_buckets = buckets
        if int(self.max_seeds_per_request) > buckets[-1]:
            raise ValueError(
                f"max_seeds_per_request {self.max_seeds_per_request} "
                f"exceeds the largest seed bucket {buckets[-1]}: a "
                f"single admissible request must fit one micro-batch")
