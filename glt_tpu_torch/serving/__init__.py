"""glt_tpu_torch.serving — the coalesced ego-subgraph engine.

  errors     the structured errors and their wire codes
  options    ServingOptions — coalescing policy + admission bounds
  engine     SubgraphEngine — bucketed device passes + per-request split

The admission front, client, router and fleet are later work.
"""
from .engine import CoalescedSample, SubgraphEngine
from .errors import (
    SERVING_CODES,
    BadRequest,
    DeadlineExceeded,
    NoHealthyReplica,
    Overloaded,
    ServingDisabled,
    ServingDown,
    ServingError,
    ServingTimeout,
    error_from_response,
)
from .options import ServingOptions

__all__ = ["SERVING_CODES", "BadRequest", "CoalescedSample",
           "DeadlineExceeded", "NoHealthyReplica", "Overloaded",
           "ServingDisabled", "ServingDown", "ServingError",
           "ServingOptions", "ServingTimeout", "SubgraphEngine",
           "error_from_response"]
