"""glt_tpu_torch.serving — the coalesced ego-subgraph engine.

  errors     BadRequest and its base ServingError
  options    ServingOptions — coalescing policy + admission bounds
  engine     SubgraphEngine — bucketed device passes + per-request split

The admission front, client, router and fleet are later work.
"""
from .engine import CoalescedSample, SubgraphEngine
from .errors import BadRequest, ServingError
from .options import ServingOptions

__all__ = ["BadRequest", "CoalescedSample", "ServingError",
           "ServingOptions", "SubgraphEngine"]
