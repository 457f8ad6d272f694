"""glt_tpu_torch.serving — low-latency multi-tenant subgraph serving (cf.
``glt_tpu/serving``).

Many concurrent clients each request ego-subgraphs for small seed sets
and get back the sampled batch (node ids, COO, edge ids, features).  A
coalescer packs outstanding requests into one fixed-shape device batch
(padding buckets: one captured CUDA graph each on the card), runs the
shared sample -> dedup -> gather once, and scatters the results back per
client; admission control bounds inflight work and rejects overload with
a structured ``Overloaded`` + retry-after instead of queueing without
bound.

  errors     the structured errors and their wire codes
  options    ServingOptions — coalescing policy + admission bounds
  engine     SubgraphEngine — bucketed device passes + per-request split
  front      ServingFront — admission queue + coalescing dispatcher
  client     InferenceClient — request client with per-op timeouts
  router     ShardTable + FleetRouter — partition-affinity routing,
             replica health, exactly-once failover
  fleet      FleetSpec + FleetController — fleet-wide SLO shed/reopen,
             merged postmortems on a replica's death

On the server, ``init_server(dataset, serving=ServingOptions(...))``;
the ``subgraph_request`` op and ``serving_stats`` share the framed
protocol of the training loaders.
"""
from .client import InferenceClient, retryable_transport
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
from .fleet import FleetController, FleetSpec, default_fleet_specs
from .front import ServingFront
from .options import ServingOptions
from .router import FleetRouter, ShardTable

__all__ = ["SERVING_CODES", "BadRequest", "CoalescedSample",
           "DeadlineExceeded", "FleetController", "FleetRouter",
           "FleetSpec", "InferenceClient", "NoHealthyReplica", "Overloaded",
           "ServingDisabled", "ServingDown", "ServingError", "ServingFront",
           "ServingOptions", "ServingTimeout", "ShardTable",
           "SubgraphEngine", "default_fleet_specs", "error_from_response",
           "retryable_transport"]
