"""glt_tpu_torch.distributed — the server-client and worker-mode
deployments (cf. ``glt_tpu/distributed``; the same exports).

  dist_options            Collocated / Mp / RemoteSamplingWorkerOptions
  dist_context            process roles (worker, server, client)
  dist_sampling_producer  MpSamplingProducer: spawned sampling workers
  dist_loader             DistNeighborLoader and kin, three modes
  dist_server             DistServer / init_server: the sampling service
  dist_client             RemoteServerConnection, RemoteNeighborLoader
  supervisor              heartbeats, deadlines, structured exit
  dist_dataset            DistDataset: partitions loaded onto a mesh
  sample_message          batches <-> flat messages
"""
from .dist_options import (
    CollocatedSamplingWorkerOptions,
    MpSamplingWorkerOptions,
    RemoteSamplingWorkerOptions,
)
from .dist_context import (
    DistContext,
    DistRole,
    get_context,
    init_client_context,
    init_server_context,
    init_worker_group,
)
from .dist_client import (
    RemoteNeighborLoader,
    RemoteServerConnection,
    UnknownProducerError,
)
from .dist_dataset import DistDataset
from .dist_loader import (
    DistHeteroNeighborLoader,
    DistLinkNeighborLoader,
    DistNeighborLoader,
    DistSubGraphLoader,
)
from .dist_server import DistServer, ProtocolError, init_server
from .sample_message import (
    SampleMessage,
    batch_to_message,
    hetero_batch_to_message,
    message_to_batch,
    message_to_hetero_batch,
)

__all__ = [
    "CollocatedSamplingWorkerOptions",
    "DistContext",
    "DistDataset",
    "DistHeteroNeighborLoader",
    "DistRole",
    "DistServer",
    "get_context",
    "init_client_context",
    "init_server",
    "init_server_context",
    "init_worker_group",
    "DistLinkNeighborLoader",
    "DistNeighborLoader",
    "DistSubGraphLoader",
    "MpSamplingWorkerOptions",
    "ProtocolError",
    "RemoteNeighborLoader",
    "RemoteSamplingWorkerOptions",
    "RemoteServerConnection",
    "SampleMessage",
    "UnknownProducerError",
    "batch_to_message",
    "hetero_batch_to_message",
    "message_to_batch",
    "message_to_hetero_batch",
]
