"""glt_tpu_torch.channel — moving sampled messages between processes
(cf. ``glt_tpu/channel``).

  serialization  the flat byte format of a ``SampleMessage`` (``glt_tpu``'s)
  base           ChannelBase, bounded_get / bounded_put, QueueSourceDied
  shm_channel    ShmChannel over the native shared-memory ring
  native         the ring's g++ build and ctypes bindings
"""
from .base import (
    ChannelBase,
    QueueSourceDied,
    SampleMessage,
    bounded_get,
    bounded_put,
)
from .serialization import deserialize, serialize, serialized_size
from .shm_channel import ShmChannel

__all__ = [
    "ChannelBase",
    "QueueSourceDied",
    "SampleMessage",
    "bounded_get",
    "bounded_put",
    "ShmChannel",
    "deserialize",
    "serialize",
    "serialized_size",
]
