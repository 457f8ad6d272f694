from .dist_dataset import DistDataset
from .sample_message import (
    SampleMessage,
    hetero_batch_to_message,
    message_to_batch,
    message_to_hetero_batch,
)

__all__ = ["DistDataset", "SampleMessage", "hetero_batch_to_message",
           "message_to_batch", "message_to_hetero_batch"]
