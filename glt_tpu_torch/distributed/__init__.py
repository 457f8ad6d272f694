from .sample_message import SampleMessage, message_to_batch

__all__ = ["SampleMessage", "message_to_batch"]
