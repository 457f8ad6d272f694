from .transform import Batch

__all__ = ["Batch"]
