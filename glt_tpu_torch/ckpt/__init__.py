"""State capture for checkpoints (cf. ``glt_tpu/ckpt``): so far the
numpy ``Generator`` snapshots that the loaders' cursors are made of."""
from .state import CheckpointError, capture_rng, load_rng, restore_rng

__all__ = ["CheckpointError", "capture_rng", "load_rng", "restore_rng"]
