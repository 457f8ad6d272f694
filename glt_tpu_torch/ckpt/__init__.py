"""glt_tpu_torch.ckpt — durable data-path checkpoints and resume (cf.
``glt_tpu/ckpt``; one store format for both packages).

Every stateful data-path component — the loader's epoch cursor and
shuffle rng, the ``FeatureCacheState``, the model and optimizer, the
threefry keys — captures to plain dicts of scalars and arrays,
serialized atomically (tmp + ``os.replace``, manifest + sha256) into a
checkpoint directory, and restores bit-exactly: a SIGKILLed run resumed
from its last checkpoint replays the remaining batch stream.

Layers (inner to outer):
  store   write_checkpoint/read_checkpoint/latest_step — atomic dirs
  state   capture/restore for tensor pytrees, train states, numpy
          Generators and threefry keys
  driver  Checkpointer (cadence/retention/resume) + TrainLoop (the
          preemption-safe scanned-epoch driver)
"""
from .driver import Checkpointer, Snapshot, TrainLoop
from .state import (
    capture_key,
    capture_pytree,
    capture_rng,
    capture_train_state,
    load_rng,
    restore_key,
    restore_pytree,
    restore_rng,
    restore_train_state,
)
from .store import (
    CheckpointCorruptError,
    CheckpointError,
    latest_step,
    list_steps,
    read_checkpoint,
    write_checkpoint,
)

__all__ = [
    "Checkpointer",
    "Snapshot",
    "TrainLoop",
    "CheckpointError",
    "CheckpointCorruptError",
    "write_checkpoint",
    "read_checkpoint",
    "latest_step",
    "list_steps",
    "capture_pytree",
    "restore_pytree",
    "capture_train_state",
    "restore_train_state",
    "capture_rng",
    "restore_rng",
    "load_rng",
    "capture_key",
    "restore_key",
]
