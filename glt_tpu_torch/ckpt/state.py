"""Snapshots of numpy ``Generator`` streams (cf.
``glt_tpu/ckpt/state.py``: ``capture_rng``, ``restore_rng``,
``load_rng``).

A bit generator's state dict is JSON-able (Python ints carry the 128-bit
PCG64 state exactly), and restoring it continues the identical stream:
the property a loader's resume rests on.  The snapshot format is
``glt_tpu``'s, so a snapshot taken by either package restores in the
other.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

_RNG_KIND = "np_generator"


class CheckpointError(RuntimeError):
    """A snapshot is malformed or of another kind."""


def _jsonify(obj: Any) -> Any:
    """Make a bit-generator state JSON-safe while keeping exact values
    (numpy scalars become Python ints)."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _state(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    if snapshot.get("kind") != _RNG_KIND:
        raise CheckpointError(
            f"snapshot kind {snapshot.get('kind')!r} is not a Generator")
    return snapshot["state"]


def capture_rng(rng: np.random.Generator) -> Dict[str, Any]:
    """Snapshot a numpy Generator (a loader's shuffle stream)."""
    return {"kind": _RNG_KIND, "state": _jsonify(rng.bit_generator.state)}


def restore_rng(snapshot: Dict[str, Any]) -> np.random.Generator:
    """A fresh Generator continuing the captured stream."""
    state = _state(snapshot)
    name = state.get("bit_generator", "PCG64")
    cls = getattr(np.random, name, None)
    if cls is None:
        raise CheckpointError(f"unknown bit generator {name!r}")
    bg = cls()
    bg.state = state
    return np.random.Generator(bg)


def load_rng(rng: np.random.Generator, snapshot: Dict[str, Any]) -> None:
    """Restore a captured stream INTO an existing Generator (in place),
    for objects that hold their rng privately (the loaders)."""
    rng.bit_generator.state = _state(snapshot)
