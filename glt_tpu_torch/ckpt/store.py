"""Durable on-disk checkpoint store: manifest + checksums, atomic publish
(cf. ``glt_tpu/ckpt/store.py``; one format for both packages).

A checkpoint is a DIRECTORY ``<root>/step_<N>/`` holding two files:

  * ``arrays.npz``    — every numpy array or tensor leaf of every component,
    keyed ``a0, a1, ...`` in capture order;
  * ``manifest.json`` — the JSON skeleton of the components (arrays
    replaced by ``{"__a__": i}`` markers), the step number, a format
    version, and the sha256 of ``arrays.npz``.

Publishing is atomic: the directory is fully written under a private ``.tmp-*`` name and published
with ONE ``os.replace`` — a process SIGKILLed mid-save leaves only a
``.tmp-*`` directory, which readers ignore and later writers sweep.  The
``LATEST`` pointer file is republished the same way, so "the newest
complete checkpoint" is always well-defined: either the old pointer or
the new one, never a torn in-between.  Torn *disk* state (a bit flipped
after publish) is caught by the checksum at read time
(:class:`CheckpointCorruptError`) — callers fall back to the previous
step (see :meth:`~glt_tpu_torch.ckpt.driver.Checkpointer.resume`).

Everything here is host-side stdlib + numpy; tensors are accepted and
copied to the host with ``.cpu()``, so the store can be read by
processes with no card at all (a resume orchestrator, a checkpoint
inspector).  A torch dtype that numpy lacks (``bfloat16``, the float8
types) is stored as its raw bytes (uint8) plus a ``"dtype"`` tag, as
``glt_tpu`` stores the ``ml_dtypes`` types, and reads back as a CPU
tensor of that dtype (``uint16`` bits viewed as ``torch.bfloat16``), so
a checkpoint written by either package reads bit-exact in the other.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1

_ARRAY_KEY = "__a__"
_STEP_RE = re.compile(r"^step_(\d{8})$")

#: numpy dtype kinds that round-trip through ``np.savez`` verbatim.
#: Anything else (bfloat16/fp8 tensors, or ``ml_dtypes`` arrays from
#: ``glt_tpu``) is stored as its raw bytes (uint8) plus a dtype tag in
#: the skeleton, which is bit-exact by construction.
_SAFE_KINDS = frozenset("biufc")


class CheckpointError(RuntimeError):
    """Checkpoint read/write failed (missing, malformed, incompatible)."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint file failed its manifest checksum: torn or bit-rotted
    on disk.  Resume falls back to the previous retained step."""


def _step_dirname(step: int) -> str:
    return f"step_{int(step):08d}"


#: torch dtypes numpy lacks, stored as raw bytes under their
#: ``ml_dtypes`` names (the tags ``glt_tpu`` writes).
_RAW_DTYPES = {torch.bfloat16: "bfloat16"}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _RAW_DTYPES[getattr(torch, _name)] = _name
_RAW_BY_NAME = {v: k for k, v in _RAW_DTYPES.items()}


def _tensor_leaf(t: torch.Tensor, arrays: List[np.ndarray]) -> dict:
    """A tensor copied to the host: numpy when numpy has its dtype, raw
    bytes + tag otherwise."""
    t = t.detach().cpu().contiguous()
    idx = len(arrays)
    tag = _RAW_DTYPES.get(t.dtype)
    if tag is None:
        arrays.append(t.numpy())
        return {_ARRAY_KEY: idx}
    arrays.append(t.reshape(-1).view(torch.uint8).numpy())
    return {_ARRAY_KEY: idx, "dtype": tag, "shape": list(t.shape)}


def _strip_arrays(obj: Any, arrays: List[np.ndarray]) -> Any:
    """Replace array leaves with ``{"__a__": i}`` markers, appending the
    arrays (bytes-encoded when their dtype is not npz-safe)."""
    if isinstance(obj, torch.Tensor):
        return _tensor_leaf(obj, arrays)
    if isinstance(obj, np.ndarray):
        idx = len(arrays)
        if obj.dtype.kind in _SAFE_KINDS or obj.dtype == np.bool_:
            arrays.append(obj)
            return {_ARRAY_KEY: idx}
        # Exotic dtype (bfloat16, float8_*): raw bytes + tag.
        arrays.append(np.frombuffer(obj.tobytes(), np.uint8))
        return {_ARRAY_KEY: idx, "dtype": str(obj.dtype),
                "shape": list(obj.shape)}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        if _ARRAY_KEY in obj:
            raise CheckpointError(
                f"component dicts may not use the reserved key "
                f"{_ARRAY_KEY!r}")
        return {str(k): _strip_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strip_arrays(v, arrays) for v in obj]
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    raise CheckpointError(
        f"unserializable checkpoint leaf of type {type(obj).__name__}; "
        f"capture it first (glt_tpu_torch.ckpt.state) or reduce it to "
        f"scalars/arrays")


def _fill_arrays(obj: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if _ARRAY_KEY in obj:
            arr = arrays[f"a{obj[_ARRAY_KEY]}"]
            if "dtype" in obj:
                dt = _RAW_BY_NAME.get(obj["dtype"])
                if dt is None:
                    raise CheckpointError(
                        f"no torch dtype for the stored tag "
                        f"{obj['dtype']!r}")
                raw = bytearray(arr.tobytes())
                arr = (torch.frombuffer(raw, dtype=dt) if raw
                       else torch.empty(0, dtype=dt)).reshape(obj["shape"])
            return arr
        return {k: _fill_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fill_arrays(v, arrays) for v in obj]
    return obj


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    # Directory fsync makes the rename itself durable; some filesystems
    # (and test tmpfs) refuse O_RDONLY dir fds — best-effort.
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def sweep_tmp(root: str) -> int:
    """Remove leftover ``.tmp-*`` directories of crashed writers.

    Only entries older than a minute are swept, so a concurrent writer's
    in-progress tmp dir is never pulled out from under it.  Returns the
    number removed.
    """
    removed = 0
    now = time.time()
    try:
        entries = os.listdir(root)
    except OSError:
        return 0
    for name in entries:
        if not name.startswith(".tmp-"):
            continue
        p = os.path.join(root, name)
        try:
            if now - os.path.getmtime(p) > 60.0:
                shutil.rmtree(p, ignore_errors=True)
                removed += 1
        except OSError:
            pass
    return removed


def write_checkpoint(root: str, step: int,
                     components: Dict[str, Any],
                     extras: Optional[Dict[str, Any]] = None) -> str:
    """Write one checkpoint atomically; returns the published directory.

    ``components``: name -> captured state (nested dicts/lists of JSON
    scalars, numpy arrays and tensors — see
    :mod:`glt_tpu_torch.ckpt.state`).
    ``extras``: small JSON-only metadata recorded in the manifest (e.g.
    the supervisor's structured exit reason).
    """
    os.makedirs(root, exist_ok=True)
    sweep_tmp(root)
    arrays: List[np.ndarray] = []
    skeleton = {name: _strip_arrays(comp, arrays)
                for name, comp in components.items()}
    final = os.path.join(root, _step_dirname(step))
    tmp = os.path.join(root, f".tmp-{_step_dirname(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path, **{f"a{i}": a for i, a in enumerate(arrays)})
        manifest = {
            "format": FORMAT_VERSION,
            "step": int(step),
            "components": skeleton,
            "files": {"arrays.npz": _sha256(arrays_path)},
            "written_unix": time.time(),
        }
        if extras:
            manifest["extras"] = extras
        man_path = os.path.join(tmp, "manifest.json")
        with open(man_path, "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        # Publish: one rename.  A pre-existing dir for this step (a rerun
        # over the same root) is moved aside first, then dropped — at no
        # point is the step name bound to a partially-written directory.
        aside = None
        if os.path.exists(final):
            aside = os.path.join(root, f".tmp-old-{_step_dirname(step)}"
                                       f"-{os.getpid()}")
            shutil.rmtree(aside, ignore_errors=True)
            os.replace(final, aside)
        os.replace(tmp, final)
        _fsync_dir(root)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # LATEST pointer: same tmp + replace discipline (a one-line file).
    ptr_tmp = os.path.join(root, f".tmp-LATEST-{os.getpid()}")
    with open(ptr_tmp, "w") as fh:
        fh.write(_step_dirname(step) + "\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(ptr_tmp, os.path.join(root, "LATEST"))
    _fsync_dir(root)
    return final


def list_steps(root: str) -> List[int]:
    """Completed (published) checkpoint steps under ``root``, ascending."""
    try:
        entries = os.listdir(root)
    except OSError:
        return []
    steps = []
    for name in entries:
        m = _STEP_RE.match(name)
        if m and os.path.isfile(os.path.join(root, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Newest complete step — the LATEST pointer when it names a live
    directory, else the newest published step dir (pointer write lost)."""
    try:
        with open(os.path.join(root, "LATEST")) as fh:
            name = fh.read().strip()
        m = _STEP_RE.match(name)
        if m and os.path.isfile(os.path.join(root, name, "manifest.json")):
            return int(m.group(1))
    except OSError:
        pass
    steps = list_steps(root)
    return steps[-1] if steps else None


def read_checkpoint(root: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Load one checkpoint; returns ``(step, components, extras)``.

    ``step=None`` reads the latest.  Checksums are verified before any
    component is materialised — a torn/bit-rotted ``arrays.npz`` raises
    :class:`CheckpointCorruptError` (callers fall back a step).
    """
    if step is None:
        step = latest_step(root)
        if step is None:
            raise CheckpointError(f"no checkpoint under {root!r}")
    d = os.path.join(root, _step_dirname(step))
    try:
        with open(os.path.join(d, "manifest.json")) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"unreadable manifest in {d!r}: {e}") from e
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"checkpoint format {manifest.get('format')!r} in {d!r} "
            f"(this build reads format {FORMAT_VERSION})")
    arrays_path = os.path.join(d, "arrays.npz")
    want = manifest.get("files", {}).get("arrays.npz")
    if want is not None:
        got = _sha256(arrays_path)
        if got != want:
            raise CheckpointCorruptError(
                f"{arrays_path} checksum mismatch (manifest {want[:12]}.., "
                f"file {got[:12]}..): torn or corrupted checkpoint")
    with np.load(arrays_path) as npz:
        arrays = {k: npz[k] for k in npz.files}
    components = _fill_arrays(manifest["components"], arrays)
    return int(manifest["step"]), components, manifest.get("extras", {})


def prune(root: str, keep: int) -> List[int]:
    """Drop all but the newest ``keep`` published steps; returns removed.

    Never touches the step named by ``LATEST`` regardless of ``keep``.
    """
    steps = list_steps(root)
    latest = latest_step(root)
    doomed = [s for s in steps[:-keep] if keep > 0 and s != latest] \
        if len(steps) > keep else []
    for s in doomed:
        shutil.rmtree(os.path.join(root, _step_dirname(s)),
                      ignore_errors=True)
    return doomed
