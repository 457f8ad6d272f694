"""Functional state capture: tensor pytrees, train states, numpy
Generators, threefry keys (cf. ``glt_tpu/ckpt/state.py``).

The capture protocol has two halves:

* **Stateful host objects** (loaders, the refresh driver) implement
  ``state_dict() -> dict`` / ``load_state_dict(d)`` directly, returning
  plain dicts of scalars and arrays.
* **Functional states** go through the free functions here:
  :func:`capture_pytree` / :func:`restore_pytree` for NamedTuples,
  tuples, lists and dicts of tensors (``FeatureCacheState``; its
  snapshot has ``glt_tpu``'s layout, so either package restores the
  other's), :func:`capture_train_state` / :func:`restore_train_state`
  for a :class:`~glt_tpu_torch.models.train.TrainState` (the model's
  and the optimizer's state dicts and the step),
  :func:`capture_key` / :func:`restore_key` for threefry keys, and
  :func:`capture_rng` / :func:`restore_rng` for numpy Generators.

Restores are **bit-exact**: tensors round-trip through host numpy (raw
bytes for bfloat16, see :mod:`glt_tpu_torch.ckpt.store`), and a
Generator restored from its captured bit-generator state continues the
identical stream.  Restores validate leaf count, shape and dtype
against a caller-supplied template, so a checkpoint from a different
model or config fails loudly instead of training on garbage.

Every capture is a SYNC POINT (device tensors are copied to the host):
call it at block boundaries, never inside a function a CUDA graph
captures.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from .store import CheckpointError

_PYTREE_KIND = "pytree"
_TRAIN_KIND = "torch_train_state"
_RNG_KIND = "np_generator"


# -- pytrees of tensors ------------------------------------------------------
def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util``'s order: NamedTuple
    and tuple fields in order, dict entries by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, np.generic):
        return leaf.item()
    if isinstance(leaf, (np.ndarray, bool, int, float, str)) or leaf is None:
        return leaf
    raise CheckpointError(
        f"pytree leaf of type {type(leaf).__name__} is not capturable")


def capture_pytree(tree: Any) -> Dict[str, Any]:
    """Snapshot a NamedTuple/tuple/list/dict tree of tensors, arrays and
    scalars (host copies; ``glt_tpu``'s snapshot layout)."""
    flat = _flatten(tree)
    return {"kind": _PYTREE_KIND,
            "leaves": [{"v": _host(leaf)} for _, leaf in flat],
            # Debugging aid only; restore validates against a template.
            "structure": type(tree).__name__}


def _restore_tensor(val: Any, tmpl: torch.Tensor, where: str
                    ) -> torch.Tensor:
    """``val`` (numpy, or a CPU tensor for a raw-bytes dtype such as
    bfloat16) as a tensor like ``tmpl`` (its shape, dtype and device),
    or CheckpointError."""
    t = val if isinstance(val, torch.Tensor) else torch.from_numpy(
        np.array(val))
    if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
        raise CheckpointError(
            f"leaf {where}: checkpoint {t.dtype}{list(t.shape)} vs "
            f"template {tmpl.dtype}{list(tmpl.shape)}")
    return t.to(tmpl.device)


def restore_pytree(snapshot: Dict[str, Any], like: Any) -> Any:
    """Rebuild a tree captured by :func:`capture_pytree` (or by
    ``glt_tpu``'s) with the structure of ``like``: tensor leaves come
    back as tensors on the template leaf's device, numpy leaves as
    numpy, Python scalars as their type.  Leaf count / shape / dtype
    mismatches raise :class:`~glt_tpu_torch.ckpt.store.CheckpointError`
    naming the leaf."""
    if snapshot.get("kind") != _PYTREE_KIND:
        raise CheckpointError(
            f"snapshot kind {snapshot.get('kind')!r} is not a pytree")
    flat = _flatten(like)
    saved = snapshot["leaves"]
    if len(saved) != len(flat):
        raise CheckpointError(
            f"checkpoint has {len(saved)} pytree leaves, template has "
            f"{len(flat)} — different model/optimizer config?")
    out = []
    for entry, (path, tmpl) in zip(saved, flat):
        val = entry["v"]
        if isinstance(tmpl, torch.Tensor):
            out.append(_restore_tensor(val, tmpl, path))
        elif isinstance(tmpl, np.ndarray):
            arr = np.asarray(val)
            if arr.shape != tmpl.shape or arr.dtype != tmpl.dtype:
                raise CheckpointError(
                    f"leaf {path}: checkpoint {arr.dtype}{list(arr.shape)}"
                    f" vs template {tmpl.dtype}{list(tmpl.shape)}")
            out.append(arr)
        elif isinstance(tmpl, (bool, int, float, str)) or tmpl is None:
            out.append(val if tmpl is None else type(tmpl)(val))
        else:
            raise CheckpointError(
                f"template leaf {path} of type {type(tmpl).__name__} is "
                f"not restorable")
    return _unflatten(like, out)


# -- train states ------------------------------------------------------------
def capture_train_state(state) -> Dict[str, Any]:
    """Snapshot a ``TrainState``: the model's state dict, the
    optimizer's (its per-parameter tensors and its param groups) and
    the step."""
    opt = state.optimizer.state_dict()
    return {
        "kind": _TRAIN_KIND,
        "model": {k: v.detach().cpu()
                  for k, v in state.model.state_dict().items()},
        "optimizer": {
            "state": {str(i): {k: (v.detach().cpu()
                                   if isinstance(v, torch.Tensor) else v)
                               for k, v in st.items()}
                      for i, st in opt["state"].items()},
            "param_groups": opt["param_groups"],
        },
        "step": int(state.step),
    }


def restore_train_state(snapshot: Dict[str, Any], like):
    """Restore a :func:`capture_train_state` snapshot INTO ``like``'s
    model and optimizer and return the ``TrainState`` at the saved step.

    The model's parameters are overwritten in place (``copy_`` into
    their storage).  The optimizer gets ``load_state_dict``, which makes
    new state tensors: a scanned step whose CUDA graph read the old ones
    runs its next block eagerly and captures again.  Each param group
    keeps the live optimizer's ``capturable`` flag, so on the card
    Adam's ``step`` stays a device tensor whatever device wrote the
    checkpoint.
    """
    if snapshot.get("kind") != _TRAIN_KIND:
        raise CheckpointError(
            f"snapshot kind {snapshot.get('kind')!r} is not a train state")
    model, opt = like.model, like.optimizer
    live = model.state_dict()
    saved = snapshot["model"]
    if sorted(saved) != sorted(live):
        raise CheckpointError(
            f"checkpoint model keys {sorted(saved)} vs template "
            f"{sorted(live)} — different model config?")
    model.load_state_dict({k: _restore_tensor(saved[k], v, f"model.{k}")
                           for k, v in live.items()})
    params = [p for g in opt.param_groups for p in g["params"]]
    groups = []
    for live_g, saved_g in zip(opt.param_groups,
                               snapshot["optimizer"]["param_groups"]):
        g = dict(saved_g)
        if "capturable" in live_g:
            g["capturable"] = live_g["capturable"]
        groups.append(g)
    state = {}
    for i, st in snapshot["optimizer"]["state"].items():
        i = int(i)
        if i >= len(params):
            raise CheckpointError(f"optimizer state for parameter {i}, the "
                                  f"template has {len(params)}")
        state[i] = {k: (torch.from_numpy(np.array(v))
                        if isinstance(v, np.ndarray) else v)
                    for k, v in st.items()}
    try:
        opt.load_state_dict({"state": state, "param_groups": groups})
    except (ValueError, KeyError) as exc:
        raise CheckpointError(f"optimizer state does not fit: {exc}") \
            from exc
    return type(like)(model, opt, int(snapshot["step"]))


# -- threefry keys -------------------------------------------------------------
def capture_key(key: torch.Tensor) -> np.ndarray:
    """A threefry key (``int64`` tensor holding uint32 words) as a host
    ``uint32`` array, ``glt_tpu``'s key format: ``fold_in``/``split``
    of the restored key reproduce exactly."""
    return key.detach().cpu().numpy().astype(np.uint32)


def restore_key(arr: Any, device: DeviceLike = None) -> torch.Tensor:
    """The key of :func:`capture_key` (or of ``glt_tpu``'s) as the
    port's ``int64`` key tensor on ``device`` (default ``"cuda"``; it
    raises without CUDA unless the caller asks for the CPU)."""
    k = torch.from_numpy(np.asarray(arr).astype(np.uint32).astype(np.int64))
    return k.to(resolve_device(device))


# -- numpy Generators ----------------------------------------------------------
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
