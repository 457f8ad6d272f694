"""Small array utilities shared across layers, cf.
``glt_tpu/utils/tensor.py``: dense inverse maps and conversions in
numpy, and :func:`ensure_device` for torch tensors on a named device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .device import DeviceLike, resolve_device

ArrayLike = Union[np.ndarray, torch.Tensor, Sequence[int]]


def id2idx(ids: ArrayLike, size: Optional[int] = None) -> np.ndarray:
    """Dense inverse map: ``out[ids[i]] = i``.

    Entries not present in ``ids`` map to 0, as the reference's
    zero-initialised map does; callers mask separately when absence
    matters.
    """
    ids = ensure_numpy(ids)
    if size is None:
        size = int(ids.max()) + 1 if ids.size else 0
    out = np.zeros(size, dtype=np.int64)
    out[ids] = np.arange(ids.shape[0], dtype=np.int64)
    return out


def ensure_numpy(x: ArrayLike) -> np.ndarray:
    """``x`` as a numpy array (a torch tensor is copied to the host)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ensure_device(x: ArrayLike, dtype=None,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """``x`` as a torch tensor on ``device`` (``"cuda"`` unless the
    caller names another; without a CUDA device that raises).  ``dtype``
    is a torch or numpy dtype, or ``None`` to keep ``x``'s."""
    dev = resolve_device(device)
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    """Right-pad (or truncate) the leading axis of ``x`` to ``size``."""
    n = x.shape[0]
    if n == size:
        return x
    if n > size:
        return x[:size]
    pad_shape = (size - n,) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, fill, dtype=x.dtype)], axis=0)


def next_power_of_two(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())
