"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  A CUDA request without a CUDA device raises; the
    port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "glt_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether ``a`` and ``b`` name one device (``"cuda"`` is the
    current CUDA device, so it equals ``"cuda:0"`` there)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (
        cur if b.index is None else b.index)
