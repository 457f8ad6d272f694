"""Key derivation on the card in one launch (``csrc/threefry.cu``).

``out[k, d] = threefry2x32(keys[k], (0, c_d))`` with ``c_d`` the iota
``0..n-1`` (``jax.random.split``, the random bits), the entries of a
tensor ``data`` mod 2**32 (``fold_in`` of a tensor), or one Python int
passed by value (``fold_in`` of an int: no host->device copy).

:func:`threefry_hash_cuda` launches the kernel and takes CUDA tensors
only; :func:`threefry_hash_plain` is the same function in the plain
arithmetic of :mod:`glt_tpu_torch.random`.  ``random.split`` and
``random.fold_in`` pick by the device the key lies on.  No Pallas kernel
stands behind this one: in ``glt_tpu``, XLA compiles ``jax.random``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .. import random as trandom
from . import cuda_lib

Data = Optional[Union[int, torch.Tensor]]
_M32 = 0xFFFFFFFF


def _counters(n: Optional[int], data: Data):
    if (n is None) == (data is None):
        raise ValueError("pass exactly one of n (an iota) and data")
    if n is not None:
        n = int(n)
        if not 0 <= n < 1 << 32:
            raise ValueError(f"iota length {n} is outside [0, 2**32)")
        return n
    return data if isinstance(data, torch.Tensor) else int(data)


def threefry_hash_plain(keys: torch.Tensor, n: Optional[int] = None,
                        data: Data = None) -> torch.Tensor:
    """``[K, D, 2]`` int64 words in plain PyTorch (any device)."""
    c = _counters(n, data)
    out = trandom._hash(keys, (c,) if n is not None else c, plain=True)
    return out.reshape(keys.shape[0], -1, 2)


def threefry_hash_cuda(keys: torch.Tensor, n: Optional[int] = None,
                       data: Data = None) -> torch.Tensor:
    """Launch the hash kernel on the current stream (no
    synchronisation): ``keys [K, 2]`` int64 and either ``n`` (iota
    counters, ``D = n``) or ``data`` (a 1-D int32/int64 tensor, ``D =
    len(data)``, or a Python int, ``D = 1``)."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"threefry_hash_cuda takes CUDA tensors, got keys "
                         f"on {dev}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be [K, 2], got {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    c = _counters(n, data)
    value, ptr = 0, None
    if isinstance(c, torch.Tensor):
        if c.device != dev:
            raise ValueError(f"data is on {c.device}, keys on {dev}")
        if c.dtype not in (torch.int64, torch.int32):
            raise TypeError(f"data must be int32 or int64, got {c.dtype}")
        if c.dim() != 1 or not c.is_contiguous():
            raise ValueError("data must be 1-D and contiguous")
        mode = 1 if c.dtype == torch.int64 else 2
        d, ptr = c.shape[0], c.data_ptr()
    elif n is not None:
        mode, d = 0, c
    else:
        mode, d, value = 3, 1, c & _M32
    k = keys.shape[0]
    out = torch.empty((k, d, 2), dtype=torch.int64, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.glt_threefry_hash(
            keys.data_ptr(), ptr, value, mode, k, d, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "threefry_hash_cuda")
    threefry_hash_cuda.launches += 1
    return out


threefry_hash_cuda.launches = 0
