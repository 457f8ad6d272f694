"""Counter-based threefry2x32 keys, bit-exact with ``jax.random``.

The sampler's draw is the bit-identity anchor of the port: with the same
key, ``glt_tpu`` and ``glt_tpu_torch`` pick the same neighbor positions,
so every sampler and serving test compares with ``==``.  This module
reproduces ``jax.random`` under its defaults (``threefry2x32``,
``jax_threefry_partitionable=True``, 64-bit mode off):

* a key is an ``int64`` tensor of shape ``[..., 2]`` holding two uint32
  words (JAX's legacy ``uint32[2]`` key); leading dimensions are a batch
  of independent keys, the way ``jax.vmap`` maps a key function;
* uint32 arithmetic runs in ``int64`` tensors masked with
  ``& 0xFFFFFFFF`` (torch has no full uint32 arithmetic);
* ``split`` and the random bits hash a 64-bit iota counter with
  ``threefry2x32`` (the partitionable layout), ``fold_in`` hashes
  ``(0, data)``, and ``randint`` draws two 32-bit words per value and
  reduces them with jax's span trick;
* ``uniform`` takes one 32-bit word per value and keeps its top 23
  bits as the mantissa of a float in [1, 2), as jax does, and
  ``bernoulli`` is ``uniform < p`` decided on those 23 bits;
* on a CUDA key, ``split`` and ``fold_in`` (and the random bits' hash)
  are one launch of the hash kernel (``csrc/threefry.cu``); the masked
  arithmetic is its plain version, which the CPU runs and
  ``plain=True`` asks for.  The sampler's draw on the card runs inside
  kernel B1 (``csrc/sample.cu``), on the same device code.

Random state is explicit: keys are tensors that callers create and pass.
No global torch generator is used.
"""
from __future__ import annotations

import math
import struct
from typing import Sequence, Tuple, Union

import torch

from .utils.device import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

IntOrTensor = Union[int, torch.Tensor]


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all arguments broadcast together and
    hold uint32 values in int64 tensors.  The rounds update two fresh
    words in place (a third of the allocations of the plain
    expressions, the same bits)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (t.contiguous() for t in torch.broadcast_tensors(
        (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32))
    rot = torch.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(_M32)
            # b = rotl(b, r) ^ a
            torch.bitwise_left_shift(b, r, out=rot)
            b.bitwise_right_shift_(32 - r).bitwise_or_(rot)
            b.bitwise_and_(_M32).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_M32)
    return a, b


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _iota_size(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise ValueError(f"random arrays of {n} >= 2**32 elements are "
                         f"not supported")
    return n


def _iota(shape: Tuple[int, ...], device) -> torch.Tensor:
    """Low word of the 64-bit row-major iota over ``shape`` (the high
    word is 0 below 2**32 elements)."""
    return torch.arange(_iota_size(shape), dtype=torch.int64,
                        device=device).reshape(shape)


Counters = Union[Tuple[int, ...], int, torch.Tensor]


def _hash(key: torch.Tensor, counters: Counters, plain: bool = False
          ) -> torch.Tensor:
    """threefry2x32 of ``(0, c)`` under every key of the batch
    ``key [*K, 2]``: ``[*K, *C, 2]`` words.  ``counters`` is a shape
    ``C`` (the 64-bit row-major iota over it), a Python int (one counter,
    ``C = ()``) or a tensor ``[*C]`` (its entries mod 2**32).

    A CUDA key goes through the hash kernel (``csrc/threefry.cu``, one
    launch); a CPU key, or ``plain=True``, through the arithmetic of
    :func:`threefry2x32` (the kernel's plain version)."""
    if isinstance(counters, tuple):
        cshape = counters
    elif isinstance(counters, torch.Tensor):
        cshape = tuple(counters.shape)
    else:
        cshape = ()
    if key.device.type == "cuda" and not plain:
        from .ops.threefry_cuda import threefry_hash_cuda

        keys = key.reshape(-1, 2).contiguous()
        if isinstance(counters, tuple):
            out = threefry_hash_cuda(keys, n=_iota_size(cshape))
        elif isinstance(counters, torch.Tensor):
            data = counters.reshape(-1)
            if data.dtype not in (torch.int32, torch.int64):
                data = data.to(torch.int64)
            out = threefry_hash_cuda(keys, data=data.contiguous())
        else:
            out = threefry_hash_cuda(keys, data=int(counters))
        return out.reshape(key.shape[:-1] + cshape + (2,))
    if isinstance(counters, tuple):
        lo = _iota(cshape, key.device)
    elif isinstance(counters, torch.Tensor):
        lo = counters.to(torch.int64) & _M32
    else:
        lo = torch.tensor(int(counters) & _M32, dtype=torch.int64,
                          device=key.device)
    view = key.shape[:-1] + (1,) * lo.dim()
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    a, b = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """Key for an integer ``seed`` (``jax.random.PRNGKey``) on ``device``
    (default ``"cuda"``): the words ``(seed >> 32, seed & 0xFFFFFFFF)``
    of the seed as an int32, so ``(0, seed mod 2**32)`` for every seed
    in the int32 range."""
    seed = int(seed)
    if not _I32_MIN <= seed <= _I32_MAX:
        raise OverflowError(f"seed {seed} does not fit int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2, *,
          plain: bool = False) -> torch.Tensor:
    """``jax.random.split``: ``[*K, 2]`` keys -> ``[*K, *num, 2]``.  One
    kernel launch for a CUDA key (``plain=True``: the plain version)."""
    return _hash(key, _shape(num), plain)


def fold_in(key: torch.Tensor, data: IntOrTensor, *,
            plain: bool = False) -> torch.Tensor:
    """``jax.random.fold_in``: hash ``(0, data mod 2**32)`` under
    ``key``.  A tensor ``data [*D]`` folds every entry into the same
    key (``jax.vmap(fold_in, (None, 0))``) and gives ``[*D, 2]``.  One
    kernel launch for a CUDA key, a Python int passed by value
    (``plain=True``: the plain version)."""
    if not isinstance(data, torch.Tensor):
        data = int(data)
    return _hash(key, data, plain)


def _random_bits(key: torch.Tensor, shape: Tuple[int, ...],
                 plain: bool = False) -> torch.Tensor:
    h = _hash(key, shape, plain)
    return h[..., 0] ^ h[..., 1]


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 words, in 16-bit halves so no
    partial product leaves int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _M32


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return ((x - _I32_MIN) & _M32) + _I32_MIN


def _device_scalar(v: IntOrTensor, dtype: torch.dtype,
                   dev: torch.device) -> torch.Tensor:
    """``v`` as a ``dtype`` tensor on ``dev``: a tensor is cast there, a
    Python number becomes a device fill (no host->device copy, so a CUDA
    graph can capture it; the fill rounds as ``torch.tensor`` does)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=dtype)
    if getattr(v, "ndim", 0):          # a host array of bounds
        return torch.as_tensor(v, dtype=dtype, device=dev)
    return torch.full((), v, dtype=dtype, device=dev)


def randint(key: torch.Tensor, shape: Union[int, Sequence[int]],
            minval: IntOrTensor, maxval: IntOrTensor, *,
            plain: bool = False) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    ``key`` may be a batch ``[*K, 2]`` (``jax.vmap`` over keys); the
    result is then ``[*K, *shape]``.  ``minval``/``maxval`` broadcast
    against that result shape.  Like jax, the value is
    ``minval + (hi % span * (2**32 % span) + lo % span) % span`` over
    two 32-bit draws ``hi``, ``lo`` with uint32 wrap-around, and
    ``span = 1`` where ``maxval <= minval``.  ``plain=True`` keeps the
    hashes off the hash kernel too (the sampler's plain draw).
    """
    shape = _shape(shape)
    dev = key.device
    lo_v, hi_v = (_device_scalar(v, torch.int64, dev)
                  for v in (minval, maxval))
    out_of_range = hi_v > _I32_MAX
    lo_v = lo_v.clamp(_I32_MIN, _I32_MAX)
    hi_v = hi_v.clamp(_I32_MIN, _I32_MAX)

    k = split(key, 2, plain=plain)
    higher = _random_bits(k[..., 0, :], shape, plain)
    lower = _random_bits(k[..., 1, :], shape, plain)

    span = (hi_v - lo_v) & _M32
    span = torch.where(hi_v <= lo_v, torch.ones_like(span), span)
    span = torch.where(out_of_range & (hi_v > lo_v), (span + 1) & _M32, span)
    # span wraps to 0 only for the full 2**32 range; XLA's unsigned
    # remainder by 0 is the identity.
    zero = span == 0
    span_safe = torch.where(zero, torch.ones_like(span), span)

    def rem(x):
        return torch.where(zero, x, x % span_safe)

    mult = rem(torch.full_like(span, 1 << 16))
    mult = rem((mult * mult) & _M32)
    offset = (_mul32(rem(higher), mult) + rem(lower)) & _M32
    return _wrap_i32(lo_v + rem(offset)).to(torch.int32)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]] = (),
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    float32 ``(bits >> 9 | 0x3F800000) - 1.0`` in [0, 1) from one
    32-bit word per value, times ``maxval - minval`` plus ``minval`` in
    one rounding (XLA fuses the two into a multiply-add; the float32
    product is exact in float64), held at or above ``minval``.  ``key``
    may be a batch ``[*K, 2]``.  The bits are one hash-kernel launch for
    a CUDA key."""
    bits = _random_bits(key, _shape(shape))
    mant = (bits >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = _device_scalar(minval, torch.float32, key.device)
    span = _device_scalar(maxval, torch.float32, key.device) - lo
    scaled = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def bernoulli(key: torch.Tensor, p: float,
              shape: Union[int, Sequence[int]] = ()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform(key, shape) <
    p`` in float32, decided on the 23 mantissa bits, which are exact:
    ``uniform`` is ``(bits >> 9) / 2**23``, so the test is ``bits >> 9 <
    ceil(float32(p) * 2**23)``.  ``key`` may be a batch ``[*K, 2]``.
    One hash-kernel launch for a CUDA key and no host->device copy, so a
    CUDA graph can capture it."""
    p32 = struct.unpack("f", struct.pack("f", float(p)))[0]
    bound = math.ceil(p32 * (1 << 23))
    return (_random_bits(key, _shape(shape)) >> 9) < bound
