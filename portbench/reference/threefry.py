"""``jax.random``'s threefry2x32 keys and bits, frozen for the reference.

The program's dropout is specified as ``jax.random.bernoulli`` under
``fold_in(PRNGKey(seed), step)``, and its neighbour draw as
``jax.random.randint`` under split keys (threefry2x32, the partitionable
layout, 64-bit mode off).  This is that specification written out in
plain torch, independent of the program: uint32 words held in int64
tensors and masked to 32 bits.  The benchmark also makes every key it
hands the program here.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of ``(x0, x1)`` under ``(k0, k1)``
    (all broadcastable int64 tensors of uint32 values)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)`` for a seed in the int32 range: ``[0, seed]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], zero, zero + (int(data) & M32))
    return torch.stack([a, b])


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``[num, 2]`` keys; row ``i`` is also ``fold_in(key, i)``."""
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(ctr), ctr)
    return torch.stack([a, b], dim=-1)


def bits32(key: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Elements ``[start, start + count)`` of ``random_bits(key, 32,
    shape)`` in row-major order (below 2**32 elements)."""
    ctr = torch.arange(start, start + count, dtype=torch.int64,
                       device=key.device)
    a, b = threefry2x32(key[0], key[1], torch.zeros_like(ctr), ctr)
    return a ^ b


def randint(key: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """Element ``j`` of ``randint(key, (n,), 0, span)``, for a span per
    element (int64, each in ``[1, 2**31)``): the higher and lower words
    from ``split(key)``, reduced by jax's span trick in uint32
    arithmetic."""
    n = span.shape[0]
    kh, kl = split(key, 2)
    hi, lo = bits32(kh, 0, n), bits32(kl, 0, n)
    mult = (65536 % span) * (65536 % span) & M32
    mult = mult % span
    off = (((hi % span) * mult & M32) + lo % span) & M32
    return off % span


def bernoulli_rows(key: torch.Tensor, p: float, rows: int, width: int,
                   chunk: int = 1 << 24) -> torch.Tensor:
    """The first ``rows`` rows of ``bernoulli(key, p, (R, width))`` for
    any ``R >= rows``: ``uniform < p`` in float32, the uniform being
    ``(bits >> 9 | 0x3F800000)`` read as a float, minus 1."""
    n = rows * width
    out = torch.empty(n, dtype=torch.bool, device=key.device)
    p32 = torch.tensor(p, dtype=torch.float32, device=key.device)
    for lo in range(0, n, chunk):
        b = bits32(key, lo, min(chunk, n - lo))
        u = (((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
             - 1.0)
        out[lo: lo + b.shape[0]] = u < p32
    return out.reshape(rows, width)
