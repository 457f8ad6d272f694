"""Compressed row codecs for the feature tiers: bf16 and per-column int8
(cf. ``glt_tpu/store/quant.py``).

* ``bf16`` — each value rounded to its nearest bfloat16; decode widens
  back to f32.  numpy has no bfloat16, so on the host a bf16 row is
  carried as its raw 16-bit patterns (``np.uint16``, the same bytes
  ``ml_dtypes.bfloat16`` stores) and viewed as ``torch.bfloat16`` on the
  device.  The rounding is torch's round-to-nearest-even, which gives
  ``ml_dtypes``' bits for every finite value, ±0 and ±inf; a NaN encodes
  as ``ml_dtypes`` encodes it, its sign over the quiet NaN ``0x7fc0``.
* ``int8`` — per-column affine codes ``q = clip(rint((x - zero) /
  scale), -127, 127)``, with ``scale = (cmax - cmin) / 253`` computed in
  float64 and ``zero`` the column midpoint snapped to ``k * scale`` for
  an integer ``k``.  The calibration is ``glt_tpu``'s, line for line, so
  the same matrix gives the same ``scale``, ``zero``, ``k`` and codes bit
  for bit.

Decode has one formula per codec, shared by the host mirror
(:func:`decode`), the device formula (:func:`dequantize`) and the CUDA
kernels (``csrc/dequant.cuh``):

* widen (bf16): a plain cast to f32 (never ``x * 1 + 0``, which turns
  ``-0.0`` into ``+0.0``);
* affine (int8): ``where(scale > 0, (float(q) + k) * scale, zero)``.

Add-then-multiply by design: ``q * scale + zero`` can be contracted into
one fused multiply-add by a compiler in some contexts and not others,
and ``(a + b) * c`` cannot, so every rounding step is forced and every
implementation agrees bit for bit.  ``dequantize(0)`` for int8 is
``zero``, not 0: padding rows are zeroed after the decode everywhere.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: Supported row codecs. "raw" is the identity (storage dtype == logical
#: dtype); the compressed codecs always decode to float32.
CODECS = ("raw", "bf16", "int8")

_QMAX = 127.0
_QLEVELS = 253.0
# |k| cap keeping q + k exact in f32.
_KMAX = float(2 ** 23)
# Host dtype of bf16 rows: their raw bit patterns.
BF16_HOST_DTYPE = np.dtype(np.uint16)


class QuantSpec(NamedTuple):
    """Everything needed to decode one store's rows.

    ``scale``/``zero`` are ``[dim]`` float32 vectors for ``int8`` and
    ``None`` otherwise.  ``logical_dtype`` is what decode produces
    (always float32 for the compressed codecs).
    """

    codec: str
    logical_dtype: np.dtype
    scale: Optional[np.ndarray] = None
    zero: Optional[np.ndarray] = None

    @property
    def is_compressed(self) -> bool:
        return self.codec != "raw"


def storage_dtype(codec: str, logical_dtype) -> np.dtype:
    """The host (on-disk) element dtype for ``codec``: bf16 rows are
    ``np.uint16`` bit patterns."""
    if codec == "raw":
        return np.dtype(logical_dtype)
    if codec == "bf16":
        return BF16_HOST_DTYPE
    if codec == "int8":
        return np.dtype(np.int8)
    raise ValueError(f"unknown feature codec {codec!r}; expected {CODECS}")


def raw_spec(logical_dtype) -> QuantSpec:
    return QuantSpec("raw", np.dtype(logical_dtype))


def bf16_bits(array: np.ndarray) -> np.ndarray:
    """Round ``array`` to bfloat16 (nearest even) as ``np.uint16`` bits,
    equal to ``array.astype(ml_dtypes.bfloat16).view(np.uint16)``."""
    a = np.ascontiguousarray(array)
    if a.dtype.kind != "f":
        a = a.astype(np.float32)
    elif not a.flags.writeable:         # torch.from_numpy warns on these
        a = a.copy()
    bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy()
    bits = bits.view(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        sign = np.signbit(a).astype(np.uint16) << np.uint16(15)
        bits = np.where(nan, sign | np.uint16(0x7FC0), bits).astype(
            np.uint16)
    return bits


def bf16_widen(bits: np.ndarray) -> np.ndarray:
    """``np.uint16`` bf16 bit patterns widened exactly to float32."""
    b = np.asarray(bits, np.uint16)
    return (b.astype(np.uint32) << np.uint32(16)).view(np.float32)


def encode(array: np.ndarray, codec: str) -> tuple:
    """Encode ``array`` (``[N, d]`` float) under ``codec``.

    Returns ``(encoded, spec)`` where ``encoded`` has the storage dtype
    and ``spec`` is the :class:`QuantSpec` that decodes it.
    """
    array = np.asarray(array)
    if codec == "raw":
        return array, raw_spec(array.dtype)
    if codec == "bf16":
        return bf16_bits(array), QuantSpec("bf16", np.dtype(np.float32))
    if codec == "int8":
        spec = calibrate_int8(array)
        return quantize_int8(array, spec), spec
    raise ValueError(f"unknown feature codec {codec!r}; expected {CODECS}")


def calibrate_int8(array: np.ndarray) -> QuantSpec:
    """Per-column affine parameters over the full matrix, in float64."""
    a = np.asarray(array, np.float64)
    if a.size == 0:
        d = a.shape[1] if a.ndim == 2 else 0
        return QuantSpec("int8", np.dtype(np.float32),
                         np.zeros(d, np.float32), np.zeros(d, np.float32))
    cmin = a.min(axis=0)
    cmax = a.max(axis=0)
    scale = ((cmax - cmin) / _QLEVELS).astype(np.float32)
    s64 = scale.astype(np.float64)
    mid = (cmax + cmin) / 2.0
    k = np.where(s64 > 0.0, np.rint(mid / np.where(s64 > 0.0, s64, 1.0)),
                 0.0)
    k = np.clip(k, -_KMAX, _KMAX)
    # k * s64 is exact in f64 (|k| <= 2^23, s has 24 significant bits);
    # the f32 cast is the single rounding decode reproduces.
    zero = np.where(s64 > 0.0, (k * s64).astype(np.float32),
                    mid.astype(np.float32))
    return QuantSpec("int8", np.dtype(np.float32),
                     scale, zero.astype(np.float32))


def zero_point(spec: QuantSpec) -> np.ndarray:
    """The integer-valued f32 ``k`` with ``zero == k * scale`` per column,
    recovered from the manifest pair by one correctly rounded division."""
    scale = np.asarray(spec.scale, np.float64)
    zero = np.asarray(spec.zero, np.float64)
    safe = np.where(scale > 0.0, scale, 1.0)
    k = np.where(scale > 0.0, np.rint(zero / safe), 0.0)
    return np.clip(k, -_KMAX, _KMAX).astype(np.float32)


def quantize_int8(array: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """``[N, d]`` float -> int8 codes under ``spec`` (host-side)."""
    a = np.asarray(array, np.float64)
    scale = np.asarray(spec.scale, np.float64)
    zero = np.asarray(spec.zero, np.float64)
    # Constant columns (scale == 0) always encode to 0 (decode == zero).
    safe = np.where(scale > 0.0, scale, 1.0)
    q = np.rint((a - zero) / safe)
    q = np.where(scale > 0.0, q, 0.0)
    return np.clip(q, -_QMAX, _QMAX).astype(np.int8)


def encode_with_spec(rows: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Encode ``rows`` under an already-fixed ``spec`` (streaming writes)."""
    rows = np.asarray(rows)
    if spec.codec == "raw":
        return np.ascontiguousarray(rows, spec.logical_dtype)
    if spec.codec == "bf16":
        return bf16_bits(rows)
    if spec.codec == "int8":
        return quantize_int8(rows, spec)
    raise ValueError(f"unknown feature codec {spec.codec!r}")


def decode(encoded: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Host-side decode — the numpy mirror of :func:`dequantize`."""
    if spec.codec == "raw":
        return np.asarray(encoded)
    if spec.codec == "bf16":
        return bf16_widen(encoded)
    if spec.codec == "int8":
        scale = np.asarray(spec.scale, np.float32)
        zero = np.asarray(spec.zero, np.float32)
        k = zero_point(spec)
        wide = (np.asarray(encoded).astype(np.float32) + k) * scale
        return np.where(scale > 0.0, wide, zero)
    raise ValueError(f"unknown feature codec {spec.codec!r}")


#: Rows of the packed scale/zero/k kernel input.
SCALE_ZERO_ROWS = 8


def scale_zero_rows(spec: QuantSpec, dim: int) -> np.ndarray:
    """``[8, dim]`` f32 kernel input: row 0 = scale, row 1 = zero, row 2
    = the integer zero point ``k`` (:func:`zero_point`); for the widen
    codec (1, 0, 0), so one signature serves both codecs."""
    out = np.zeros((SCALE_ZERO_ROWS, dim), np.float32)
    if spec.codec == "int8":
        out[0, :] = np.asarray(spec.scale, np.float32)
        out[1, :] = np.asarray(spec.zero, np.float32)
        out[2, :] = zero_point(spec)
    else:
        out[0, :] = 1.0
    return out


# [8, d] floats per spec, never dropped: a captured CUDA graph reads
# the tensor it saw at capture.
_SZ_CACHE: Dict[Tuple, torch.Tensor] = {}


def scale_zero_tensor(spec: QuantSpec, dim: int, device) -> torch.Tensor:
    """:func:`scale_zero_rows` as a tensor on ``device``, made once per
    spec content and device (a gather must not copy it to the card on
    every call)."""
    dev = torch.device(device)
    key = (spec.codec, int(dim), str(dev),
           None if spec.scale is None
           else np.asarray(spec.scale, np.float32).tobytes(),
           None if spec.zero is None
           else np.asarray(spec.zero, np.float32).tobytes())
    t = _SZ_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(scale_zero_rows(spec, dim)).to(dev)
        _SZ_CACHE[key] = t
    return t


def dequantize_rows(x: torch.Tensor, sz: torch.Tensor) -> torch.Tensor:
    """THE device decode formula on a ``[B, d]`` tensor of codes, with the
    ``[8, d]`` :func:`scale_zero_rows` input ``sz`` on the same device:
    a bf16 tensor widens, an int8 tensor decodes affinely.  It is the
    plain version of the CUDA kernels' epilogue (``csrc/dequant.cuh``)."""
    if x.dtype == torch.bfloat16:
        return x.float()
    if x.dtype == torch.int8:
        scale, zero, k = sz[0], sz[1], sz[2]
        # Add-then-mul: every rounding is forced (module docstring).
        wide = (x.float() + k) * scale
        return torch.where(scale > 0.0, wide, zero)
    raise TypeError(f"compressed rows are int8 or bfloat16, got {x.dtype}")


def dequantize(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Decode device rows ``x`` (bf16 or int8 tensor) under ``spec``; the
    identity for a raw spec."""
    if spec.codec == "raw":
        return x
    if spec.codec not in CODECS:
        raise ValueError(f"unknown feature codec {spec.codec!r}")
    return dequantize_rows(x, scale_zero_tensor(spec, x.shape[-1],
                                                x.device))


def host_to_torch(rows: np.ndarray) -> torch.Tensor:
    """Host rows at storage width as a CPU tensor sharing their memory:
    ``np.uint16`` bf16 patterns become a ``torch.bfloat16`` view."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype == BF16_HOST_DTYPE:
        return torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(rows)


def torch_dtype_of(np_dtype) -> torch.dtype:
    """The torch dtype of host rows of ``np_dtype`` (``uint16`` → bf16)."""
    dt = np.dtype(np_dtype)
    if dt == BF16_HOST_DTYPE:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dt)).dtype


def spec_to_manifest(spec: QuantSpec) -> dict:
    """Manifest fragment for a compressed store (empty for raw)."""
    if spec.codec == "raw":
        return {}
    out = {"codec": spec.codec}
    if spec.codec == "int8":
        out["quant"] = {
            "scale": [float(v) for v in np.asarray(spec.scale)],
            "zero": [float(v) for v in np.asarray(spec.zero)],
        }
    return out


def spec_from_manifest(man: dict) -> QuantSpec:
    """Decode spec from a store manifest (handles legacy raw manifests)."""
    codec = man.get("codec", "raw")
    logical = np.dtype(man["dtype"])
    if codec == "raw":
        return QuantSpec("raw", logical)
    if codec == "bf16":
        return QuantSpec("bf16", logical)
    if codec == "int8":
        q = man.get("quant") or {}
        return QuantSpec(
            "int8", logical,
            np.asarray(q.get("scale", []), np.float32),
            np.asarray(q.get("zero", []), np.float32))
    raise ValueError(f"unknown feature codec {codec!r} in manifest")
