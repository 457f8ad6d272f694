"""Flat byte serialization of a ``SampleMessage`` (``Dict[str,
np.ndarray]``), cf. ``glt_tpu/channel/serialization.py``: the same layout
and dtype codes, so both packages read each other's bytes.

    | u32 tensor_num |
    per tensor: | u32 key_len | key | u32 dtype_code | u32 ndim |
                | u64 shape[ndim] | u64 data_len | data |

``glt_tpu``'s codes have no ``uint16``, the dtype in which the port
carries bf16 rows (:mod:`..distributed.sample_message`).  A message with
``uint16`` arrays sends their bytes under ``int16``'s code and names
them in one more entry, ``#UINT16`` (the keys, NUL-separated, as
``uint8``); :func:`deserialize` views them back as ``uint16`` and drops
the entry, so every array, a real ``int16`` one included, returns with
its own dtype.  A message without ``uint16`` arrays gives ``glt_tpu``'s
bytes.
"""
from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_DTYPES = [np.dtype(x) for x in (
    "float32", "float64", "int32", "int64", "int16", "int8", "uint8",
    "bool", "float16")]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}
_UINT16 = "#UINT16"


def _tagged(msg: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``msg`` with its ``uint16`` arrays as ``int16`` and named under
    ``#UINT16`` (``msg`` itself when it has none)."""
    keys = [k for k, v in msg.items() if np.asarray(v).dtype == np.uint16]
    if not keys:
        return msg
    if _UINT16 in msg:
        raise ValueError(f"{_UINT16!r} is the serializer's own key")
    out = {k: (np.asarray(v).view(np.int16) if k in keys else v)
           for k, v in msg.items()}
    out[_UINT16] = np.frombuffer("\0".join(keys).encode(), np.uint8)
    return out


def serialized_size(msg: Dict[str, np.ndarray]) -> int:
    """``len(serialize(msg))`` without building the bytes.  A 0-d array
    travels as shape ``(1,)`` (``np.ascontiguousarray`` makes it 1-d),
    which this counts; ``glt_tpu``'s count misses those 8 bytes."""
    total = 4
    for k, v in _tagged(msg).items():
        v = np.asarray(v)
        total += 4 + len(k.encode()) + 4 + 4 + 8 * max(v.ndim, 1) + 8 \
            + v.nbytes
    return total


def serialize(msg: Dict[str, np.ndarray]) -> bytes:
    msg = _tagged(msg)
    parts = [struct.pack("<I", len(msg))]
    for k, v in msg.items():
        v = np.ascontiguousarray(np.asarray(v))
        if v.dtype not in _DTYPE_CODE:
            raise TypeError(f"unsupported dtype {v.dtype} for key {k!r}")
        kb = k.encode()
        parts.append(struct.pack("<I", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<II", _DTYPE_CODE[v.dtype], v.ndim))
        parts.append(struct.pack(f"<{v.ndim}Q", *v.shape))
        parts.append(struct.pack("<Q", v.nbytes))
        parts.append(v.tobytes())
    return b"".join(parts)


def deserialize(buf: memoryview) -> Dict[str, np.ndarray]:
    buf = memoryview(buf)
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out: Dict[str, np.ndarray] = {}
    for _ in range(n):
        (klen,) = struct.unpack_from("<I", buf, off)
        off += 4
        key = bytes(buf[off: off + klen]).decode()
        off += klen
        code, ndim = struct.unpack_from("<II", buf, off)
        off += 8
        shape = struct.unpack_from(f"<{ndim}Q", buf, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        out[key] = np.frombuffer(buf[off: off + nbytes],
                                 dtype=_DTYPES[code]).reshape(shape).copy()
        off += nbytes
    if _UINT16 in out:
        for k in out.pop(_UINT16).tobytes().decode().split("\0"):
            out[k] = out[k].view(np.uint16)
    return out
