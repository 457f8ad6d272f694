"""Flat ``SampleMessage`` <-> batches (cf.
``glt_tpu/distributed/sample_message.py``).

A ``SampleMessage`` is a flat ``Dict[str, np.ndarray]``: everything a
batch carries, with ``#META.*`` scalar keys.  A heterogeneous message
is marked ``#HETERO`` and keys its per-type arrays ``field@type`` (an
edge type's parts joined by ``|``).  numpy has no bfloat16, so bf16
features travel as their raw 16-bit patterns in a ``uint16`` array (the
port stores no other 16-bit integer features); the wire keeps that
dtype (:mod:`glt_tpu_torch.channel.serialization`), so only a ``uint16``
``x`` is read as bf16.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..loader.transform import Batch, HeteroBatch
from ..utils.device import DeviceLike, resolve_device

SampleMessage = Dict[str, np.ndarray]

_META_BS = "#META.batch_size"
_HET = "#HETERO"
_ET_SEP = "|"


def _et_key(et) -> str:
    if any(_ET_SEP in part for part in et):
        raise ValueError(
            f"edge-type components must not contain {_ET_SEP!r} "
            f"(got {et!r}); rename the relation for channel transport")
    return _ET_SEP.join(et)


def _et_parse(s: str):
    a, b, c = s.split(_ET_SEP)
    return (a, b, c)


def _host(v) -> np.ndarray:
    """A tensor as a host array (bf16 as its uint16 bit patterns)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _converter(device: DeviceLike):
    dev = resolve_device(device)

    def conv(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    def conv_x(v):
        if v.dtype == np.uint16:
            return conv(v.view(np.int16)).view(torch.bfloat16)
        return conv(v)

    return conv, conv_x


def _meta(msg: SampleMessage, conv):
    return {k[len("#META."):]: conv(v) for k, v in msg.items()
            if k.startswith("#META.") and k != _META_BS} or None


_TORCH_TO_NP = {torch.float32: np.float32, torch.float64: np.float64,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.int16: np.int16, torch.int8: np.int8,
                torch.uint8: np.uint8, torch.bool: np.bool_,
                torch.float16: np.float16, torch.bfloat16: np.uint16}


def _to_host(named: List[Tuple[str, object]]) -> SampleMessage:
    """``named`` tensors as host arrays, the device ones through ONE
    device-to-host copy: their bytes are packed (8-byte aligned) into
    one flat buffer on the device, copied, and cut into numpy views of
    their dtypes (bf16 as its uint16 bit patterns)."""
    out: SampleMessage = {}
    dev = [(k, v) for k, v in named
           if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
    for k, v in named:
        if not (isinstance(v, torch.Tensor) and v.device.type != "cpu"):
            out[k] = _host(v)
    if dev:
        pieces, spans, off = [], [], 0
        for k, v in dev:
            b = v.detach().contiguous().reshape(-1).view(torch.uint8)
            pad = -b.numel() % 8
            pieces.append(b)
            if pad:
                pieces.append(b.new_zeros(pad))
            spans.append((k, v, off, b.numel()))
            off += b.numel() + pad
        flat = torch.cat(pieces).cpu().numpy()
        for k, v, o, n in spans:
            out[k] = flat[o:o + n].view(_TORCH_TO_NP[v.dtype]).reshape(
                tuple(v.shape))
    return {k: out[k] for k, _ in named}


def batch_to_message(batch: Batch) -> SampleMessage:
    """Flatten a :class:`Batch` into string-keyed host arrays, the keys
    of ``glt_tpu``'s ``batch_to_message``, with one device-to-host copy
    for all its device tensors."""
    named = [("node", batch.node), ("row", batch.edge_index[0]),
             ("col", batch.edge_index[1]), ("node_mask", batch.node_mask),
             ("edge_mask", batch.edge_mask),
             (_META_BS, np.array(batch.batch_size, np.int64))]
    for k, v in (("edge", batch.edge_id), ("batch", batch.batch),
                 ("x", batch.x), ("y", batch.y)):
        if v is not None:
            named.append((k, v))
    for k, v in (batch.metadata or {}).items():
        named.append((f"#META.{k}", v))
    return _to_host(named)


def hetero_batch_to_message(batch: HeteroBatch) -> SampleMessage:
    """Flatten a :class:`HeteroBatch` into string-keyed host arrays."""
    msg: SampleMessage = {
        _HET: np.array(1, np.int64),
        _META_BS: np.array(batch.batch_size, np.int64),
        "#input_type": np.frombuffer(
            str(batch.input_type).encode(), dtype=np.uint8).copy(),
    }
    for prefix, d, et in (
            ("node", batch.node, False), ("node_mask", batch.node_mask, False),
            ("ei", batch.edge_index, True), ("eid", batch.edge_id, True),
            ("em", batch.edge_mask, True), ("x", batch.x, False),
            ("y", batch.y, False), ("batch", batch.batch, False)):
        for k, v in (d or {}).items():
            if v is not None:
                msg[f"{prefix}@{_et_key(k) if et else k}"] = _host(v)
    for k, v in (batch.metadata or {}).items():
        msg[f"#META.{k}"] = _host(v)
    return msg


def message_to_hetero_batch(msg: SampleMessage,
                            device: DeviceLike = None) -> HeteroBatch:
    """Reconstruct a :class:`HeteroBatch` of tensors on ``device``
    (default ``"cuda"``) from a hetero message."""
    conv, conv_x = _converter(device)

    def group(prefix, et=False, fn=conv):
        out = {}
        for k, v in msg.items():
            if k.startswith(prefix + "@"):
                key = k[len(prefix) + 1:]
                out[_et_parse(key) if et else key] = fn(v)
        return out

    return HeteroBatch(
        x=group("x", fn=conv_x),
        y=group("y") or None,
        edge_index=group("ei", et=True),
        edge_id=group("eid", et=True),
        node=group("node"),
        node_mask=group("node_mask"),
        edge_mask=group("em", et=True),
        batch=group("batch") or None,
        batch_size=int(np.asarray(msg[_META_BS]).ravel()[0]),
        input_type=bytes(np.asarray(msg["#input_type"])).decode(),
        metadata=_meta(msg, conv),
    )


def message_to_batch(msg: SampleMessage, device: DeviceLike = None):
    """Reconstruct a :class:`Batch` of tensors on ``device`` (default
    ``"cuda"``) from a message, or a :class:`HeteroBatch` from a hetero
    one."""
    if _HET in msg:
        return message_to_hetero_batch(msg, device=device)
    conv, conv_x = _converter(device)
    return Batch(
        x=conv_x(msg["x"]) if "x" in msg else None,
        y=conv(msg["y"]) if "y" in msg else None,
        edge_index=torch.stack([conv(msg["row"]), conv(msg["col"])]),
        edge_id=conv(msg["edge"]) if "edge" in msg else None,
        node=conv(msg["node"]),
        node_mask=conv(msg["node_mask"]),
        edge_mask=conv(msg["edge_mask"]),
        batch=conv(msg["batch"]) if "batch" in msg else None,
        batch_size=int(np.asarray(msg[_META_BS]).ravel()[0]),
        metadata=_meta(msg, conv),
    )
