"""Flat ``SampleMessage`` -> :class:`Batch` (cf.
``glt_tpu/distributed/sample_message.py``, homogeneous half).

A ``SampleMessage`` is a flat ``Dict[str, np.ndarray]``: everything a
batch carries, with ``#META.*`` scalar keys.  numpy has no bfloat16, so
bf16 features travel as their raw 16-bit patterns in a ``uint16`` ``x``
(the port stores no other 16-bit integer features).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..loader.transform import Batch
from ..utils.device import DeviceLike, resolve_device

SampleMessage = Dict[str, np.ndarray]

_META_BS = "#META.batch_size"
_HET = "#HETERO"


def message_to_batch(msg: SampleMessage,
                     device: DeviceLike = None) -> Batch:
    """Reconstruct a :class:`Batch` of tensors on ``device`` (default
    ``"cuda"``) from a message."""
    if _HET in msg:
        raise NotImplementedError(
            "heterogeneous messages are not ported yet")
    dev = resolve_device(device)

    def conv(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    def conv_x(v):
        if v.dtype == np.uint16:
            return conv(v.view(np.int16)).view(torch.bfloat16)
        return conv(v)

    meta = {k[len("#META."):]: conv(v) for k, v in msg.items()
            if k.startswith("#META.") and k != _META_BS}
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
        metadata=meta or None,
    )
