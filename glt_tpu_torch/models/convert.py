"""Carry ``glt_tpu`` (flax) GraphSAGE parameters into the port's module.

A flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear.weight`` is
``[out, in]``.  Parameters arrive as any array type numpy can read, so
this module needs no flax.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"conv(\d+)$")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for :class:`~glt_tpu_torch.models.sage.GraphSAGE` from
    a flax ``GraphSAGE`` parameter tree (``{"params": {"conv0": ...}}``
    or its inner dict).  Load it with ``model.load_state_dict``."""
    tree = params["params"] if "params" in params else params
    state: Dict[str, torch.Tensor] = {}
    for name, layer in tree.items():
        m = _CONV.match(name)
        if m is None:
            raise KeyError(f"unexpected GraphSAGE parameter group {name!r}")
        pre = f"convs.{int(m.group(1))}"
        for lin in ("lin_self", "lin_nbr"):
            kernel = np.asarray(layer[lin]["kernel"], np.float32)
            state[f"{pre}.{lin}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.T))
            if "bias" in layer[lin]:
                state[f"{pre}.{lin}.bias"] = torch.from_numpy(
                    np.array(layer[lin]["bias"], np.float32))
    return state
