"""Carry ``glt_tpu`` (flax) parameters into the port's modules:
GraphSAGE, GAT, R-GAT (with its ``HeteroConv`` layers) and HGT.

A flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear.weight`` is
``[out, in]``.  Edge types appear in both trees as
:func:`~glt_tpu_torch.typing.as_str` (``a__rel__b``), a module-dict key
in torch.  Flax creates a layer's parameters only for the edge and node
types its first batch reached, so a torch model (built for every type)
loads the result with ``load_state_dict(..., strict=False)``; the keys
it reports missing are those types'.  Parameters arrive as any array
type numpy can read, so this module needs no flax.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_CONV = re.compile(r"conv(\d+)$")
_LAYER = re.compile(r"layer(\d+)$")
# HGT's per-edge-type and per-node-type tensors, and its per-node-type
# dense maps, by name prefix.
_HGT_TENSORS = ("w_att", "w_msg", "mu", "skip")
_HGT_DENSE = ("k", "q", "v", "a")


def _k(pre: str, name: str) -> str:
    return f"{pre}.{name}" if pre else name


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(state: Dict[str, torch.Tensor], pre: str, dense: Mapping) -> None:
    state[_k(pre, "weight")] = _t(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        state[_k(pre, "bias")] = _t(dense["bias"])


def _conv(state: Dict[str, torch.Tensor], pre: str, conv: Mapping) -> None:
    """A SAGEConv (``lin_self``/``lin_nbr``) or a GATConv (``lin`` and
    its attention vectors and bias)."""
    for name, v in conv.items():
        if isinstance(v, Mapping):
            _dense(state, _k(pre, name), v)
        else:
            state[_k(pre, name)] = _t(v)


def _layer(state: Dict[str, torch.Tensor], pre: str, layer: Mapping) -> None:
    """One R-GAT ``HeteroConv`` or one ``HGTConv`` layer."""
    for name, v in layer.items():
        if name.endswith("_conv"):
            _conv(state, _k(pre, f"convs.{name[:-5]}"), v)
        elif name.endswith("_align"):
            _dense(state, _k(pre, f"align.{name[:-6]}"), v)
        else:
            for prefix in _HGT_TENSORS + _HGT_DENSE:
                if name.startswith(prefix + "_"):
                    key = _k(pre, f"{prefix}.{name[len(prefix) + 1:]}")
                    if prefix in _HGT_DENSE:
                        _dense(state, key, v)
                    else:
                        state[key] = _t(v)
                    break
            else:
                raise KeyError(f"unexpected layer parameter {name!r}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's module from a flax parameter tree
    (``{"params": {...}}`` or its inner dict) of ``GraphSAGE`` or
    ``GAT`` (``conv{i}`` groups), ``RGAT`` or ``HGT`` (``in_{t}``,
    ``layer{i}``, ``head``), or of one layer: a ``SAGEConv`` or
    ``GATConv``, a ``HeteroConv`` or an ``HGTConv``."""
    tree = params["params"] if "params" in params else params
    state: Dict[str, torch.Tensor] = {}
    if not any(_CONV.match(k) or _LAYER.match(k) or k.startswith("in_")
               or k == "head" for k in tree):
        if "lin" in tree or "lin_self" in tree:
            _conv(state, "", tree)
        else:
            _layer(state, "", tree)
        return state
    for name, group in tree.items():
        conv, layer = _CONV.match(name), _LAYER.match(name)
        if conv is not None:
            _conv(state, f"convs.{int(conv.group(1))}", group)
        elif layer is not None:
            _layer(state, f"layers.{int(layer.group(1))}", group)
        elif name.startswith("in_"):
            _dense(state, f"inputs.{name[3:]}", group)
        elif name == "head":
            _dense(state, "head", group)
        else:
            raise KeyError(f"unexpected parameter group {name!r}")
    return state
