"""The numbers that decide ``correct``, and the verdict against limits.

Training numbers, each the worst over leaves:

* ``grad_gap``: per leaf, the gap between the norms of the program's
  first gradient (Adam's first moment after one step over ``1 - b1``)
  and the reference's, over the larger of the reference leaf's norm and
  the median leaf's;
* ``change_gap``: the same of each leaf's change over the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves those by round-off alone);
* ``grad_diff``: per leaf, the norm of the difference between the two
  first gradients, over the same denominator.  The gaps of norms above
  are sums of rounding errors of either sign and cancel; at a random
  initialisation the loss and its gradient are ruled by the labels, so
  those gaps read alike in bf16 and in fp8.  The difference does not
  cancel: it reads the precision of the forward and backward passes;
* ``change_diff``: the same of each leaf's change over the checked
  steps, over the leaves ``change_gap`` keeps.  It reads what every step
  trained on: a later step that samples, drops out or takes its seeds
  otherwise than the reference moves it, where the losses of random
  labels barely move.

A cell's limits live in ``limits/<cell>.json``, each with the readings
it was set from.  A run is correct when every number is finite and at
or under its limit.
"""
from __future__ import annotations

import json
import math
import os
import statistics
from typing import Dict, List, Mapping

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gap(prog: Mapping[str, torch.Tensor],
             ref: Mapping[str, torch.Tensor], keep=None) -> float:
    """Worst leaf of ``|norm(prog) - norm(ref)|`` over the larger of
    ``norm(ref)`` and the median leaf's reference norm."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    worst = 0.0
    for k in rn:
        if keep is not None and k not in keep:
            continue
        worst = max(worst, abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def leaf_diff(prog: Mapping[str, torch.Tensor],
              ref: Mapping[str, torch.Tensor], keep=None) -> float:
    """Worst leaf of ``norm(prog - ref)`` over the larger of ``norm(ref)``
    and the median leaf's reference norm."""
    rn = _norms(ref)
    med = statistics.median(rn.values())
    return max(float((prog[k].double() - ref[k].double()).norm())
               / max(rn[k], med, 1e-30) for k in rn
               if keep is None or k in keep)


def moved_leaves(ref_grad: Mapping[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    gn = _norms(ref_grad)
    med = statistics.median(gn.values())
    return [k for k, g in gn.items() if g >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict, params0: Mapping[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """``prog``/``ref``: ``first_grad`` and ``params`` after the checked
    steps.  The steps' losses are not compared: at a random start with
    random labels they move too little under the faults to separate
    from rounding (PERF.md gives the readings)."""
    grad = leaf_gap(prog["first_grad"], ref["first_grad"])
    keep = moved_leaves(ref["first_grad"])
    dp = {k: prog["params"][k].float() - params0[k].float() for k in params0}
    dr = {k: ref["params"][k].float() - params0[k].float() for k in params0}
    return {"grad_gap": grad,
            "change_gap": leaf_gap(dp, dr, keep),
            "grad_diff": leaf_diff(prog["first_grad"], ref["first_grad"]),
            "change_diff": leaf_diff(dp, dr, keep)}


def load_limits(cell: str, root: str = HERE) -> Dict[str, float]:
    with open(os.path.join(root, "limits", f"{cell}.json")) as fh:
        spec = json.load(fh)
    return {k: float(v["limit"]) for k, v in spec["limits"].items()}


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]
            ) -> Dict[str, dict]:
    """Each compared number beside its limit; a number with no limit, or
    a limit with no number, is a failure."""
    out = {}
    for k in sorted(set(numbers) | set(limits)):
        v = numbers.get(k, math.nan)
        lim = limits.get(k, math.nan)
        ok = (not math.isnan(lim) and v is not None
              and math.isfinite(v) and v <= lim)
        out[k] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out
