"""Plain R-GAT training steps in float32: the hetero train cell's
reference.

The relational GAT of MLPerf's GNN benchmark (GLT's
``examples/igbh/rgnn.py``, ``RGNN(model='rgat')``).  Layer ``l`` holds
per relation ``r = (s, rel, d)`` (messages from ``s`` rows into ``d``
rows) one ``W_r`` without bias, attention vectors ``a_src,r``,
``a_dst,r`` (``[heads, width / heads]``) and a bias ``b_r``:

* ``z = W_r x`` for the source rows and for the destination rows (once
  when both ends are one type);
* per head ``e_ij = LeakyReLU_0.2(a_src,r . z_j + a_dst,r . z_i)``;
  ``alpha`` the softmax of ``e_ij`` over the edges into ``i``;
* ``out_r,i = concat_h sum_j alpha_ij z_j + b_r``, summed over the
  relations into each type, in the order the relations are listed.

Between layers ``LeakyReLU_0.01`` and dropout on every type, neither
after the last; the head ``Linear(width, classes)`` on the target type;
cross-entropy averaged over the seeds (the first rows of the target
type); Adam as ``torch.optim.Adam`` defines it.  Dropout masks after
layer ``l`` are ``bernoulli(k, 1 - rate)`` over the type's rows with
``k = split(split(fold_in(PRNGKey(dropout_seed), step), L - 1)[l],
T)[t]``, ``t`` among the ``T`` types the layer wrote, sorted: the rule
the program states (:mod:`.threefry`).

Each relation's forward is recomputed in the backward
(``torch.utils.checkpoint``) so that the published widths fit the card
beside the feature table; that changes no arithmetic.  ``matmul`` picks
the precision of the linear maps: ``"f32"`` (TF32 off), ``"fp8"``
(operands rounded to e4m3, the control) or ``"bf16"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import threefry
from .sage import _linear

EdgeType = Tuple[str, str, str]


def as_str(et: EdgeType) -> str:
    return "__".join(et)


def param_names(relations: Sequence[EdgeType], num_layers: int
                ) -> List[str]:
    """Parameter names, in the order the program's model registers
    them."""
    out = []
    for l in range(num_layers):
        for r in relations:
            p = f"layers.{l}.convs.{as_str(r)}."
            out += [p + "att_src", p + "att_dst", p + "bias",
                    p + "lin.weight"]
    return out + ["head.weight", "head.bias"]


def _relation(h_s, h_d, w, att_s, att_d, b, src, dst, same: bool,
              heads: int, matmul: str):
    n_s, n_d = h_s.shape[0], h_d.shape[0]
    f = w.shape[0] // heads
    z_s = _linear(h_s, w, None, matmul).reshape(n_s, heads, f)
    z_d = z_s if same else _linear(h_d, w, None, matmul).reshape(
        n_d, heads, f)
    e = F.leaky_relu((z_s * att_s).sum(-1)[src] + (z_d * att_d).sum(-1)[dst],
                     0.2)                                   # [E, heads]
    top = torch.full((n_d, heads), float("-inf"), device=e.device)
    top = top.scatter_reduce(0, dst[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - top[dst])
    den = torch.zeros((n_d, heads), device=e.device).index_add(0, dst, ex)
    alpha = ex / den[dst]
    msg = z_s[src] * alpha[:, :, None]
    agg = torch.zeros((n_d, heads, f), device=e.device).index_add(0, dst, msg)
    return agg.reshape(n_d, heads * f) + b


def forward(params: Dict[str, torch.Tensor], x: Dict[str, torch.Tensor],
            edges: Dict[EdgeType, Tuple[torch.Tensor, torch.Tensor]],
            relations: Sequence[EdgeType], model_cfg: dict, target: str,
            keys: Optional[torch.Tensor], matmul: str = "f32"
            ) -> torch.Tensor:
    """Logits of every row of the target type.  ``edges``: per relation
    that the batch lays out, ``(src, dst)`` local ids of its valid
    edges (``src`` rows of the relation's first type); a relation it
    lays out without a valid edge still adds its bias.  ``keys``: the
    hidden layers' dropout keys (:func:`dropout_keys`), or None."""
    layers = int(model_cfg["num_layers"])
    heads = int(model_cfg["heads"])
    keep = 1.0 - float(model_cfg["dropout"])
    h = dict(x)
    for l in range(layers):
        out: Dict[str, torch.Tensor] = {}
        for r in relations:
            s, _, d = r
            if r not in edges or s not in h or d not in h:
                continue
            p = f"layers.{l}.convs.{as_str(r)}."
            src, dst = edges[r]
            o = checkpoint(
                _relation, h[s], h[d], params[p + "lin.weight"],
                params[p + "att_src"], params[p + "att_dst"],
                params[p + "bias"], src, dst, s == d, heads, matmul,
                use_reentrant=False)
            out[d] = o if d not in out else out[d] + o
        h = out
        if l + 1 < layers:
            h = {t: F.leaky_relu(v, 0.01) for t, v in h.items()}
            if keys is not None:
                types = sorted(h)
                tk = threefry.split(keys[l], len(types))
                h = {t: torch.where(threefry.bernoulli_rows(
                    tk[i], keep, h[t].shape[0], h[t].shape[1]),
                    h[t] / keep, 0) for i, t in enumerate(types)}
    return _linear(h[target], params["head.weight"], params["head.bias"],
                   matmul)


def dropout_keys(step: int, seed: int, num_layers: int, device
                 ) -> torch.Tensor:
    """The hidden layers' dropout keys of a step."""
    key = threefry.fold_in(threefry.prng_key(seed, device), step)
    return threefry.split(key, num_layers - 1)


def train(params0: Dict[str, torch.Tensor], batches: Sequence[dict],
          tables: Dict[str, torch.Tensor], relations: Sequence[EdgeType],
          model_cfg: dict, target: str, matmul: str = "f32") -> dict:
    """Adam steps, one a batch, from ``params0``.

    A batch: ``nodes`` (per type, the ids of its rows), ``edges`` (per
    relation, local ``(src, dst)``), ``y`` the seeds' labels (the seeds
    are the target type's first rows) and ``step`` the dropout step;
    rows are read from ``tables`` as float32 at each step.  Returns the
    losses, each leaf's gradient at the first step and the parameters
    after the last."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(params0, batches, tables, relations, model_cfg,
                      target, matmul)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _train(params0, batches, tables, relations, model_cfg, target, matmul):
    layers = int(model_cfg["num_layers"])
    rate = float(model_cfg["dropout"])
    lr = float(model_cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = param_names(relations, layers)
    params = {k: params0[k].detach().clone().float().requires_grad_(True)
              for k in names}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first_grad = [], None
    for t, b in enumerate(batches, start=1):
        x = {ty: tables[ty][ids].float() for ty, ids in b["nodes"].items()}
        keys = None
        if rate > 0 and layers > 1:
            keys = dropout_keys(b["step"], int(model_cfg["dropout_seed"]),
                                layers, b["y"].device)
        logits = forward(params, x, b["edges"], relations, model_cfg,
                         target, keys, matmul)
        del x
        s = b["y"].shape[0]
        loss = F.cross_entropy(logits[:s], b["y"].long())
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        losses.append(loss.item())
        if first_grad is None:
            first_grad = {k: torch.zeros_like(params[k]) if g is None
                          else g.detach().clone()
                          for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    # A relation the batch does not lay out: Adam skips
                    # a parameter without a gradient.
                    continue
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / bc1)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p.detach() for k, p in params.items()}}
