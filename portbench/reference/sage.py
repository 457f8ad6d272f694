"""Plain GraphSAGE training steps in float32: the train cell's reference.

``h_i = W_self h_i + b + W_nbr mean_{j -> i} h_j`` a layer (Hamilton et
al., 2017, the mean aggregator; PyG's ``SAGEConv`` holds the bias on the
neighbour map, which is the same sum), relu and dropout between layers,
cross-entropy averaged over the seeds, Adam (Kingma and Ba, 2015) as
``torch.optim.Adam`` defines it.  Dropout masks are
``bernoulli(split(fold_in(PRNGKey(dropout_seed), step), L - 1)[l],
1 - rate)`` over rows of the sampled node list, the specification the
program states (:mod:`.threefry`).

The inputs are a sampled subgraph (node ids and local edges), the
feature table and labels, and the initial parameters: all made by the
benchmark, or the sampled batch the program returned, which the check
judges on its own.  ``matmul`` picks the precision of the linear maps:
``"f32"`` (TF32 off), ``"fp8"`` (operands rounded to e4m3 with one
scale a tensor, f32 products: the control) or ``"bf16"`` (the
configuration's own precision: a witness of what rounding alone gives).  ``seeds_used`` keeps the loss on the first that
many seeds (a planted fault: half of the batch left out).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import threefry

E4M3_MAX = 448.0


class _RoundE4M3(torch.autograd.Function):
    """Round to float8 e4m3 with one scale for the tensor; the gradient
    passes through (the matmul's own backward reads the rounded
    operands)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().max().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _linear(x, w, b, matmul: str):
    if matmul == "fp8":
        x, w = _RoundE4M3.apply(x), _RoundE4M3.apply(w)
    elif matmul == "bf16":
        dt = torch.bfloat16
        return F.linear(x.to(dt), w.to(dt),
                        None if b is None else b.to(dt)).float()
    return F.linear(x, w, b)


def layer_names(num_layers: int) -> List[str]:
    """Parameter names, in the order the model registers them."""
    out = []
    for l in range(num_layers):
        out += [f"convs.{l}.lin_self.weight", f"convs.{l}.lin_self.bias",
                f"convs.{l}.lin_nbr.weight"]
    return out


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            src: torch.Tensor, dst: torch.Tensor, num_layers: int,
            masks: Optional[Sequence[torch.Tensor]], keep: float,
            matmul: str = "f32") -> torch.Tensor:
    """Logits of every node of the subgraph.  ``src -> dst`` are local
    ids of the valid edges."""
    n = x.shape[0]
    deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, dst, torch.ones_like(dst, dtype=x.dtype))
    h = x
    for l in range(num_layers):
        agg = torch.zeros((n, h.shape[1]), dtype=h.dtype,
                          device=h.device).index_add_(0, dst, h[src])
        agg = agg / deg.clamp(min=1)[:, None]
        p = f"convs.{l}."
        h = (_linear(h, params[p + "lin_self.weight"],
                     params[p + "lin_self.bias"], matmul)
             + _linear(agg, params[p + "lin_nbr.weight"], None, matmul))
        if l + 1 < num_layers:
            h = torch.relu(h)
            if masks is not None:
                h = torch.where(masks[l], h / keep, 0)
    return h


def dropout_masks(step: int, seed: int, rows: int, width: int,
                  num_layers: int, rate: float, device) -> List[torch.Tensor]:
    key = threefry.fold_in(threefry.prng_key(seed, device), step)
    keys = threefry.split(key, num_layers - 1)
    return [threefry.bernoulli_rows(keys[l], 1.0 - rate, rows, width)
            for l in range(num_layers - 1)]


def train(params0: Dict[str, torch.Tensor], batches: Sequence[dict],
          model_cfg: dict, matmul: str = "f32",
          seeds_used: Optional[int] = None) -> dict:
    """Adam steps, one a batch, from ``params0``.

    A batch: ``x`` ``[n, d]`` features of its nodes, ``src``/``dst``
    local edges, ``y`` ``[s]`` the seeds' labels (the seeds are nodes
    ``0..s-1``) and ``step`` the dropout step.  Returns the losses, each
    leaf's gradient at the first step and the parameters after the
    last."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(params0, batches, model_cfg, matmul, seeds_used)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _train(params0, batches, model_cfg, matmul, seeds_used):
    layers = int(model_cfg["num_layers"])
    rate = float(model_cfg["dropout"])
    lr = float(model_cfg["lr"])
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = layer_names(layers)
    params = {k: params0[k].detach().clone().float().requires_grad_(True)
              for k in names}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first_grad = [], None
    for t, b in enumerate(batches, start=1):
        masks = None
        if rate > 0:
            masks = dropout_masks(b["step"], int(model_cfg["dropout_seed"]),
                                  b["x"].shape[0], int(model_cfg["hidden"]),
                                  layers, rate, b["x"].device)
        logits = forward(params, b["x"], b["src"], b["dst"], layers, masks,
                         1.0 - rate, matmul)
        s = b["y"].shape[0] if seeds_used is None else seeds_used
        loss = F.cross_entropy(logits[:s], b["y"][:s].long())
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(loss.item())
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
                denom = (v[k].sqrt() / bc2 ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / bc1)
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p.detach() for k, p in params.items()}}
