"""Faults planted in the program under a whole run, to show that the
check finds them: the benchmark's CPU tests plant each, and
``portbench.calibrate --faults`` reads the check's numbers under them on
the card.  The benchmark's own runs never plant one.

Each fault replaces one name of the program for the length of a
``with planted(name):`` block, so what it breaks runs where the timed
path runs it (inside a captured block on the card).
"""
from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

#: fault -> what it breaks
FAULTS = {
    "first_f": "each hop reads the first min(deg, f) neighbours of a row: "
               "the draw ignores the key",
    "block_key": "every batch of a scanned block samples under its first "
                 "batch's key",
    "block_seeds": "every real batch of a scanned block trains its first "
                   "batch's seeds",
    "frozen_dropout": "dropout draws under the first step's key at every "
                      "step",
    "skip_update": "the optimizer step left out: the state stays unchanged",
    "half_batch": "the loss taken over the first half of the seeds",
    "altered_row": "one gathered feature row altered where it is produced",
    "altered_edge": "one sampled edge altered where it is produced",
}


def _first_f(indptr, indices, seeds, fanout, key, edge_ids=None,
             with_replacement=False, with_edge=True, key_by="slot"):
    from glt_tpu_torch.ops.neighbor_sample import NeighborOutput

    valid = seeds >= 0
    s = torch.where(valid, seeds, 0).long()
    start = indptr[s].long()
    deg = torch.where(valid, indptr[s + 1].long() - start, 0)
    slots = torch.arange(fanout, device=seeds.device)
    mask = slots[None, :] < deg.clamp(max=fanout)[:, None]
    pos = torch.where(mask, start[:, None] + slots[None, :], 0)
    nbrs = torch.where(mask, indices[pos], -1).to(torch.int32)
    eids = torch.where(mask, pos, -1).to(torch.int32) if with_edge else None
    return NeighborOutput(nbrs, eids, mask)


def _shim(module, **over):
    """A stand-in for ``module`` with some names replaced."""
    ns = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module)
                                  if not k.startswith("__")})
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _targets(name):
    """``[(owner, attribute, replacement)]`` of a fault."""
    from glt_tpu_torch import random as trandom
    import glt_tpu_torch.models.train as train
    import glt_tpu_torch.sampler.neighbor_sampler as ns

    if name == "first_f":
        return [(ns, "sample_neighbors", _first_f)]
    if name == "block_key":
        def split(key, num, **kw):
            keys = trandom.split(key, num, **kw)
            return keys[:1].expand(keys.shape)
        return [(train, "trandom", _shim(trandom, split=split))]
    if name == "frozen_dropout":
        def fold_in(key, data, **kw):
            if isinstance(data, torch.Tensor):
                data = torch.zeros_like(data)
            return trandom.fold_in(key, data, **kw)
        return [(train, "trandom", _shim(trandom, fold_in=fold_in))]
    if name == "block_seeds":
        host = train._host_array

        def host_array(blk):
            a = host(blk).copy()
            if a.ndim == 2:
                real = (a >= 0).any(axis=1)
                a[real] = a[0]
            return np.ascontiguousarray(a)
        return [(train, "_host_array", host_array)]
    if name == "skip_update":
        def step(opt, loss):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        return [(train, "_backward_and_step", step)]
    if name == "half_batch":
        ce = train.seed_cross_entropy

        def half(logits, y, batch_size, node_mask):
            return ce(logits, y, batch_size // 2, node_mask)
        return [(train, "seed_cross_entropy", half)]
    if name == "altered_row":
        fused = train.fused_frontier

        def altered(table, ids, id2index=None, dequant=None):
            res = fused(table, ids, id2index, dequant)
            feats = res.features.clone()
            feats[0, 0] += 1.0
            return res._replace(features=feats)
        return [(train, "fused_frontier", altered)]
    if name == "altered_edge":
        impl = ns.NeighborSampler._sample_impl

        def altered(self, *args):
            out = impl(self, *args)
            e = out.row.shape[0] - 1
            out.row = out.row.clone()
            out.row[e] = 0
            out.edge_mask = out.edge_mask.clone()
            out.edge_mask[e] = True
            return out
        return [(ns.NeighborSampler, "_sample_impl", altered)]
    raise KeyError(f"no fault {name!r}; known: {sorted(FAULTS)}")


@contextlib.contextmanager
def planted(name: str):
    targets = _targets(name)
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    try:
        for owner, attr, new in targets:
            setattr(owner, attr, new)
        yield
    finally:
        for owner, attr, old in saved:
            setattr(owner, attr, old)
