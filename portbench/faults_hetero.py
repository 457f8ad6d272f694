"""Faults planted in the program under a whole run of the hetero train
cell, to show that its check finds them (the counterpart of
:mod:`.faults`, whose ``block_key`` and ``frozen_dropout`` it takes as
they are): the benchmark's CPU tests plant each, and
``portbench.calibrate_hetero --fault`` reads the check's numbers under
them on the card.  The benchmark's own runs never plant one.
"""
from __future__ import annotations

import contextlib

from . import faults

#: fault -> what it breaks
FAULTS = {
    "relation_dropped": "every R-GAT layer leaves out its first relation",
    "source_softmax": "the attention's softmax runs over each source's "
                      "edges, not over each destination's",
    "block_key": faults.FAULTS["block_key"],
    "frozen_dropout": faults.FAULTS["frozen_dropout"],
}


def _targets(name):
    from glt_tpu_torch.models import conv, rgat

    if name == "relation_dropped":
        pairs = rgat.HeteroConv._pairs

        def dropped(self, x, edge_index, edge_mask):
            first = self.edge_types[0]
            return pairs(self, x, {k: v for k, v in edge_index.items()
                                   if k != first}, edge_mask)
        return [(rgat.HeteroConv, "_pairs", dropped)]
    if name == "source_softmax":
        attend, softmax = conv.GATConv.attend, conv.segment_softmax

        def over_sources(self, z_src, z_dst, edge_index, edge_mask):
            n = z_src.shape[0]

            def by_source(e, dst, m, mask):
                return softmax(e, edge_index[0], n, mask)
            conv.segment_softmax = by_source
            try:
                return attend(self, z_src, z_dst, edge_index, edge_mask)
            finally:
                conv.segment_softmax = softmax
        return [(conv.GATConv, "attend", over_sources)]
    if name in ("block_key", "frozen_dropout"):
        return faults._targets(name)
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
