"""How full the sampler's fixed node buffer runs: the window's unique
nodes (the program's device counter ``glt.sample.unique_nodes``, the
clamped count) over its batches with a seed (``glt.sample.batches``)
times the node capacity, %.  Every later stage pays for the whole
capacity."""


def read(rec, name):
    got = (rec.get("prog") or {}).get("counters") or {}
    n = got.get("glt.sample.batches")
    if not n or "glt.sample.unique_nodes" not in got:
        return None
    return (100.0 * got["glt.sample.unique_nodes"]
            / (n * rec["node_capacity"]))
