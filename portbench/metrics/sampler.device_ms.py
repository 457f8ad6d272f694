"""Device milliseconds a batch launched from inside the benchmark's
range around ``sample_from_nodes_batched`` (the replayed graph's
kernels count under the range of its launch), over the traced
batches."""


def read(rec, name):
    tr = rec.get("trace") or {}
    s = tr.get("range_s", {}).get("portbench.sample")
    if not s or not tr.get("batches"):
        return None
    return 1e3 * s / tr["batches"]
