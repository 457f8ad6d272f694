"""Device milliseconds a batch launched from inside the benchmark's
range around the fused-frontier gathers (dedup, kernel B3, labels), over
the traced batches."""


def read(rec, name):
    tr = rec.get("trace") or {}
    s = tr.get("range_s", {}).get("portbench.gather")
    if not s or not tr.get("batches"):
        return None
    return 1e3 * s / tr["batches"]
