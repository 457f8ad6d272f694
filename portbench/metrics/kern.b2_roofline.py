"""Kernel B2 (``gather_rows_kernel``) against its roofline: the traced
batches' row gathers (``roofline_hetero.gather_work``: the ids read, each
position's row read and written) over the HBM rate, over the profiled
time of every kernel of that name."""
from portbench import trace

KERNEL = "gather_rows_kernel"


def read(rec, name):
    tr = rec.get("trace") or {}
    t = trace.kernel_time(tr, KERNEL)
    if not t or not tr.get("b2_bound_s"):
        return None
    return 100.0 * tr["b2_bound_s"] / t
