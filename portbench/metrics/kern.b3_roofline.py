"""Kernel B3 (``fused_frontier_kernel``) against its roofline: the
traced batches' frontier gathers (``roofline.frontier_work``: ids read,
each distinct row read once, each position's row written) over the HBM
rate, over the profiled time of every kernel of that name."""
from portbench import trace

KERNEL = "fused_frontier_kernel"


def read(rec, name):
    tr = rec.get("trace") or {}
    t = trace.kernel_time(tr, KERNEL)
    if not t or not tr.get("b3_bound_s"):
        return None
    return 100.0 * tr["b3_bound_s"] / t
