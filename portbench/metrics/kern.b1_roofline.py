"""Kernel B1 (``sample_kernel``) against its roofline: the least time
of the traced batches' hops (``roofline.hop_work``: bytes over the HBM
rate or int32 operations over the int32 rate, the larger) over the
profiled time of every kernel of that name."""
from portbench import trace

KERNEL = "sample_kernel"


def read(rec, name):
    tr = rec.get("trace") or {}
    t = trace.kernel_time(tr, KERNEL)
    if not t or not tr.get("b1_bound_s"):
        return None
    return 100.0 * tr["b1_bound_s"] / t
