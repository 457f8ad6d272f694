"""The training step's share of the card's dense bf16 peak: the
GraphSAGE forward and backward FLOPs the traced blocks' batches need
(``roofline.sage_flops`` of each batch drawn again), over the traced
window's length, against 989 TFLOP/s."""
from portbench import roofline


def read(rec, name):
    tr = rec.get("trace") or {}
    if not tr.get("flops") or not tr.get("window_s"):
        return None
    return 100.0 * tr["flops"] / tr["window_s"] / roofline.BF16_FLOPS
