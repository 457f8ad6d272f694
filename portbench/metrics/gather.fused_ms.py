"""Device milliseconds a real batch in the fused-frontier gather
(``gather.fused``: dedup, kernel B3, labels), from the program's
graph-safe stage stamps over the window (inside the train block's
graph)."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "gather.fused")
