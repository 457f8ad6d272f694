"""Device milliseconds a real batch in R-GAT's projections (``rgat.proj``:
each layer's and relation's ``W_r`` over its source and destination
rows), from the program's graph-safe stage stamps inside the train
block's graph, over the window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "rgat.proj")
