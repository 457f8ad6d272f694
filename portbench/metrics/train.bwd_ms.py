"""Device milliseconds a real batch in the backward: ``loss.backward()``
(``train.bwd``), from the program's graph-safe stage stamps inside
the train block's graph, over the window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "train.bwd")
