"""Device milliseconds a real batch in the forward: the model and the seeds' loss
(``train.fwd``), from the program's graph-safe stage stamps inside
the train block's graph, over the window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "train.fwd")
