"""Device milliseconds a real batch in R-GAT's attention (``rgat.attn``:
each layer's and relation's scores, segment softmax and weighted sum),
from the program's graph-safe stage stamps inside the train block's
graph, over the window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "rgat.attn")
