"""Device milliseconds a real batch in the sampler's inducer: the dense
map and the seeds' insert (``sampler.init``) and every hop's induce
(``sampler.induce``), from the program's graph-safe stage stamps over
the window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "sampler.init", "sampler.induce")
