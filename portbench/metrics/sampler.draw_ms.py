"""Device milliseconds a real batch in the sampler's draws
(``sampler.draw``, every hop: kernel B1 and the edges' source slots),
from the program's graph-safe stage stamps over the window, the padded
batches of a block included."""
from portbench import progtrace


def read(rec, name):
    return progtrace.per_batch_ms(rec, "sampler.draw")
