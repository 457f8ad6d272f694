"""Share of the profiled window that the card sat idle while the host
was inside the sampler's spans (``sampler.*``: the batched call, its
graph's staging and launch, the output clones; ``portbench.layers``),
%."""
from portbench import progtrace


def read(rec, name):
    return progtrace.idle_share(rec, "sampler")
