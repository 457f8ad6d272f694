"""Host milliseconds a real batch spent in the eager fused-frontier
gather's own span (``gather.fused``, its children's time left out and
its two stamp launches outside it), from the program's tracer over the
window."""
from portbench import progtrace


def read(rec, name):
    return progtrace.host_ms(rec, "gather.fused")
