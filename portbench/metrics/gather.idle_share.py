"""Share of the profiled window that the card sat idle while the host
was inside the gather's spans (``gather.*``, the innermost of a layer
over each idle gap: ``portbench.layers``), %."""
from portbench import progtrace


def read(rec, name):
    return progtrace.idle_share(rec, "gather")
