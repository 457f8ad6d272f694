"""glt_tpu_torch.obs — unified tracing, metrics, and roofline profiling
(cf. ``glt_tpu/obs``; the same exports).

  * **Tracing** (:mod:`.trace`): nested host-side spans with explicit
    device fencing (a CUDA event waited on), exported as
    Chrome-trace/Perfetto JSON; summarize with
    ``python -m glt_tpu_torch.obs summarize trace.json``.
  * **Metrics** (:mod:`.metrics`): counters/gauges/histograms under one
    ``glt.*`` namespace with near-zero-cost no-op defaults; Prometheus
    text exposition.
  * **Flight recorder** (:mod:`.flight`), **SLOs** (:mod:`.slo`),
    **device memory** (:mod:`.device`, ``torch.cuda.memory_stats``),
    **captures** (:mod:`.compilewatch`, CUDA graphs and nvcc builds),
    **triggered profiles** (:mod:`.profiler`, ``torch.profiler``).
  * **Roofline** (:mod:`.roofline`): a measured device-memcpy bandwidth
    ceiling so ``gather_gb_s`` becomes an achieved-vs-peak fraction.

  * **Stages** (:mod:`.stages`): graph-safe stage spans and device
    counters, the one instrument legal inside a captured function.  A
    stage stamps its boundaries on the card (a one-thread kernel
    appending the global timer to a device ring), so every replay of a
    graph that captured it records again; eager, it is also a host span.

Traces, flight dumps and metric pages are ``glt_tpu``'s formats: either
package reads the other's.  Tracing and metrics are OFF by default and
cost roughly a global read + branch per call site when off.  Everything
but :func:`stage` and :func:`device_counter` is **host-side**: never
open a span or touch a metric inside a function a CUDA graph captures (a
replay runs no Python).  Stages and device counters are on or off at
the moment their code runs: eagerly, or at the capture of a graph.

  * **A graph captured with tracing off holds no stamp node** (and no
    counter update): it launches exactly the kernels of the code without
    them, whatever is installed later.
  * **A graph captured with tracing on keeps its stamps for its
    lifetime**: each replay appends to the ring even after the tracer is
    uninstalled (the ring and the counters are never freed).  Capture
    again with tracing off to drop them.

>>> from glt_tpu_torch import obs
>>> obs.metrics.enable()
>>> tracer = obs.start_trace()
>>> with obs.span("epoch") as sp:
...     loss = step(...)
...     sp.fence(loss)                    # close waits for the card
>>> obs.stop_trace("/tmp/trace.json")
>>> obs.metrics.snapshot()["glt.loader.batches"]
"""
from . import attrib  # noqa: F401
from . import compilewatch  # noqa: F401
from . import device  # noqa: F401
from . import flight  # noqa: F401
from . import metrics  # noqa: F401
from . import profiler  # noqa: F401
from . import slo  # noqa: F401
from . import stages  # noqa: F401
from .flight import (  # noqa: F401
    FlightRecorder,
    merge_flight_dumps,
    validate_flight_dump,
)
from .merge import merge_traces, span_tree_check  # noqa: F401
from .metrics import prune_unmeasured  # noqa: F401
from .slo import SloMonitor, SloSpec, default_specs  # noqa: F401
from .stages import device_counter, stage, tracing  # noqa: F401
from .roofline import measure_memcpy_roofline, roofline_fraction  # noqa: F401
from .summarize import (  # noqa: F401
    format_flight_summary,
    format_summary,
    summarize_flight,
    summarize_trace,
)
from .trace import (  # noqa: F401
    Span,
    Tracer,
    auto_trace,
    auto_trace_export,
    current,
    install,
    span,
    start_trace,
    stop_trace,
    validate_chrome_trace,
)

__all__ = [
    "FlightRecorder",
    "SloMonitor",
    "SloSpec",
    "Span",
    "Tracer",
    "attrib",
    "auto_trace",
    "compilewatch",
    "device",
    "device_counter",
    "profiler",
    "auto_trace_export",
    "current",
    "default_specs",
    "flight",
    "format_flight_summary",
    "format_summary",
    "install",
    "measure_memcpy_roofline",
    "merge_flight_dumps",
    "merge_traces",
    "metrics",
    "prune_unmeasured",
    "slo",
    "validate_flight_dump",
    "roofline_fraction",
    "span",
    "span_tree_check",
    "stage",
    "stages",
    "start_trace",
    "stop_trace",
    "summarize_flight",
    "summarize_trace",
    "tracing",
    "validate_chrome_trace",
]
