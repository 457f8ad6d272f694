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

Traces, flight dumps and metric pages are ``glt_tpu``'s formats: either
package reads the other's.  Tracing and metrics are OFF by default and
cost roughly a global read + branch per call site when off.  Everything
here is **host-side**: never open a span or touch a metric inside a
function a CUDA graph captures (a replay runs no Python).

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
from .flight import (  # noqa: F401
    FlightRecorder,
    merge_flight_dumps,
    validate_flight_dump,
)
from .merge import merge_traces, span_tree_check  # noqa: F401
from .metrics import prune_unmeasured  # noqa: F401
from .slo import SloMonitor, SloSpec, default_specs  # noqa: F401
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
    "start_trace",
    "stop_trace",
    "summarize_flight",
    "summarize_trace",
    "validate_chrome_trace",
]
