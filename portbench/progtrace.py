"""The program's own instruments in a traced run: its tracer, its
graph-safe stage spans and its device counters (``glt_tpu_torch.obs``).

A traced run installs the program's tracer in set-up, before any
capture, so that the graphs it captures hold their stage stamps and its
host spans open ``torch.profiler`` ranges (:func:`install`).  The window
starts with the stamp ring and the counters emptied and the tracer's
events dropped (:func:`window_start`), and ends, after its last sync and
before anything samples again, with all three read into ``rec["prog"]``
and the tracer uninstalled (:func:`window_end`):

* ``stage_s`` / ``stage_n``: device seconds and spans of each stage;
* ``counters``: the ``glt.sample.*`` device counters;
* ``host_self_s``: host self seconds of each span name (a span's time
  less its children's);
* ``lost`` / ``unmatched``: stamps overwritten, marks left unpaired.

A program without stages or counters gives what it has; the readers of
the rest return None.  The untraced run calls none of this.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def install(ctx):
    """The program's tracer, installed (a traced run), or None."""
    if not ctx["trace"]:
        return None
    from glt_tpu_torch import obs

    return obs.start_trace(process_name="portbench")


def _stages():
    from glt_tpu_torch import obs

    return getattr(obs, "stages", None)


def window_start(tracer) -> None:
    if tracer is None:
        return
    stages = _stages()
    if stages is not None:
        stages.reset()
    tracer.clear()


def host_self(events: List[dict]) -> Dict[str, float]:
    """Seconds of each span name's own host time: its spans' lengths
    less those of their children."""
    child: Dict[int, float] = {}
    for e in events:
        parent = e.get("args", {}).get("parent_span_id")
        if e.get("ph") == "X" and parent is not None:
            child[parent] = child.get(parent, 0.0) + e["dur"]
    out: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        own = e["dur"] - child.get(e.get("args", {}).get("span_id"), 0.0)
        out[e["name"]] = out.get(e["name"], 0.0) + own / 1e6
    return out


def window_end(tracer, rec: dict) -> None:
    """Read the window's stages, counters and host spans into
    ``rec["prog"]`` (waits for the device) and uninstall the tracer."""
    if tracer is None:
        return
    from glt_tpu_torch import obs

    prog = {"host_self_s": host_self(tracer.events)}
    stages = _stages()
    if stages is not None:
        r = stages.read()
        prog.update(stage_s=r.totals(), stage_n=r.counts(), lost=r.lost,
                    unmatched=r.unmatched,
                    counters=stages.counter_values())
    obs.stop_trace()
    rec["prog"] = prog


def per_batch_ms(rec: dict, *stages: str) -> Optional[float]:
    """Device ms a real batch of the window in the named stages (all of
    them seen), or None."""
    got = (rec.get("prog") or {}).get("stage_s") or {}
    if not rec.get("batches") or any(s not in got for s in stages):
        return None
    return 1e3 * sum(got[s] for s in stages) / rec["batches"]


def host_ms(rec: dict, span: str) -> Optional[float]:
    """Host self ms a real batch of the window in ``span``, or None."""
    got = (rec.get("prog") or {}).get("host_self_s") or {}
    if not rec.get("batches") or span not in got:
        return None
    return 1e3 * got[span] / rec["batches"]


def idle_share(rec: dict, layer: str) -> Optional[float]:
    """% of the profiled window that the card sat idle while the host
    was inside ``layer``'s spans, or None."""
    tr = rec.get("trace") or {}
    got = tr.get("idle_layer_s") or {}
    if layer not in got or not tr.get("window_s"):
        return None
    return 100.0 * got[layer] / tr["window_s"]
