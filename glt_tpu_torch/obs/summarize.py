"""Human summary of an exported Chrome trace (`python -m glt_tpu_torch.obs`).

Aggregates complete-events by span name: call count, total/mean/max
wall, and *self* time (total minus time attributed to nested spans on
the same thread) — self time is what ranks where a step actually goes.
"""
from __future__ import annotations

import json
from typing import Dict, List


def summarize_trace(obj: dict) -> List[dict]:
    """Per-span-name aggregate rows, sorted by total time descending.

    Row keys: ``name, count, total_ms, self_ms, mean_ms, max_ms,
    device_wait_ms`` (device wait summed over fenced spans only).
    """
    events = [e for e in obj.get("traceEvents", []) if e.get("ph") == "X"]
    by_tid: Dict[tuple, List[dict]] = {}
    for ev in events:
        by_tid.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    stats: Dict[str, dict] = {}
    eps = 0.5  # us; tolerates rounding at span edges
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[dict] = []        # {"end", "name"} of open ancestors
        for ev in evs:
            while stack and stack[-1]["end"] <= ev["ts"] + eps:
                stack.pop()
            if stack:
                # A child's whole duration leaves its direct parent's
                # self time (grandchildren subtract from the child).
                stats[stack[-1]["name"]]["self_us"] -= ev["dur"]
            stack.append({"end": ev["ts"] + ev["dur"], "name": ev["name"]})
            r = stats.setdefault(ev["name"], {
                "name": ev["name"], "count": 0, "total_us": 0.0,
                "self_us": 0.0, "max_us": 0.0, "device_wait_us": 0.0})
            r["count"] += 1
            r["total_us"] += ev["dur"]
            r["self_us"] += ev["dur"]
            r["max_us"] = max(r["max_us"], ev["dur"])
            r["device_wait_us"] += ev.get("args", {}).get(
                "device_wait_us", 0.0)
    rows = []
    for r in sorted(stats.values(), key=lambda r: -r["total_us"]):
        rows.append({
            "name": r["name"],
            "count": r["count"],
            "total_ms": round(r["total_us"] / 1e3, 3),
            "self_ms": round(r["self_us"] / 1e3, 3),
            "mean_ms": round(r["total_us"] / max(r["count"], 1) / 1e3, 3),
            "max_ms": round(r["max_us"] / 1e3, 3),
            "device_wait_ms": round(r["device_wait_us"] / 1e3, 3),
        })
    return rows


def format_summary(rows: List[dict]) -> str:
    cols = ("name", "count", "total_ms", "self_ms", "mean_ms", "max_ms",
            "device_wait_ms")
    widths = {c: (max(len(c), *(len(str(r[c])) for r in rows))
                  if rows else len(c)) for c in cols}
    head = "  ".join(c.ljust(widths[c]) for c in cols)
    sep = "  ".join("-" * widths[c] for c in cols)
    lines = [head, sep]
    for r in rows:
        lines.append("  ".join(
            str(r[c]).ljust(widths[c]) if c == "name"
            else str(r[c]).rjust(widths[c]) for c in cols))
    return "\n".join(lines)


def summarize_flight(obj: dict) -> dict:
    """Sectioned summary of a flight-recorder dump (single or merged).

    ``{"reason", "events_total", "kinds", "device", "compile",
    "captures", "slo"}`` — the device-memory and compile sections are
    the postmortem's first questions ("was it leaking?", "was it
    recompiling?") answered without scrolling the raw event stream.
    """
    events = [e for e in obj.get("events", []) if isinstance(e, dict)]
    kinds: Dict[str, int] = {}
    for ev in events:
        k = str(ev.get("kind", "?"))
        kinds[k] = kinds.get(k, 0) + 1
    leaks = [e for e in events if e.get("kind") == "device.leak_suspect"]
    storms = [e for e in events if e.get("kind") == "compile.storm"]
    captures = [e for e in events if e.get("kind") == "profiler.capture"]
    alerts = [e for e in events if e.get("kind") == "slo.alert"]
    return {
        "reason": obj.get("reason"),
        "events_total": len(events),
        "kinds": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
        "device": {
            "leak_suspects": len(leaks),
            "last_leak": leaks[-1] if leaks else None,
        },
        "compile": {
            "storms": len(storms),
            "storm_programs": sorted({str(e.get("program", "?"))
                                      for e in storms}),
            "last_storm": storms[-1] if storms else None,
        },
        "captures": [{"dir": e.get("dir"), "reason": e.get("reason"),
                      "ms": e.get("ms")} for e in captures],
        "slo": {
            "alerts": len(alerts),
            "firing": sorted({str(e.get("slo", "?")) for e in alerts
                              if e.get("state") == "firing"}),
        },
    }


def format_flight_summary(summary: dict) -> str:
    lines = [f"flight dump: {summary['events_total']} events "
             f"(reason={summary['reason']!r})", "", "Event kinds:"]
    for kind, n in summary["kinds"].items():
        lines.append(f"  {kind:<28} {n}")
    dev = summary["device"]
    lines += ["", "Device memory:"]
    if dev["leak_suspects"]:
        last = dev["last_leak"] or {}
        lines.append(f"  LEAK SUSPECT x{dev['leak_suspects']} — live "
                     f"{last.get('live_bytes')} B after "
                     f"{last.get('growth_epochs')} growing epochs")
    else:
        lines.append("  no leak suspects")
    comp = summary["compile"]
    lines += ["", "Compile:"]
    if comp["storms"]:
        lines.append(f"  RECOMPILE STORM x{comp['storms']} — programs: "
                     + ", ".join(comp["storm_programs"]))
    else:
        lines.append("  no recompile storms")
    lines += ["", f"Profiler captures: {len(summary['captures'])}"]
    for cap in summary["captures"]:
        lines.append(f"  {cap['reason']:<24} {cap['dir']}")
    slo = summary["slo"]
    lines += ["", f"SLO alerts: {slo['alerts']}"
              + (f" (fired: {', '.join(slo['firing'])})"
                 if slo["firing"] else "")]
    return "\n".join(lines)


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
