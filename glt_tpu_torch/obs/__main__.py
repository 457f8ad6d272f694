"""CLI: summarize / validate / merge exported traces + flight dumps.

    python -m glt_tpu_torch.obs summarize trace.json [--sort self|total|count]
                                               [--json]
    python -m glt_tpu_torch.obs validate trace.json|flight.json
    python -m glt_tpu_torch.obs merge -o merged.json client.json server.json ...

``validate`` and ``merge`` auto-detect flight-recorder dumps
(``glt_flight`` schema marker, obs/flight.py) and route them through
the flight validator/merger — one postmortem CLI for both artifact
kinds.
"""
from __future__ import annotations

import argparse
import json
import sys

from .flight import is_flight_dump, merge_flight_dumps, validate_flight_dump
from .merge import merge_traces
from .summarize import (format_flight_summary, format_summary, load_trace,
                        summarize_flight, summarize_trace)
from .trace import validate_chrome_trace


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m glt_tpu_torch.obs",
        description="glt_tpu_torch observability: trace summary, validation, "
                    "and cross-process merge")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser(
        "summarize",
        help="aggregate a Chrome-trace JSON by span (flight dumps "
             "summarize into device-memory/compile/capture sections)")
    p_sum.add_argument("trace")
    p_sum.add_argument("--sort", default="total",
                       choices=("total", "self", "count", "max"),
                       help="sort column (default: total time)")
    p_sum.add_argument("--json", action="store_true",
                       help="emit the aggregate rows as a JSON list "
                            "(machine-readable; no screen-scraping)")
    p_val = sub.add_parser("validate",
                           help="check Chrome-trace structure + nesting")
    p_val.add_argument("trace")
    p_merge = sub.add_parser(
        "merge",
        help="stitch per-process trace files into one clock-aligned "
             "Chrome trace (NTP-style offsets from obs.clock_sync "
             "samples; see docs/observability.md)")
    p_merge.add_argument("traces", nargs="+",
                         help="per-process trace files (client, server, "
                              "workers)")
    p_merge.add_argument("-o", "--out", required=True,
                         help="merged output path")
    p_merge.add_argument("--ref-pid", type=int, default=None,
                         help="process whose clock is the reference "
                              "(default: the one with most sync samples)")
    args = parser.parse_args(argv)

    if args.cmd == "merge":
        heads = [load_trace(p) for p in args.traces]
        if any(is_flight_dump(h) for h in heads):
            if not all(is_flight_dump(h) for h in heads):
                print("ERROR: cannot merge flight dumps with Chrome "
                      "traces (merge each kind separately)")
                return 2
            merged = merge_flight_dumps(args.traces, args.out)
            problems = validate_flight_dump(merged)
            for p in problems:
                print(f"INVALID: {p}")
            print(f"{'INVALID' if problems else 'OK'}: merged "
                  f"{len(args.traces)} flight dumps, "
                  f"{len(merged['events'])} events -> {args.out}")
            return 1 if problems else 0
        merged = merge_traces(args.traces, out=args.out,
                              ref_pid=args.ref_pid)
        info = merged["glt"]
        for pid, off in sorted(info["clock_offsets_us"].items()):
            print(f"pid {pid}: offset {off:+.1f} us")
        if info["unaligned_pids"]:
            print(f"WARNING: no sync path for pids "
                  f"{info['unaligned_pids']} (kept unshifted)")
        problems = validate_chrome_trace(merged)
        for p in problems:
            print(f"INVALID: {p}")
        print(f"{'INVALID' if problems else 'OK'}: merged "
              f"{len(args.traces)} files, "
              f"{len(merged['traceEvents'])} events -> {args.out}")
        return 1 if problems else 0

    obj = load_trace(args.trace)
    if args.cmd == "validate":
        if is_flight_dump(obj):
            problems = validate_flight_dump(obj)
            for p in problems:
                print(f"INVALID: {p}")
            if not problems:
                print(f"OK: flight dump, {len(obj['events'])} events, "
                      f"seq monotonic, reason={obj.get('reason')!r}")
            return 1 if problems else 0
        problems = validate_chrome_trace(obj)
        for p in problems:
            print(f"INVALID: {p}")
        n = len(obj.get("traceEvents", []))
        if not problems:
            print(f"OK: {n} events, spans nest, durations non-negative")
        return 1 if problems else 0

    if is_flight_dump(obj):
        # Flight dumps summarize into device-memory / compile / capture
        # sections (docs/observability.md) — same auto-routing as
        # validate/merge.
        summary = summarize_flight(obj)
        print(json.dumps(summary) if args.json
              else format_flight_summary(summary))
        return 0
    rows = summarize_trace(obj)
    key = {"total": "total_ms", "self": "self_ms", "count": "count",
           "max": "max_ms"}[args.sort]
    rows.sort(key=lambda r: -r[key])
    if args.json:
        print(json.dumps(rows))
    else:
        print(format_summary(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
