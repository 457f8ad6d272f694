"""Stitch per-process trace files into one clock-aligned Chrome trace.

Every process in a remote-sampling fleet (client, server, mp sampling
workers) exports its own trace file whose timestamps are **tracer
relative** — microseconds since that process's tracer started, an
arbitrary origin per process.  ``merge_traces`` estimates each
process's clock offset against a reference process and shifts every
event into the reference clock, so one file renders the whole fleet as
causally ordered, per-process-named tracks in Perfetto.

Offset estimation (docs/observability.md "Clock alignment"):

* **NTP-style pairs.**  Traced request/response round-trips record
  ``obs.clock_sync`` instants carrying ``(t0, t1, t2, t3)`` — client
  send, server receive, server send, client receive, the first two
  clocks local, the middle two the peer's.  For each sample the peer
  offset is ``theta = ((t1 - t0) + (t2 - t3)) / 2`` with round-trip
  ``delta = (t3 - t0) - (t2 - t1)``; the sample with the smallest
  ``delta`` wins (classic NTP filter), and its error is bounded by the
  link asymmetry, at most ``delta / 2``.

* **One-way samples.**  Peers reachable only through a one-directional
  channel (shm-ring sampling workers) stamp each message with their
  send time; the receiver records ``obs.clock_oneway``.  With
  ``theta`` the peer clock's lead, every sample satisfies
  ``t_send - t_recv = theta - latency <= theta``; the tightest bound
  ``max(t_send - t_recv)`` is the estimate, biased low by the minimum
  one-way latency (microseconds on a same-host ring).

Offsets compose transitively (worker -> server -> client), so processes
with no direct samples against the reference still align.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _load(path: str) -> dict:
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError(f"{path}: not a Chrome-trace object")
    return obj


def _file_identity(obj: dict, path: str) -> Tuple[Optional[int], str]:
    """(pid, process_name) of a trace file, from the ``glt`` sidecar or,
    for hand-built files, the metadata events / first timed event."""
    meta = obj.get("glt") or {}
    pid = meta.get("pid")
    name = meta.get("process_name")
    for ev in obj["traceEvents"]:
        if pid is None and "pid" in ev:
            pid = ev["pid"]
        if (name is None and ev.get("ph") == "M"
                and ev.get("name") == "process_name"):
            name = ev.get("args", {}).get("name")
    return pid, (name or path)


def _sync_edges(files: List[dict]) -> List[Tuple[int, int, float, float]]:
    """``(local_pid, peer_pid, theta, quality)`` from every sync sample:
    ``theta`` = peer clock minus local clock (``ts_local = ts_peer -
    theta``), ``quality`` = the sample's error bound in us (lower is
    better; used to pick among multiple samples for the same pair)."""
    edges: List[Tuple[int, int, float, float]] = []
    for f in files:
        local_pid = f["pid"]
        best_ntp: Dict[int, Tuple[float, float]] = {}
        best_oneway: Dict[int, Tuple[float, float]] = {}
        for ev in f["obj"]["traceEvents"]:
            args = ev.get("args", {})
            if ev.get("name") == "obs.clock_sync":
                try:
                    t0, t1 = float(args["t0_us"]), float(args["t1_us"])
                    t2, t3 = float(args["t2_us"]), float(args["t3_us"])
                    peer = int(args["peer_pid"])
                except (KeyError, TypeError, ValueError):
                    continue
                theta = ((t1 - t0) + (t2 - t3)) / 2.0
                delta = (t3 - t0) - (t2 - t1)
                err = max(delta, 0.0) / 2.0
                cur = best_ntp.get(peer)
                if cur is None or err < cur[1]:
                    best_ntp[peer] = (theta, err)
            elif ev.get("name") == "obs.clock_oneway":
                try:
                    peer = int(args["peer_pid"])
                    lag = (float(args["t_send_peer_us"])
                           - float(args["t_recv_us"]))
                except (KeyError, TypeError, ValueError):
                    continue
                cur = best_oneway.get(peer)
                # theta >= t_send - t_recv for every sample; the max is
                # the tightest lower bound.  Error bound unknown (the
                # min one-way latency); rank it behind any NTP pair.
                if cur is None or lag > cur[0]:
                    best_oneway[peer] = (lag, 1e9)
        for peer, (theta, err) in best_ntp.items():
            edges.append((local_pid, peer, theta, err))
        for peer, (theta, err) in best_oneway.items():
            if peer not in best_ntp:
                edges.append((local_pid, peer, theta, err))
    return edges


def estimate_offsets(files: List[dict], ref_pid: int) -> Dict[int, float]:
    """Per-pid offsets ``Theta`` with ``ts_ref = ts_pid - Theta[pid]``,
    composed transitively from the sync edges (BFS from the reference,
    best-quality edge first)."""
    edges = _sync_edges(files)
    # Undirected adjacency: an edge recorded in L about P maps either way.
    adj: Dict[int, List[Tuple[int, float, float]]] = {}
    for local, peer, theta, err in edges:
        adj.setdefault(local, []).append((peer, theta, err))
        adj.setdefault(peer, []).append((local, -theta, err))
    offsets: Dict[int, float] = {ref_pid: 0.0}
    frontier = [ref_pid]
    while frontier:
        nxt: List[int] = []
        for node in frontier:
            for peer, theta, _err in sorted(adj.get(node, ()),
                                            key=lambda e: e[2]):
                if peer in offsets:
                    continue
                # ts_node = ts_peer - theta and ts_ref = ts_node -
                # Theta[node]  =>  Theta[peer] = theta + Theta[node].
                offsets[peer] = theta + offsets[node]
                nxt.append(peer)
        frontier = nxt
    return offsets


def merge_traces(paths: Sequence[str], out: Optional[str] = None,
                 ref_pid: Optional[int] = None) -> dict:
    """Merge per-process trace files into one aligned Chrome trace.

    The reference process (``ref_pid``, default: the file with the most
    ``obs.clock_sync`` recordings — the client — else the first file)
    keeps its timestamps; every other process's events are shifted by
    its estimated offset.  Files with no sync path to the reference are
    kept unshifted and listed under ``glt.unaligned_pids``.
    """
    if not paths:
        raise ValueError("no trace files to merge")
    files: List[dict] = []
    seen_pids: Dict[int, int] = {}
    for i, path in enumerate(paths):
        obj = _load(path)
        pid, name = _file_identity(obj, path)
        pid = int(pid if pid is not None else -(i + 1))
        if pid in seen_pids:
            # Two files from one pid (in-process client+server tests):
            # keep them distinct tracks; sync edges resolve to the
            # first file's clock.
            seen_pids[pid] += 1
            pid = pid + 10_000_000 * seen_pids[pid]
        else:
            seen_pids[pid] = 0
        files.append({"path": path, "obj": obj, "pid": pid, "name": name})

    if ref_pid is None:
        def n_syncs(f):
            return sum(1 for ev in f["obj"]["traceEvents"]
                       if ev.get("name") == "obs.clock_sync")
        files_by_syncs = sorted(files, key=n_syncs, reverse=True)
        ref_pid = files_by_syncs[0]["pid"]

    offsets = estimate_offsets(files, ref_pid)
    merged: List[dict] = []
    unaligned: List[int] = []
    for f in files:
        theta = offsets.get(f["pid"])
        if theta is None:
            unaligned.append(f["pid"])
            theta = 0.0
        named = False
        for ev in f["obj"]["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = f["pid"]
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    named = True
            elif "ts" in ev:
                ev["ts"] = round(ev["ts"] - theta, 3)
            merged.append(ev)
        if not named:
            merged.append({"name": "process_name", "ph": "M",
                           "pid": f["pid"], "tid": 0,
                           "args": {"name": f["name"]}})
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    result = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "glt": {
            "merged_from": [f["path"] for f in files],
            "ref_pid": ref_pid,
            "clock_offsets_us": {str(f["pid"]):
                                 round(offsets.get(f["pid"], 0.0), 3)
                                 for f in files},
            "unaligned_pids": unaligned,
        },
    }
    if out is not None:
        # Atomic publish (GLT011): the merged trace is read by Perfetto /
        # the CLI while a re-merge may be running over the same path.
        tmp = f"{out}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(result, fh)
        os.replace(tmp, out)
    return result


def span_tree_check(merged: dict, tol_us: float = 0.0) -> List[str]:
    """Cross-process causality problems in a merged trace ([] = good).

    For every span with a REMOTE parent (``parent_span_id`` pointing at
    a span in a different process), check the child's interval nests
    within the parent's, allowing ``tol_us`` slack per edge for the
    residual clock-alignment error.  This is the merge-quality check the
    skew tests assert on.
    """
    spans: Dict[int, dict] = {}
    for ev in merged.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        sid = ev.get("args", {}).get("span_id")
        if sid is not None:
            spans[sid] = ev
    problems: List[str] = []
    checked = 0
    for ev in spans.values():
        pid = ev.get("args", {}).get("parent_span_id")
        parent = spans.get(pid)
        if parent is None or parent["pid"] == ev["pid"]:
            continue
        checked += 1
        lo, hi = parent["ts"], parent["ts"] + parent["dur"]
        if (ev["ts"] < lo - tol_us
                or ev["ts"] + ev["dur"] > hi + tol_us):
            problems.append(
                f"span {ev['name']!r} (pid {ev['pid']}) "
                f"[{ev['ts']:.1f}, {ev['ts'] + ev['dur']:.1f}] does not "
                f"nest in remote parent {parent['name']!r} "
                f"(pid {parent['pid']}) [{lo:.1f}, {hi:.1f}] "
                f"within {tol_us:.1f} us")
    if checked == 0:
        problems.append("no cross-process parent/child span pairs found")
    return problems
