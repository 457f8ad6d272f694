"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``glt_tpu_torch``).  The run makes its graph, features,
labels and weights from ``--seed`` on the card, builds and warms the
system (set-up), measures for ``--seconds``, reads the peak memory, then
judges what the timed path produced against the plain reference.  With
``--trace 1`` a stretch of the window runs under ``torch.profiler`` and
the line carries the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error
and the last key of that object.  Without a CUDA card holding as many
devices as the cell asks for, or with JAX loaded, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

from . import check, registry  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "glt_tpu")


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    program's nvcc output already lands in ``build/glt_tpu_torch``)."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def execute(root: str, workload: str, seed: int, seconds: float,
            trace: bool, device: str, t_start: float,
            here: str = registry.HERE) -> dict:
    """One run of the cell on ``device``; returns the result object.
    The command line allows only the card; the tests call this on the
    CPU at tiny sizes, with mixes and limits from ``here``."""
    import torch

    spec = registry.bench(root)
    w = registry.cell(spec, workload)
    cfg = registry.config(spec, root, w["config"])
    mix = registry.mix(w["traffic"], here)
    limits = check.load_limits(workload, here)
    dev = torch.device(device)
    ctx = {"config": cfg, "mix": mix, "seed": seed, "seconds": seconds,
           "trace": trace, "device": dev, "t_start": t_start}
    rec = registry.driver(mix["driver"]).run(ctx)
    verdict = check.verdict(rec["numbers"], limits)
    metrics = {}
    for m in registry.metrics_of(spec, workload, trace):
        read = registry.reader(m["name"])
        value = None if read is None else read(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(v["ok"] for v in verdict.values()),
           "attempted": rec["batches"], "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": rec["peak_bytes"]}}
    tr = rec.get("trace")
    if trace and tr and "busy_s" in tr:
        out["device"]["busy_s"] = tr["busy_s"]
        out["device"]["window_s"] = tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    ms = sorted(rec["block_ms"])
    out["run"] = {"setup_s": rec["setup_s"], "window_s": rec["window_s"],
                  "batches": rec["batches"], "blocks": len(ms),
                  "block_ms": {q: ms[min(len(ms) - 1, int(q / 100 * len(ms)))]
                               for q in (5, 50, 90, 95, 99, 100)} if ms
                  else {},
                  "node_capacity": rec["node_capacity"]}
    out["checks"] = {k: {"value": _plain(v["value"]),
                         "limit": _plain(v["limit"])}
                     for k, v in verdict.items()}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    root = os.getcwd()
    cache_dirs(root)
    import torch

    spec = registry.bench(root)
    chips = int(registry.cell(spec, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = execute(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}; the port must not bring in JAX",
              file=sys.stderr)
        return 3
    run = dict(out["run"], power_limit=power_limit())
    print("portbench: " + json.dumps(run), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line_of(out)))
    sys.stdout.flush()
    return 0


def line_of(out: dict) -> dict:
    """The result line: its fixed keys in order, the checks last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in out:
        keys.append("breakdown")
    return {k: out[k] for k in keys + ["checks"]}


def _plain(v):
    """A number for the line: non-finite ones as text (JSON has none)."""
    v = float(v)
    return v if math.isfinite(v) else str(v)


if __name__ == "__main__":
    sys.exit(main())
