"""Readings that the limits of a cell are set from.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults a,b] --seconds <s> [--out <file>]

Runs the cell's driver once per seed in one process, each on its own
graph and weights, and prints one JSON line a seed: the numbers the
check compares for the program (their largest over sound runs is a
limit's lower reading) and, on the control seeds, the same numbers of
the control (the reference in the program's place at the precision
below the configuration's) and of the planted faults its driver module knows
(the smallest of those is the upper reading), and with ``--faults`` a
run of each control seed under each named fault of ``portbench.faults``
planted in the program.  A training cell needs no
window (``--seconds 0``); a sampling cell needs one long enough to make
the batches its check holds.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import faults, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    spec = registry.bench(root)
    w = registry.cell(spec, args.workload)
    cfg = registry.config(spec, root, w["config"])
    mix = registry.mix(w["traffic"])
    drv = registry.driver(mix["driver"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    seeds += sorted(controls - set(seeds))
    runs = [(s, None) for s in seeds] + [
        (s, f) for f in args.faults.split(",") if f for s in sorted(controls)]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed, fault in runs:
            t = time.perf_counter()
            ctx = {"config": cfg, "mix": mix, "seed": seed,
                   "seconds": args.seconds, "trace": False,
                   "device": torch.device("cuda"), "t_start": t,
                   "controls": seed in controls and fault is None}
            if fault is None:
                rec = drv.run(ctx)
            else:
                with faults.planted(fault):
                    rec = drv.run(ctx)
            line = json.dumps({
                "workload": args.workload, "seed": seed, "fault": fault,
                "numbers": rec["numbers"], "controls": rec["controls"],
                "setup_s": rec["setup_s"], "node_capacity":
                rec["node_capacity"], "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            del rec
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
