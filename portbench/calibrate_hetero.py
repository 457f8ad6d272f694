"""One reading that the limits of the hetero train cell are set from:
:mod:`.calibrate`'s line for one seed, in a process of its own.

    python3 -m portbench.calibrate_hetero --workload rgat-igbh.hetero_train \\
        --seed <n> [--controls 1] [--fault <name>] [--out <file>]

Runs the cell's driver once without a window on its own graph and
weights and prints one JSON line: the numbers the check compares for the
program, with ``--controls 1`` also those of the fp8 control, and with
``--fault`` those under one fault of :mod:`.faults_hetero` planted in
the program.  One run a process: a process that has captured a block at
this cell's size does not get all of that memory back for the next
run's capture.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from . import faults_hetero, registry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--controls", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate_hetero: no CUDA device", file=sys.stderr)
        return 2
    root = os.getcwd()
    spec = registry.bench(root)
    cfg = registry.config(spec, root,
                          registry.cell(spec, args.workload)["config"])
    mix = registry.mix(registry.cell(spec, args.workload)["traffic"])
    t = time.perf_counter()
    ctx = {"config": cfg, "mix": mix, "seed": args.seed, "seconds": 0.0,
           "trace": False, "device": torch.device("cuda"), "t_start": t,
           "controls": bool(args.controls) and args.fault is None}
    with (faults_hetero.planted(args.fault) if args.fault
          else contextlib.nullcontext()):
        rec = registry.driver(mix["driver"]).run(ctx)
    line = json.dumps({
        "workload": args.workload, "seed": args.seed, "fault": args.fault,
        "numbers": rec["numbers"], "controls": rec["controls"],
        "setup_s": rec["setup_s"], "node_capacity": rec["node_capacity"],
        "seconds": time.perf_counter() - t})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
