"""Find a cell's pieces by the names ``BENCHMARK.json`` gives.

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json``, data only;
* a driver: ``drivers/<name>.py``, named by the mix's ``driver`` key;
* a metric's reader: ``metrics/<name>.py``, or for a name split by the
  cells it serves (``kern.b1_roofline.train``) the file of its longest
  dotted prefix that has one (``metrics/kern.b1_roofline.py``);
* a cell's limits: ``limits/<cell>.json``.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def bench(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, root: str, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, here: str = HERE) -> dict:
    return load_json(os.path.join(here, "traffic", f"{name}.json"))


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def reader(name: str, here: str = HERE) -> Optional[Callable]:
    """The ``read(rec, name)`` of the metric's reader, or None."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(here, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "portbench_metric_" + ".".join(parts[:n]).replace(".", "_")
                .replace("-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    return None


def metrics_of(spec: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of the cell reports: with ``trace`` the
    per-layer ones, else the end-to-end ones."""
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if cell_name in m.get("workloads", [cell_name]):
            out.append(m)
    return out
