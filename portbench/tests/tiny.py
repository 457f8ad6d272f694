"""A checkout-shaped directory holding the two cells at a size the CPU
runs in seconds: the same names, drivers and readers, a graph of a few
thousand nodes, narrow widths, small batches."""
from __future__ import annotations

import copy
import json
import os
import shutil

from portbench import registry

ROOT = os.path.dirname(registry.HERE)

TINY_GRAPH = {"num_nodes": 3000, "num_edges": 30000, "feature_dim": 8,
              "num_classes": 5, "train_nodes": 1200}
TINY_MODEL = {"hidden": 16}
TINY_MIX = {"batch_size": 32, "group": 4, "fanout": [4, 3, 2],
            "trace_blocks": 2, "check_blocks_within": 4}
TINY_CAP = {"batches": 6}

#: The size the controls are judged at: the train cell's widths (100 in,
#: 256 hidden, 47 out) and fanouts on a graph the CPU holds, where bf16
#: rounding reads as it does at the cell's size.
SMALL_GRAPH = {"num_nodes": 20000, "num_edges": 1000000, "train_nodes": 4000}
SMALL_MIX = {"batch_size": 256, "group": 2, "fanout": [15, 10, 5],
             "trace_blocks": 1, "check_blocks_within": 2}


def make(tmp: str, graph: dict = TINY_GRAPH, model: dict = TINY_MODEL,
         mix_over: dict = TINY_MIX) -> tuple:
    """``(root, here)``: a root with ``BENCHMARK.json`` and tiny
    configurations, and a ``here`` with the tiny mixes and the real
    limits."""
    root = os.path.join(tmp, "root")
    here = os.path.join(tmp, "here")
    os.makedirs(os.path.join(root, "configs"))
    for sub in ("traffic", "limits"):
        os.makedirs(os.path.join(here, sub))
    spec = registry.bench(ROOT)
    for c in spec["configs"]:
        cfg = registry.load_json(os.path.join(ROOT, c["file"]))
        cfg["graph"].update(graph)
        if "model" in cfg:
            cfg["model"].update(model)
        c["file"] = os.path.join("configs", os.path.basename(c["file"]))
        with open(os.path.join(root, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    for w in spec["workloads"]:
        mix = copy.deepcopy(registry.mix(w["traffic"]))
        mix.update(mix_over)
        mix["node_capacity"].update(TINY_CAP)
        with open(os.path.join(here, "traffic", w["traffic"] + ".json"),
                  "w") as fh:
            json.dump(mix, fh)
        shutil.copy(os.path.join(registry.HERE, "limits", w["name"] + ".json"),
                    os.path.join(here, "limits"))
    return root, here
