"""The hetero train cell on the CPU at a tiny size: a sound run comes
out correct, and each planted fault of ``faults_hetero`` moves the
check's numbers."""
import json
import os
import shutil
import time

import pytest

from portbench import faults_hetero, registry, run
from portbench.tests.tiny import ROOT

CELL = "rgat-igbh.hetero_train"
LAW = {"kind": "pareto", "alpha": 1.8, "dmax": 500}


@pytest.fixture(scope="module")
def hetero_root(tmp_path_factory):
    """``(root, here)`` holding the cell at 6,440 nodes, in 16 wide (f32),
    hidden 16, batch 32, fanout [4, 3, 2], G = 4."""
    tmp = str(tmp_path_factory.mktemp("portbench_hetero"))
    root, here = os.path.join(tmp, "root"), os.path.join(tmp, "here")
    os.makedirs(os.path.join(root, "configs"))
    for sub in ("traffic", "limits"):
        os.makedirs(os.path.join(here, sub))
    spec = registry.bench(ROOT)
    for c in spec["configs"]:
        cfg = registry.load_json(os.path.join(ROOT, c["file"]))
        if c["name"] == "rgat-igbh":
            g = cfg["graph"]
            g.update(node_types={"paper": 3000, "author": 3100,
                                 "institute": 40, "fos": 300},
                     feature_dim=16, num_classes=7, feature_dtype="float32")
            for r, e in zip(g["relations"], (44500, 8000, 520, 11700)):
                r.update(num_edges=e, degree_law=LAW)
            cfg["model"].update(hidden=16, matmul_dtype="float32")
        c["file"] = os.path.join("configs", os.path.basename(c["file"]))
        with open(os.path.join(root, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    mix = registry.mix("hetero_train")
    mix.update(batch_size=32, group=4, fanout=[4, 3, 2], trace_blocks=1)
    mix["node_capacity"].update(batches=6, multiple=8)
    with open(os.path.join(here, "traffic", "hetero_train.json"), "w") as fh:
        json.dump(mix, fh)
    shutil.copy(os.path.join(registry.HERE, "limits", CELL + ".json"),
                os.path.join(here, "limits"))
    return root, here


def execute(hetero_root, seconds=1.0):
    root, here = hetero_root
    return run.execute(root, CELL, 2 ** 31 + 7, seconds, False, "cpu",
                       time.perf_counter(), here)


def test_sound_run_and_its_line(hetero_root):
    out = execute(hetero_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    assert {"train_seeds_per_s", "setup_s"} <= set(out["metrics"])
    assert set(out["run"]["node_capacity"]) == {"author", "fos",
                                                "institute", "paper"}


NUMBERS = ("grad_gap", "grad_err", "change_gap", "change_err")


@pytest.mark.parametrize("fault", sorted(faults_hetero.FAULTS))
def test_a_planted_fault_moves_the_check(hetero_root, fault):
    """At this size the model runs in f32, so a sound run reads round-off
    and the limits (set at the cell's bf16) are loose: each fault moves
    some compared number ten times past the sound run's."""
    sound = execute(hetero_root, seconds=0.0)["checks"]
    with faults_hetero.planted(fault):
        got = execute(hetero_root, seconds=0.0)["checks"]
    ratio = max(got[k]["value"] / max(sound[k]["value"], 1e-12)
                for k in NUMBERS)
    assert ratio > 10, (got, sound)


def test_rgnn_flops_counts_the_first_layer_backward_once():
    """Two layers over two relations, counted by hand: the first layer's
    backward is its weight gradients alone, the others' twice their
    forward."""
    from portbench import roofline_hetero

    levels = {"paper": [2, 3], "author": [0, 4]}
    rels = [("author", "w", "paper"), ("paper", "c", "paper")]
    first = 2 * (9 * 2 * 8 * 4 + 5 * 2 * 8 * 4)     # weight grads: x 2
    second = 3 * (6 * 2 * 4 * 4 + 5 * 2 * 4 * 4)    # input grads too: x 3
    head = 3 * 2 * 2 * 4 * 3
    got = roofline_hetero.rgnn_flops(levels, rels, [8, 4], 4, 3, 2)
    assert got == first + second + head == 2992
