"""The controls come out not correct against the cells' limits: the
reference in the program's place one precision down (fp8 matmuls for
the train cell, a bf16 gather for the sample cell), the planted faults
of a training step, and in both cells a draw that ignores its key.  At a size a CPU test holds; the readings
that set the limits come from the card (``portbench.calibrate``)."""
import time

import pytest
import torch

from portbench import check, faults, registry

SEEDS = (7, 2 ** 31 + 3, 40)


def controls(tiny_root, cell, seed):
    root, here = tiny_root
    spec = registry.bench(root)
    w = registry.cell(spec, cell)
    mix = registry.mix(w["traffic"], here)
    ctx = {"config": registry.config(spec, root, w["config"]), "mix": mix,
           "seed": seed, "seconds": 1.0, "trace": False,
           "device": torch.device("cpu"), "t_start": time.perf_counter(),
           "controls": True}
    rec = registry.driver(mix["driver"]).run(ctx)
    return rec, check.load_limits(cell, here)


def failed(numbers, limits):
    return [k for k, v in check.verdict(numbers, limits).items()
            if not v["ok"]]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_controls_fail(small_root, seed):
    rec, limits = controls(small_root, "sage-products.train", seed)
    assert not failed(rec["numbers"], limits)
    for name in ("fp8", "half_batch", "unchanged"):
        nums = dict(rec["numbers"], **rec["controls"][name])
        assert failed(nums, limits), (name, nums)


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_control_fails(tiny_root, seed):
    rec, limits = controls(tiny_root, "sage-papers100m.sample", seed)
    assert not failed(rec["numbers"], limits)
    assert failed(rec["controls"]["bf16"], limits) == ["x_max_diff"]


@pytest.mark.parametrize("cell", ("sage-products.train",
                                  "sage-papers100m.sample"))
def test_a_draw_that_ignores_the_key_fails(tiny_root, cell):
    with faults.planted("first_f"):
        rec, limits = controls(tiny_root, cell, SEEDS[0])
    assert {"bad_nodes", "bad_edges"} <= set(failed(rec["numbers"], limits))
