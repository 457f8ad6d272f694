"""The harness finds its pieces by name, and BENCHMARK.json keeps its
fixed shape."""
import json
import os
import re
import shutil

from portbench import registry

ROOT = os.path.dirname(registry.HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return registry.bench(ROOT)


def test_every_named_piece_is_found():
    s = spec()
    for w in s["workloads"]:
        cfg = registry.config(s, ROOT, w["config"])
        mix = registry.mix(w["traffic"])
        assert registry.driver(mix["driver"]).run
        assert os.path.exists(os.path.join(registry.HERE, "limits",
                                           w["name"] + ".json"))
        assert cfg["graph"]["num_nodes"] > 0
    for m in s["end_to_end"] + s["per_layer"]:
        assert registry.reader(m["name"]) is not None, m["name"]


def test_names_units_and_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_each_cell_reports_setup_a_rate_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        e2e = {m["name"] for m in registry.metrics_of(s, w["name"], False)}
        per = registry.metrics_of(s, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e


def test_a_new_entry_is_picked_up_without_an_edit(tmp_path):
    here = tmp_path / "here"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "gather.rows_per_ms.new.py").write_text(
        "def read(rec, name):\n    return 2.0 * rec['x']\n")
    (here / "traffic" / "trickle.json").write_text(
        json.dumps({"driver": "batched_sample_gather", "batch_size": 8}))
    read = registry.reader("gather.rows_per_ms.new", str(here))
    assert read({"x": 3}, "gather.rows_per_ms.new") == 6.0
    assert registry.mix("trickle", str(here))["batch_size"] == 8
    # A split name falls back to its prefix's reader.
    assert registry.reader("device.idle.serve", str(here)) is not None
    assert registry.reader("no.such.metric", str(here)) is None
