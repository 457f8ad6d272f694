"""No module of the benchmark brings in JAX or the JAX package, and the
reference brings in nothing of the program.  Top-level names (the part
before the first dot) are compared whole: ``glt_tpu_torch`` is not
``glt_tpu``."""
import json
import os
import subprocess
import sys

import portbench

HERE = os.path.dirname(portbench.__file__)
ROOT = os.path.dirname(HERE)

PROBE = r"""
import importlib, json, pkgutil, sys
import portbench
prefix = sys.argv[1]
names = [m.name for m in pkgutil.walk_packages(portbench.__path__,
                                               "portbench.")
         if m.name.startswith(prefix) and ".tests" not in m.name]
for n in names:
    importlib.import_module(n)
print(json.dumps({"imported": names,
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def probe(prefix: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", PROBE, prefix], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_module_brings_in_jax():
    got = probe("portbench")
    assert "portbench.run" in got["imported"]
    assert "portbench.drivers.scanned_node_train" in got["imported"]
    assert not {"jax", "jaxlib", "flax", "glt_tpu"} & set(got["top"])


def test_the_reference_brings_in_nothing_of_the_program():
    got = probe("portbench.reference")
    assert "portbench.reference.sage" in got["imported"]
    assert not {"jax", "jaxlib", "flax", "glt_tpu",
                "glt_tpu_torch"} & set(got["top"])


def test_every_metric_reader_is_plain():
    for f in os.listdir(os.path.join(HERE, "metrics")):
        text = open(os.path.join(HERE, "metrics", f)).read()
        assert "jax" not in text and "glt_tpu" not in text, f
