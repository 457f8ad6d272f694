"""The port's import rule: ``glt_tpu_torch`` and ``chip_smoke.py`` import
torch, numpy and the standard library only.

In a subprocess a meta-path finder refuses ``jax``, ``jaxlib``,
``glt_tpu`` and ``ml_dtypes`` (and their submodules) with ImportError;
then every module of ``glt_tpu_torch`` and ``chip_smoke`` must import.
"""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "glt_tpu", "ml_dtypes")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None


for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        raise SystemExit(f"{mod} was imported before the check")
sys.meta_path.insert(0, Refuse())
import glt_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    glt_tpu_torch.__path__, "glt_tpu_torch."))
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
# The host-tiered and edge-sampling slice's entry points.
from glt_tpu_torch.parallel import (  # noqa: E402,F401
    DistNeighborSampler, HostColdStore, TieredShardedFeature,
    TieredTrainPipeline, dist_edge_exists, dist_node_subgraph,
    make_tiered_train_step, shard_feature_tiered_from_store)
from glt_tpu_torch.store import DiskColdStore  # noqa: E402,F401
# The distributed-whole slice's entry points.
from glt_tpu_torch.parallel import (  # noqa: E402,F401
    DistHeteroNeighborSampler, HeteroTieredTrainPipeline,
    global_mesh_2d, init_hetero_dist_state, make_hetero_dist_train_step,
    make_hetero_tiered_train_step, shard_hetero_graph)
assert hasattr(DistNeighborSampler, "sample_from_edges")
assert hasattr(DistNeighborSampler, "subgraph")
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print(" ".join(names))
print(len(names))
"""

# The link and subgraph slice's modules, which the walk must reach.
LINK_MODULES = (
    "glt_tpu_torch.ops.negative_sample", "glt_tpu_torch.ops.stitch",
    "glt_tpu_torch.loader.link_loader", "glt_tpu_torch.loader.subgraph_loader",
    "glt_tpu_torch.examples.datasets",
    "glt_tpu_torch.examples.graph_sage_unsup_ppi",
    "glt_tpu_torch.examples.seal_link_pred")
# The one-program slice's modules.
GRAPH_MODULES = ("glt_tpu_torch.utils.graphs", "glt_tpu_torch.ckpt",
                 "glt_tpu_torch.ckpt.state")
# The heterogeneous slice's modules.
HETERO_MODULES = (
    "glt_tpu_torch.typing", "glt_tpu_torch.data.dataset",
    "glt_tpu_torch.sampler.hetero_neighbor_sampler",
    "glt_tpu_torch.loader.hetero_neighbor_loader",
    "glt_tpu_torch.loader.hetero_link_loader",
    "glt_tpu_torch.models.gat", "glt_tpu_torch.models.rgat",
    "glt_tpu_torch.models.hgt", "glt_tpu_torch.models.convert",
    "glt_tpu_torch.distributed.sample_message",
    "glt_tpu_torch.examples.hetero", "glt_tpu_torch.examples.train_hgt_mag",
    "glt_tpu_torch.examples.rgat_igbh")

# The checkpoint and observability slice's modules.
CKPT_OBS_MODULES = (
    "glt_tpu_torch.ckpt.store", "glt_tpu_torch.ckpt.driver",
    "glt_tpu_torch.testing", "glt_tpu_torch.testing.faults",
    "glt_tpu_torch.obs", "glt_tpu_torch.obs.__main__") + tuple(
    f"glt_tpu_torch.obs.{m}" for m in (
        "metrics", "flight", "trace", "summarize", "merge", "slo",
        "device", "compilewatch", "profiler", "roofline", "attrib"))

# The distributed slice's modules.
DIST_MODULES = (
    "glt_tpu_torch.partition", "glt_tpu_torch.partition.base",
    "glt_tpu_torch.partition.random_partitioner",
    "glt_tpu_torch.partition.frequency_partitioner",
    "glt_tpu_torch.partition.contiguous", "glt_tpu_torch.parallel",
    "glt_tpu_torch.parallel.multihost", "glt_tpu_torch.parallel.sharding",
    "glt_tpu_torch.parallel.dist_sampler",
    "glt_tpu_torch.parallel.dist_feature",
    "glt_tpu_torch.parallel.dist_train",
    "glt_tpu_torch.distributed.dist_dataset",
    "glt_tpu_torch.examples.partition_dataset",
    "glt_tpu_torch.examples.dist_train_papers100m")

# The host-tiered and edge-sampling slice's modules (the probe also
# imports their entry points under the refusing finder).
TIERED_MODULES = (
    "glt_tpu_torch.store.stager", "glt_tpu_torch.parallel.dist_feature",
    "glt_tpu_torch.parallel.dist_train", "glt_tpu_torch.parallel.dist_sampler",
    "glt_tpu_torch.distributed.dist_dataset",
    "glt_tpu_torch.examples.dist_train_papers100m")

# The distributed-whole slice's modules: hetero graphs across shards,
# the 2-D mesh's hierarchical route and the ring.
DIST_WHOLE_MODULES = (
    "glt_tpu_torch.parallel.dist_hetero_sampler",
    "glt_tpu_torch.parallel.multihost", "glt_tpu_torch.parallel.dist_sampler",
    "glt_tpu_torch.examples.rgat_igbh")

# The scanned-steps slice's example twins.
TWIN_MODULES = (
    "glt_tpu_torch.examples.train_sage_products",
    "glt_tpu_torch.examples.bipartite_sage_unsup",
    "glt_tpu_torch.examples.dist_train_sage")


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # every subpackage was walked (store, refresh, ops, data, ...)
    assert int(proc.stdout.split()[-1]) >= 40, proc.stdout
    walked = set(proc.stdout.splitlines()[-2].split())
    assert set(LINK_MODULES) <= walked, sorted(set(LINK_MODULES) - walked)
    assert set(GRAPH_MODULES) <= walked, sorted(set(GRAPH_MODULES) - walked)
    assert set(HETERO_MODULES) <= walked, sorted(set(HETERO_MODULES)
                                                 - walked)
    assert set(CKPT_OBS_MODULES) <= walked, sorted(set(CKPT_OBS_MODULES)
                                                   - walked)
    assert set(DIST_MODULES) <= walked, sorted(set(DIST_MODULES) - walked)
    assert set(TWIN_MODULES) <= walked, sorted(set(TWIN_MODULES) - walked)
    assert set(TIERED_MODULES) <= walked, sorted(set(TIERED_MODULES)
                                                 - walked)
    assert set(DIST_WHOLE_MODULES) <= walked, sorted(
        set(DIST_WHOLE_MODULES) - walked)
