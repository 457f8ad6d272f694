"""The port's import rule: ``glt_tpu_torch`` and ``chip_smoke.py`` import
torch, numpy and the standard library only, and the port's linter
(``glt_tpu_torch/analysis``) the standard library only.

In a subprocess a meta-path finder refuses ``jax``, ``jaxlib``,
``glt_tpu`` and ``ml_dtypes`` (and their submodules) with ImportError;
then every module of ``glt_tpu_torch`` and ``chip_smoke`` must import.
In another it also refuses ``torch``, and the linter must import and
lint.
"""
import ast
import glob
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
# The multi-process slice's entry points.
from glt_tpu_torch.distributed.supervisor import (  # noqa: E402,F401
    BarrierTimeoutError, run_with_deadline)
# The sampling-service slice's entry points.
from glt_tpu_torch.channel import (  # noqa: E402,F401
    ShmChannel, bounded_get, bounded_put, deserialize, serialize)
from glt_tpu_torch.channel.native import ensure_built  # noqa: E402,F401
from glt_tpu_torch.data import (  # noqa: E402,F401
    attach_dataset, share_dataset)
from glt_tpu_torch.distributed import (  # noqa: E402,F401
    DistHeteroNeighborLoader, DistLinkNeighborLoader, DistNeighborLoader,
    DistServer, DistSubGraphLoader, MpSamplingWorkerOptions,
    RemoteNeighborLoader, RemoteServerConnection, batch_to_message,
    init_server)
from glt_tpu_torch.distributed.supervisor import (  # noqa: E402,F401
    HeartbeatSender, PeerDeadError, SupervisedExit, Supervisor,
    timed_barrier)
from glt_tpu_torch.obs.propagate import (  # noqa: E402,F401
    pack_trailer, split_trailer)
from glt_tpu_torch.serving.errors import (  # noqa: E402,F401
    SERVING_CODES, error_from_response)
# The serving and table-ingestion slice's entry points.
from glt_tpu_torch.serving import (  # noqa: E402,F401
    FleetController, FleetRouter, FleetSpec, InferenceClient, ServingFront,
    ShardTable, default_fleet_specs, retryable_transport)
from glt_tpu_torch.serving.router import shard_of  # noqa: E402,F401
from glt_tpu_torch.partition import (  # noqa: E402,F401
    DistRandomPartitioner, DistTableRandomPartitioner, hash_partition)
from glt_tpu_torch.data import (  # noqa: E402,F401
    ArrowFragmentAdapter, MockFragment, TableDataset, connect_fragment,
    fragment_to_dataset, load_edge_features, load_vertex_features, to_csr)
from glt_tpu_torch.parallel.multihost import (  # noqa: E402,F401
    Fleet, agree_max, agree_sum, assemble_global, barrier, feed_seeds,
    global_mesh, initialize, labels_global, local_shard_range,
    shard_feature_global, shard_graph_global, shard_hetero_graph_global,
    shutdown, transport_stats)
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

# The multi-process slice's modules: the deadline wrapper and the
# process-spanning mesh.
MULTIHOST_MODULES = (
    "glt_tpu_torch.distributed.supervisor",
    "glt_tpu_torch.parallel.multihost",
    "glt_tpu_torch.distributed.dist_dataset",
    "glt_tpu_torch.examples.dist_train_papers100m")

# The sampling-service slice's modules: the channel, trace propagation,
# shared datasets, the producer, loaders, server, client and supervisor,
# and the two twins.
SERVICE_MODULES = (
    "glt_tpu_torch.channel", "glt_tpu_torch.channel.base",
    "glt_tpu_torch.channel.native", "glt_tpu_torch.channel.serialization",
    "glt_tpu_torch.channel.shm_channel", "glt_tpu_torch.obs.propagate",
    "glt_tpu_torch.data.shared", "glt_tpu_torch.distributed.dist_options",
    "glt_tpu_torch.distributed.dist_context",
    "glt_tpu_torch.distributed.dist_sampling_producer",
    "glt_tpu_torch.distributed.dist_loader",
    "glt_tpu_torch.distributed.dist_server",
    "glt_tpu_torch.distributed.dist_client",
    "glt_tpu_torch.distributed.supervisor",
    "glt_tpu_torch.distributed.sample_message",
    "glt_tpu_torch.serving.errors",
    "glt_tpu_torch.examples.dist_train_sage_with_server",
    "glt_tpu_torch.examples.feature_mp")

# The serving and table-ingestion slice's modules: the serving front,
# client, router and fleet controller, the per-rank partitioners, table
# ingestion, the vineyard connector and the table twin.
SERVING_TABLE_MODULES = (
    "glt_tpu_torch.serving", "glt_tpu_torch.serving.options",
    "glt_tpu_torch.serving.front", "glt_tpu_torch.serving.client",
    "glt_tpu_torch.serving.router", "glt_tpu_torch.serving.fleet",
    "glt_tpu_torch.partition.dist_random_partitioner",
    "glt_tpu_torch.partition.dist_table_partitioner",
    "glt_tpu_torch.data.table_dataset", "glt_tpu_torch.data.vineyard",
    "glt_tpu_torch.examples.table_dataset_train")

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
    assert set(MULTIHOST_MODULES) <= walked, sorted(set(MULTIHOST_MODULES)
                                                    - walked)
    assert set(TIERED_MODULES) <= walked, sorted(set(TIERED_MODULES)
                                                 - walked)
    assert set(SERVICE_MODULES) <= walked, sorted(set(SERVICE_MODULES)
                                                  - walked)
    assert set(SERVING_TABLE_MODULES) <= walked, sorted(
        set(SERVING_TABLE_MODULES) - walked)
    assert set(DIST_WHOLE_MODULES) <= walked, sorted(
        set(DIST_WHOLE_MODULES) - walked)


_LINT_PROBE = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "glt_tpu", "ml_dtypes", "torch")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None


sys.meta_path.insert(0, Refuse())
from glt_tpu_torch.analysis import analyze_source, hazards
for hz in hazards.HAZARDS:
    (f,) = analyze_source(hz.source, "h.py")
    assert (f.code, f.line) == (hz.code, hz.line), f
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_analysis_imports_only_the_stdlib():
    """Every import of ``glt_tpu_torch/analysis`` is relative or of the
    standard library, and the linter runs with torch, jax and glt_tpu
    refused."""
    files = sorted(glob.glob(os.path.join(REPO, "glt_tpu_torch", "analysis",
                                          "*.py")))
    assert len(files) >= 14
    for path in files:
        roots = set(_imported_roots(path))
        assert roots <= set(sys.stdlib_module_names) | {"__future__"}, (
            path, sorted(roots - set(sys.stdlib_module_names)))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _LINT_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)


def test_smoke_and_linter_name_no_jax():
    """``chip_smoke.py`` and the linter import neither ``jax`` nor
    ``glt_tpu`` (the linter only names them in its docs and messages)."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + sorted(glob.glob(
        os.path.join(REPO, "glt_tpu_torch", "analysis", "*.py")))
    for path in paths:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "glt_tpu"}, path
