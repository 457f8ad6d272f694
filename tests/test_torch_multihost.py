"""The port's process-spanning mesh against its in-process mesh and
glt_tpu's, on the CPU (the twin of ``tests/test_multihost.py``).

Real OS processes form one mesh over ``torch.distributed`` with gloo:
2 processes x 4 ``"cpu"`` shards (an 8-shard mesh) and 4 processes x 1
shard on the 2 x 2 ``(host, chip)`` mesh.  This file is its own worker
(``python tests/test_torch_multihost.py <fleet> <out dir>``, the
rendezvous from ``MASTER_ADDR``/``MASTER_PORT``, ``GLT_NUM_PROCESSES``
and ``GLT_PROCESS_ID``), and a worker imports torch, numpy and the port
only.  Every fleet's losses are identical across its processes; the
2-process fleet's are within 1e-5 of the port's in-process 8-shard run
and of ``glt_tpu``'s ``run_steps`` on the suite's 8 virtual devices,
from the same parameters, with every shard's sampled batch ``==`` the
in-process one; the hetero and the ``DistDataset.load(mesh=)`` + tiered
pipeline fleets match the in-process runs within 1e-5; the 4-process
fleet's hierarchical route is bit-equal to the flat one (losses and a
sha256 of the parameters); a straggler turns every peer's barrier into
a ``BarrierTimeoutError`` at the deadline.  The one-process cases and
the contiguity error of ``local_shard_range`` need no fleet.
"""
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]

from _multihost_worker import build_fixture  # noqa: E402  (no jax)

from glt_tpu_torch import random as trandom  # noqa: E402
from glt_tpu_torch.data import CSRTopo  # noqa: E402
from glt_tpu_torch.distributed import DistDataset  # noqa: E402
from glt_tpu_torch.distributed.supervisor import (  # noqa: E402
    BarrierTimeoutError, run_with_deadline)
from glt_tpu_torch.models import RGAT, GraphSAGE, adam  # noqa: E402
from glt_tpu_torch.parallel import (  # noqa: E402
    DistHeteroNeighborSampler, DistNeighborSampler,
    HeteroTieredTrainPipeline, Mesh, TieredTrainPipeline,
    build_hier_routing, init_dist_state, init_hetero_dist_state,
    make_dist_train_step, make_hetero_dist_train_step,
    make_hetero_tiered_train_step, make_tiered_train_step, multihost,
    shard_feature_tiered, shard_graph)
from glt_tpu_torch.parallel.dist_train import sample_and_gather  # noqa: E402

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

STEPS, FANOUTS, BS, HIDDEN, LR = 3, [2, 2], 4, 16, 1e-3
DEADLINE_S, STRAGGLE_S = 2.0, 3.5
ET_UI = ("user", "clicks", "item")
ET_IU = ("item", "rev_clicks", "user")


def _key(i):
    return trandom.PRNGKey(i, device="cpu")


def _digest(model) -> str:
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.numpy().tobytes())
    return h.hexdigest()


# -- the runs, one process or a fleet ---------------------------------------

def run_steps(mesh, params, steps=STEPS):
    """``_multihost_worker.run_steps`` on the port: the ring fixture fed
    per process, ``steps`` distributed steps from ``params``.  Returns
    the losses and, per global shard and step, the sampled node ids."""
    edge_index, n, feat, labels, classes, seeds = build_fixture(mesh.size)
    topo = CSRTopo(edge_index, num_nodes=n)
    g = multihost.shard_graph_global(topo, mesh)
    f = multihost.shard_feature_global(feat, mesh)
    lab = multihost.labels_global(labels, mesh, g.nodes_per_shard)
    model = GraphSAGE(feat.shape[1], HIDDEN, classes, num_layers=2,
                      dropout_rate=0.0)
    model.load_state_dict(params)
    state = init_dist_state(model, adam(LR), g, f, FANOUTS, BS)
    step = make_dist_train_step(g, f, lab, mesh, FANOUTS, BS)
    losses, nodes = [], {}
    for i in range(steps):
        sd = multihost.feed_seeds(seeds, mesh)
        _, outs, _ = sample_and_gather(g, f, lab, torch.from_numpy(sd).int(),
                                       _key(i + 1), FANOUTS)
        for s, o in zip(mesh.local, outs):
            nodes[f"{i}_{s}"] = o.node.numpy()
        state, loss, _ = step(state, sd, _key(i + 1))
        losses.append(float(loss))
    return losses, nodes


def run_variants(mesh, params):
    """The other exchanges of the data plane on the ring fixture: a
    ring-collective batch, strict binary seed edges, induced subgraphs
    (per global shard, their arrays) and the scanned step's losses."""
    from glt_tpu_torch.parallel import (make_scanned_dist_train_step,
                                        run_scanned_dist_epoch)
    from glt_tpu_torch.sampler import NegativeSampling

    edge_index, n, feat, labels, classes, seeds = build_fixture(mesh.size)
    topo = CSRTopo(edge_index, num_nodes=n)
    g = multihost.shard_graph_global(topo, mesh)
    f = multihost.shard_feature_global(feat, mesh)
    lab = multihost.labels_global(labels, mesh, g.nodes_per_shard)
    arrays = {}

    def keep(name, out, fields):
        for j, s in enumerate(mesh.local):
            for fld in fields:
                v = getattr(out, fld, None)
                if v is None:
                    v = out.metadata[fld]
                arrays[f"{name}_{s}_{fld}"] = v[j].numpy()

    ring = DistNeighborSampler(g, mesh, num_neighbors=FANOUTS,
                               batch_size=BS, collective="ring")
    keep("ring", ring.sample_from_nodes(seeds, key=_key(21)),
         ("node", "row", "col", "edge"))
    samp = DistNeighborSampler(g, mesh, num_neighbors=FANOUTS, batch_size=BS)
    src = edge_index[0, :mesh.size * BS].reshape(mesh.size, BS)
    dst = edge_index[1, :mesh.size * BS].reshape(mesh.size, BS)
    keep("edges", samp.sample_from_edges(src, dst, NegativeSampling(
        "binary", 1), key=_key(22), strict=True),
        ("node", "row", "col", "edge_label_index", "edge_label"))
    keep("subgraph", samp.subgraph(seeds, max_degree=4, key=_key(23)),
         ("node", "row", "col", "edge"))
    model = GraphSAGE(feat.shape[1], HIDDEN, classes, num_layers=2,
                      dropout_rate=0.0)
    model.load_state_dict(params)
    state = init_dist_state(model, adam(LR), g, f, FANOUTS, BS)
    step = make_scanned_dist_train_step(g, f, lab, mesh, FANOUTS, BS)
    _, losses, _ = run_scanned_dist_epoch(
        step, state, np.arange(n // 2), mesh.size, BS, 2,
        np.random.default_rng(0), _key(24))
    return arrays, [float(x) for x in losses]


def hetero_fixture(n_dev, topo_cls=CSRTopo):
    """``_multihost_worker.run_hetero_steps``' bipartite user/item graph:
    ``(topos, feats, user labels, classes, seeds)``, the topologies of
    ``topo_cls``."""
    num_u, num_i, classes = 8 * n_dev, 4 * n_dev, 4
    labels_u = (np.arange(num_u) % classes).astype(np.int32)
    u_src = np.repeat(np.arange(num_u), 2)
    i_dst = np.concatenate([[u % num_i, (u + 1) % num_i]
                            for u in range(num_u)])
    topos = {ET_UI: topo_cls(np.stack([u_src, i_dst]), num_nodes=num_u),
             ET_IU: topo_cls(np.stack([i_dst, u_src]), num_nodes=num_i)}
    feats = {"user": np.eye(classes, dtype=np.float32)[labels_u],
             "item": np.eye(classes, dtype=np.float32)[
                 np.arange(num_i) % classes]}
    seeds = np.stack([np.arange(s * 8, s * 8 + BS)
                      for s in range(n_dev)]).astype(np.int32)
    return topos, feats, labels_u, classes, seeds


def run_hetero_steps(mesh, params, steps=2):
    """``_multihost_worker.run_hetero_steps`` on the port, then the same
    steps through ``HeteroTieredTrainPipeline`` with half of each
    shard's items in host memory.  Returns both runs' losses."""
    topos, feats_np, labels_u, classes, seeds = hetero_fixture(mesh.size)
    sharded = multihost.shard_hetero_graph_global(topos, mesh)
    feats = {t: multihost.shard_feature_global(x, mesh)
             for t, x in feats_np.items()}
    lab = multihost.labels_global(labels_u, mesh,
                                  feats["user"].nodes_per_shard)
    samp = DistHeteroNeighborSampler(sharded, mesh, FANOUTS, "user",
                                     batch_size=BS, frontier_cap=16, seed=0)
    model = RGAT([ET_IU, ET_UI], {"user": classes, "item": classes}, 8,
                 classes, "user", num_layers=2, conv="gat", dropout_rate=0.0)
    model.load_state_dict(params)
    state = init_hetero_dist_state(model, adam(LR), samp, feats)
    step = make_hetero_dist_train_step(samp, feats, lab, mesh, BS)
    losses = []
    for i in range(steps):
        state, loss, _ = step(state, multihost.feed_seeds(seeds, mesh),
                              _key(5 + i))
        losses.append(float(loss))
    full = shard_feature_tiered(feats_np["item"], mesh.size, 0.5,
                                device="cpu")
    lo, hi = mesh.local.start, mesh.local.stop
    tfeats = dict(feats, item=full._replace(hot=full.hot[lo:hi],
                                            cold=full.cold[lo:hi]))
    model.load_state_dict(params)
    state = init_hetero_dist_state(model, adam(LR), samp, tfeats)
    pipe = HeteroTieredTrainPipeline(
        samp, make_hetero_tiered_train_step(samp, tfeats, lab, mesh, BS),
        tfeats, mesh, stage_threads=1)
    _, tiered, _ = pipe.run_epoch(state, [seeds] * steps, _key(7))
    pipe.close()
    return losses, [float(x) for x in tiered]


def run_dataset_steps(mesh, params, part_dir, steps=2):
    """``_multihost_worker.run_dataset_steps`` on the port: the load per
    process on a spanning mesh (the plain load in one process), then
    the tiered pipeline."""
    edge_index, n, feat, labels, classes, seeds = build_fixture(mesh.size)
    if mesh.spans:
        ds = DistDataset.load(part_dir, hot_ratio=0.5, labels=labels,
                              mesh=mesh)
    else:
        ds = DistDataset.load(part_dir, hot_ratio=0.5, labels=labels,
                              device="cpu")
    model = GraphSAGE(feat.shape[1], HIDDEN, classes, num_layers=2,
                      dropout_rate=0.0)
    model.load_state_dict(params)
    state = init_dist_state(model, adam(LR), ds.graph, ds.feature, FANOUTS,
                            BS)
    sampler = DistNeighborSampler(ds.graph, mesh, num_neighbors=FANOUTS,
                                  batch_size=BS, seed=0)
    train = make_tiered_train_step(ds.graph, ds.feature, ds.labels, mesh, BS)
    pipe = TieredTrainPipeline(sampler, train, ds.feature, mesh,
                               stage_threads=1)
    batches = ds.split_seeds(np.arange(n), BS, shuffle=True, seed=3)
    state, losses, _ = pipe.run_epoch(state, list(batches[:steps]), _key(9))
    pipe.close()
    return [float(x) for x in losses]


def run_hier_steps(mesh, params, steps=2):
    """``_multihost_worker.run_hier_steps`` on the port: both routes from
    one set of parameters on a 2-D mesh, a padded slot riding every
    step; an all-padded step after; the byte models; the dedup of a
    zipf-skewed frontier."""
    h, c = mesh.shape["host"], mesh.shape["chip"]
    edge_index, n, feat, labels, classes, seeds = build_fixture(mesh.size)
    seeds = seeds.copy()
    seeds[0, -1] = -1
    topo = CSRTopo(edge_index, num_nodes=n)
    g = multihost.shard_graph_global(topo, mesh)
    f = multihost.shard_feature_global(feat, mesh)
    lab = multihost.labels_global(labels, mesh, g.nodes_per_shard)
    out = {}
    for route in ("flat", "hier"):
        model = GraphSAGE(feat.shape[1], HIDDEN, classes, num_layers=2,
                          dropout_rate=0.0)
        model.load_state_dict(params)
        state = init_dist_state(model, adam(LR), g, f, FANOUTS, BS)
        step = make_dist_train_step(g, f, lab, mesh, FANOUTS, BS,
                                    route=route)
        out[f"bytes_{route}"] = dict(step.collective_bytes)
        losses = []
        for i in range(steps):
            state, loss, _ = step(state, multihost.feed_seeds(seeds, mesh),
                                  _key(i + 1))
            losses.append(float(loss))
        out[route] = losses
        out[f"digest_{route}"] = before = _digest(state.model)
        pad = multihost.feed_seeds(np.full_like(seeds, -1), mesh)
        st2, _, _ = step(state, pad, _key(99))
        out[f"pad_noop_{route}"] = (_digest(st2.model) == before
                                    and st2.step == state.step)
    rng = np.random.default_rng(0)
    zipf = np.minimum(rng.zipf(1.5, size=(mesh.size, 32)).astype(np.int32)
                      - 1, n - 1)
    hr = build_hier_routing(
        list(torch.from_numpy(multihost.feed_seeds(zipf, mesh))),
        g.nodes_per_shard, h, c)
    counts = multihost.agree_sum(np.array([
        sum(int((p.base.buckets >= 0).sum()) for p in hr),
        sum(int((p.uniq >= 0).sum()) for p in hr)], np.int64))
    out["dedup_factor"] = float(counts[0]) / float(max(counts[1], 1))
    return out


def barrier_probe() -> dict:
    """Every process joins one barrier; then process 0 straggles and the
    others' barrier must end at its deadline in a BarrierTimeoutError."""
    multihost.barrier("fleet-up")
    if multihost.process_index() == 0:
        time.sleep(STRAGGLE_S)
        return {"timed_out": False}
    t0 = time.monotonic()
    try:
        multihost.barrier("fleet-late", timeout_s=DEADLINE_S)
        timed_out = False
    except BarrierTimeoutError:
        timed_out = True
    return {"timed_out": timed_out, "waited_s": time.monotonic() - t0}


# -- the worker ---------------------------------------------------------------

def worker(fleet: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    multihost.initialize()
    rank = multihost.process_index()
    params = torch.load(os.path.join(out_dir, "params.pt"))
    res = {"rank": rank}
    if fleet == "two":
        mesh = multihost.global_mesh(["cpu"] * 4)
        res["local"] = [mesh.local.start, mesh.local.stop]
        res["losses"], nodes = run_steps(mesh, params["sage"])
        res["transport"] = multihost.transport_stats()
        np.savez(os.path.join(out_dir, f"nodes_{rank}.npz"), **nodes)
        arrays, res["scanned"] = run_variants(mesh, params["sage"])
        np.savez(os.path.join(out_dir, f"variants_{rank}.npz"), **arrays)
        res["hetero"] = run_hetero_steps(mesh, params["rgat"])
        res["dataset"] = run_dataset_steps(
            mesh, params["sage"], os.path.join(out_dir, "parts"))
        try:
            multihost.global_mesh_2d(["cpu"] * 3, num_hosts=3)
            res["straddle"] = None
        except ValueError as exc:
            res["straddle"] = str(exc)
        multihost.barrier("two-done")
        print(json.dumps(res), flush=True)
        multihost.shutdown()
        return
    mesh = multihost.global_mesh_2d(["cpu"], num_hosts=2)
    res["shape"] = dict(mesh.shape)
    res.update(run_hier_steps(mesh, params["sage"]))
    res.update(barrier_probe())
    print(json.dumps(res), flush=True)
    # A timed-out barrier's thread never returns: end here.
    os._exit(0)


# -- the fleets ---------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fleet: str, nproc: int, out_dir: str, timeout: float = 150):
    """Run ``nproc`` workers; every one must succeed (the siblings of a
    failed or late one are killed).  Returns their results by rank."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "GLT_COORDINATOR_ADDR")}
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                GLT_NUM_PROCESSES=str(nproc), OMP_NUM_THREADS="1",
                PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), fleet, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(base, GLT_PROCESS_ID=str(r))) for r in range(nproc)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    outs = []
    for r, (p, (out, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"worker {r} failed:\n{err[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("{")][-1]
        outs.append(json.loads(line))
    return sorted(outs, key=lambda o: o["rank"])


@pytest.fixture(scope="module")
def params():
    """glt_tpu's initial parameters of ``run_steps`` (PRNGKey 0) and
    ``run_hetero_steps`` (PRNGKey 4) on the 8-device mesh, as the
    port's state dicts."""
    import jax
    import optax
    from jax.sharding import Mesh as JaxMesh

    from glt_tpu.data.topology import CSRTopo as JaxTopo
    from glt_tpu.models import GraphSAGE as JaxSAGE
    from glt_tpu.models.rgat import RGAT as JaxRGAT
    from glt_tpu.parallel import DistHeteroNeighborSampler as JaxHetero
    from glt_tpu.parallel import dist_train as jdt
    from glt_tpu.parallel import multihost as jmh
    from glt_tpu_torch.models import params_from_flax

    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("shard",))
    edge_index, n, feat, labels, classes, _ = build_fixture(8)
    topo = JaxTopo(edge_index, num_nodes=n)
    g = jmh.shard_graph_global(topo, jmesh)
    f = jmh.shard_feature_global(feat, jmesh)
    jm = JaxSAGE(hidden_features=HIDDEN, out_features=classes,
                 num_layers=2, dropout_rate=0.0)
    sage = jdt.init_dist_state(jm, optax.adam(LR), g, f,
                               jax.random.PRNGKey(0), FANOUTS, BS)
    topos, feats, _, classes, _ = hetero_fixture(8, JaxTopo)
    jsamp = JaxHetero(jmh.shard_hetero_graph_global(topos, jmesh), jmesh,
                      FANOUTS, "user", batch_size=BS, frontier_cap=16,
                      seed=0)
    jr = JaxRGAT(edge_types=[ET_IU, ET_UI], hidden_features=8,
                 out_features=classes, target_type="user", num_layers=2,
                 conv="gat", dropout_rate=0.0)
    rgat = jdt.init_hetero_dist_state(
        jr, optax.adam(LR), jsamp,
        {t: jmh.shard_feature_global(x, jmesh) for t, x in feats.items()},
        jax.random.PRNGKey(4))
    return {"sage": params_from_flax(sage.params),
            "rgat": params_from_flax(rgat.params)}


@pytest.fixture(scope="module")
def two_fleet(params, tmp_path_factory):
    """The 2-process x 4-shard fleet (train steps, hetero steps, the
    per-process load and the tiered pipeline), and its partition dir."""
    from _multihost_worker import make_partition_dir

    out = str(tmp_path_factory.mktemp("two"))
    torch.save(params, os.path.join(out, "params.pt"))
    make_partition_dir(os.path.join(out, "parts"), 8)
    return out, _spawn("two", 2, out)


@pytest.fixture(scope="module")
def four_fleet(params, tmp_path_factory):
    """The 4-process x 1-shard fleet on the 2 x 2 mesh (hier vs flat,
    then the straggler)."""
    out = str(tmp_path_factory.mktemp("four"))
    torch.save(params, os.path.join(out, "params.pt"))
    return _spawn("four", 4, out)


def test_two_process_fleet_matches_single_process(params, two_fleet):
    from jax.sharding import Mesh as JaxMesh
    import jax

    from _multihost_worker import run_steps as jax_run_steps

    out, res = two_fleet
    assert [r["local"] for r in res] == [[0, 4], [4, 8]]
    for r in res:          # the exchanges crossed the processes over gloo
        t = r["transport"]
        assert t["collectives"] > 0 and t["gloo_bytes"] > 0
        assert t["d2h_bytes"] == t["h2d_bytes"] == 0    # CPU tensors
    # Every process reports the same replicated loss ...
    assert res[0]["losses"] == pytest.approx(res[1]["losses"], rel=0, abs=0)
    # ... the in-process 8-shard run's and glt_tpu's, within 1e-5 ...
    ref, ref_nodes = run_steps(Mesh(["cpu"] * 8), params["sage"])
    assert res[0]["losses"] == pytest.approx(ref, rel=1e-5)
    jref = jax_run_steps(JaxMesh(np.array(jax.devices()[:8]), ("shard",)),
                         STEPS)
    assert res[0]["losses"] == pytest.approx(jref, rel=1e-5)
    assert res[0]["losses"][-1] < res[0]["losses"][0]
    # ... from batches equal to the in-process run's, shard by shard.
    got = {}
    for r in range(2):
        got.update(np.load(os.path.join(out, f"nodes_{r}.npz")))
    assert sorted(got) == sorted(ref_nodes)
    for k, v in ref_nodes.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_two_process_variants_match_single_process(params, two_fleet):
    """The ring collective, strict seed edges, induced subgraphs: every
    shard's arrays ``==`` the in-process run's; the scanned step's
    losses identical across processes and within 1e-5 of it."""
    out, res = two_fleet
    ref, ref_losses = run_variants(Mesh(["cpu"] * 8), params["sage"])
    got = {}
    for r in range(2):
        got.update(np.load(os.path.join(out, f"variants_{r}.npz")))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert res[0]["scanned"] == pytest.approx(res[1]["scanned"], rel=0,
                                              abs=0)
    assert len(ref_losses) > 0
    assert res[0]["scanned"] == pytest.approx(ref_losses, rel=1e-5)


def test_two_process_hetero_matches_single_process(params, two_fleet):
    """The hetero step (R-GAT over per-edge-type sharded CSRs and
    per-type exchanges) and the hetero tiered pipeline across
    processes: identical across them, within 1e-5 of one process."""
    _, res = two_fleet
    assert res[0]["hetero"] == res[1]["hetero"]
    ref = run_hetero_steps(Mesh(["cpu"] * 8), params["rgat"])
    for got, want in zip(res[0]["hetero"], ref):
        assert got == pytest.approx(want, rel=1e-5)


def test_two_process_dataset_load_matches_single_process(params, two_fleet):
    """``DistDataset.load(mesh=)`` per process + the tiered pipeline:
    the fleet and the in-process run of the plain load train to the
    same losses."""
    out, res = two_fleet
    assert res[0]["dataset"] == pytest.approx(res[1]["dataset"], rel=0,
                                              abs=0)
    ref = run_dataset_steps(Mesh(["cpu"] * 8), params["sage"],
                            os.path.join(out, "parts"))
    assert res[0]["dataset"] == pytest.approx(ref, rel=1e-5)


def test_straddling_2d_mesh_raises_on_every_process(two_fleet):
    """3 shards a process on 3 host rows of 2: process 0's slots [0, 1,
    2] straddle row 1 ([2, 3]) — glt_tpu's error, on both processes."""
    _, res = two_fleet
    for r in res:
        assert r["straddle"] is not None
        assert "process 0 devices straddle mesh row 1" in r["straddle"]
        assert "[0, 1, 2]" in r["straddle"] and "[2, 3]" in r["straddle"]


def test_four_process_hier_fleet_bit_identity(params, four_fleet):
    """4 processes (2 hosts x 2 chips): route='hier' is bit-equal to
    'flat' (losses and the parameters' sha256), an all-padded step
    moves nothing on either route, the byte model keeps glt_tpu's
    order, the zipf frontier dedups; every process sees the same losses,
    the in-process 2 x 2 mesh's within 1e-5."""
    res = four_fleet
    for r in res:
        assert r["shape"] == {"host": 2, "chip": 2}
        assert r["flat"] == r["hier"]
        assert r["digest_flat"] == r["digest_hier"]
        assert r["pad_noop_flat"] and r["pad_noop_hier"]
        assert r["dedup_factor"] > 1.0
        assert r["bytes_hier"]["dcn"] < r["bytes_flat"]["dcn"]
    assert all(r["flat"] == res[0]["flat"] for r in res)
    assert all(r["digest_flat"] == res[0]["digest_flat"] for r in res)
    ref = run_hier_steps(multihost.global_mesh_2d(["cpu"] * 4, num_hosts=2),
                         params["sage"])
    assert ref["flat"] == ref["hier"]
    assert ref["digest_flat"] == ref["digest_hier"]
    assert res[0]["flat"] == pytest.approx(ref["flat"], rel=1e-5)


def test_four_process_barrier_deadline_on_2d_mesh(four_fleet):
    """A straggler on the 4-process 2-D mesh turns every peer's
    barrier() into a BarrierTimeoutError at the deadline, never a
    hang."""
    res = four_fleet
    assert res[0]["timed_out"] is False       # the straggler itself
    for r in res[1:]:
        assert r["timed_out"]
        assert DEADLINE_S <= r["waited_s"] < DEADLINE_S + 2.0


def test_load_with_mesh_matches_plain_load(tmp_path):
    """One process: load(mesh=) builds the plain load's tensors."""
    from _multihost_worker import make_partition_dir

    part_dir = str(tmp_path / "parts")
    make_partition_dir(part_dir, 8)
    _, _, _, labels, _, _ = build_fixture(8)
    mesh = multihost.global_mesh(["cpu"] * 8)
    d1 = DistDataset.load(part_dir, hot_ratio=0.5, labels=labels,
                          device="cpu")
    d2 = DistDataset.load(part_dir, hot_ratio=0.5, labels=labels, mesh=mesh)
    for f in ("indptr", "indices", "edge_ids"):
        assert torch.equal(getattr(d1.graph, f), getattr(d2.graph, f)), f
    assert d1.graph[3:] == d2.graph[3:]
    assert torch.equal(d1.feature.hot, d2.feature.hot)
    np.testing.assert_array_equal(d1.feature.cold, d2.feature.cold)
    assert d1.feature[2:] == d2.feature[2:]
    assert torch.equal(d1.labels, d2.labels)
    np.testing.assert_array_equal(d1.relabel.old2new, d2.relabel.old2new)


def test_local_shard_range_single_process():
    mesh = multihost.global_mesh(["cpu"] * 8)
    assert not mesh.spans
    r = multihost.local_shard_range(mesh)
    assert (r.start, r.stop) == (0, 8)


def test_assemble_and_feed_single_process():
    mesh = multihost.global_mesh(["cpu"] * 8)
    blk = np.arange(8 * 3, dtype=np.int32).reshape(8, 3)
    assert torch.equal(multihost.assemble_global(blk, mesh),
                       torch.from_numpy(blk))
    seeds = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    np.testing.assert_array_equal(multihost.feed_seeds(seeds, mesh), seeds)
    assert multihost.agree_max(7) == 7
    np.testing.assert_array_equal(multihost.agree_sum(np.arange(3)),
                                  np.arange(3))
    multihost.barrier("alone")       # one process: returns at once


def test_shard_graph_global_matches_shard_graph():
    edge_index, n, *_ = build_fixture(8)
    topo = CSRTopo(edge_index, num_nodes=n)
    mesh = multihost.global_mesh(["cpu"] * 8)
    g1 = multihost.shard_graph_global(topo, mesh)
    g2 = shard_graph(topo, 8, device="cpu")
    for f in ("indptr", "indices", "edge_ids"):
        assert torch.equal(getattr(g1, f), getattr(g2, f)), f
    assert g1[3:] == g2[3:]


def test_local_shard_range_error_names_axes_and_devices():
    """Non-contiguous ownership names the full mesh axis tuple, its
    shape, the owned slots and the offending device ids."""
    me = multihost.process_index()
    fake = types.SimpleNamespace(owners=(me, me + 1, me, me + 1),
                                 device_ids=(100, 101, 102, 103),
                                 axis_names=("host", "chip"),
                                 shape={"host": 2, "chip": 2})
    with pytest.raises(ValueError) as ei:
        multihost.local_shard_range(fake, "host")
    msg = str(ei.value)
    assert "('host', 'chip')" in msg          # full axis tuple
    assert "(2, 2)" in msg                    # mesh shape
    assert "[0, 2]" in msg                    # flat shard slots owned
    assert "[100, 102]" in msg                # offending device ids
    assert "global_mesh_2d" in msg            # the fix


TWIN_ARGS = ["--device", "cpu", "--devices", "4", "--scale", "2e-5",
             "--epochs", "1", "--dim", "16", "--batch-size", "32"]


def _twin(args, nproc):
    """The papers100M twin's entry point as ``nproc`` processes of one
    fleet; returns each process's stdout by rank."""
    cmd = [sys.executable, "-m",
           "glt_tpu_torch.examples.dist_train_papers100m"] + TWIN_ARGS
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                GLT_NUM_PROCESSES=str(nproc))
    procs = [subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO,
                              env=dict(base, GLT_PROCESS_ID=str(r)))
             for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150))
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{err[-4000:]}"
    return [out for out, _ in outs]


def test_twin_runs_as_two_processes(tmp_path, capsys, monkeypatch):
    """``GLT_NUM_PROCESSES=2`` at the default ``--hot-ratio`` (the tiered
    pipeline; narrow features and batches keep it quick): process 0
    partitions, both train one 4-shard mesh, process 0 alone prints;
    the one-process run of the same partition prints the same epoch
    loss to 1e-5."""
    from glt_tpu_torch.examples import dist_train_papers100m as twin

    args = ["--part-dir", str(tmp_path / "p")]
    fleet = _twin(args, 2)
    monkeypatch.delenv("GLT_NUM_PROCESSES", raising=False)
    capsys.readouterr()
    twin.main(TWIN_ARGS + args)
    alone = capsys.readouterr().out

    def loss(out):
        return float(out.split("epoch 0: loss=")[1].split()[0])

    assert "over processes" in fleet[0] and "partitioned" in fleet[0]
    assert fleet[1].strip() == ""
    assert "partitioned" not in alone
    assert loss(fleet[0]) == pytest.approx(loss(alone), rel=1e-5)


@pytest.mark.parametrize("case", ["returns", "raises", "overruns"])
def test_run_with_deadline_matches_glt_tpu(case):
    """The supervisor's deadline wrapper as glt_tpu's: a result comes
    back, the function's own error is re-raised, an overrun raises
    BarrierTimeoutError (with glt_tpu's message and report) within
    the deadline."""
    from glt_tpu.distributed import supervisor as jsup

    def fn():
        if case == "raises":
            raise KeyError("boom")
        if case == "overruns":
            time.sleep(1.0)
        return 42

    got = []
    for run, err in ((run_with_deadline, BarrierTimeoutError),
                     (jsup.run_with_deadline, jsup.BarrierTimeoutError)):
        t0 = time.monotonic()
        try:
            got.append(("ok", run(fn, 0.2, what="probe")))
        except (KeyError, err) as exc:
            got.append((type(exc).__name__, str(exc),
                        getattr(exc, "report", None)))
        assert time.monotonic() - t0 < 0.9
    assert got[0] == got[1]


def test_initialize_needs_the_rendezvous(monkeypatch):
    """Without an address, a process count and an index (arguments or
    glt_tpu's env names) initialize refuses, naming them."""
    for k in ("GLT_COORDINATOR_ADDR", "MASTER_ADDR", "MASTER_PORT",
              "GLT_NUM_PROCESSES", "WORLD_SIZE", "GLT_PROCESS_ID", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="GLT_NUM_PROCESSES"):
        multihost.initialize()
    assert multihost.process_count() == 1


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
