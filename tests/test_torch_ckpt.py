"""glt_tpu_torch.ckpt and testing.faults against glt_tpu's, on the CPU.

The store mirrors ``tests/test_checkpoint.py`` (atomic publish, LATEST
pointer, tmp sweeps, checksums, pruning) and is one format for both
packages: a checkpoint written by either reads ``==`` in the other,
bfloat16 leaves included.  The tentpole contract: a TrainLoop killed
after any block (``SimulatedPreemption`` in process, a real SIGKILL in
a worker started from this file) resumes in a fresh loop with the
remaining losses and the final parameters bit-identical to an
uninterrupted run.  From the same weights, seeds and key the port's
TrainLoop losses agree with ``glt_tpu``'s within 1e-5 (float sums in
another order), and ``FaultPlan`` counts the same way in both packages.

Run as a script (``python tests/test_torch_ckpt.py <root> <out.json>
[kill_at]``) this file is the SIGKILL worker.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from glt_tpu_torch import random as trandom  # noqa: E402
from glt_tpu_torch.ckpt import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointError,
    Checkpointer,
    TrainLoop,
    capture_key,
    capture_pytree,
    capture_rng,
    capture_train_state,
    latest_step,
    list_steps,
    load_rng,
    read_checkpoint,
    restore_key,
    restore_pytree,
    restore_rng,
    restore_train_state,
    write_checkpoint,
)
from glt_tpu_torch.ckpt import store as ckpt_store  # noqa: E402
from glt_tpu_torch.data import CSRTopo, Graph  # noqa: E402
from glt_tpu_torch.data.feature_cache import cache_init  # noqa: E402
from glt_tpu_torch.models import (GraphSAGE, adam,  # noqa: E402
                                  create_train_state,
                                  make_scanned_node_train_step)
from glt_tpu_torch.sampler import NeighborSampler  # noqa: E402
from glt_tpu_torch.testing import (FaultPlan,  # noqa: E402
                                   SimulatedPreemption)

# One intra-op thread: the suite runs in parallel workers.
torch.set_num_threads(1)

N, DIM, CLASSES = 48, 8, 3
BATCH, GROUP, EPOCHS, SEEDS = 16, 2, 2, 40
# 3 real batches an epoch -> 2 blocks an epoch -> 4 blocks over 2 epochs.
TOTAL_STEPS = 4


def _cluster_data():
    """``tests/test_models.py``'s cluster graph, as numpy: nodes in 3
    clusters, edges within a cluster, noisy one-hot features."""
    rng = np.random.default_rng(0)
    labels = np.arange(N) % CLASSES
    src, dst = [], []
    for c in range(CLASSES):
        members = np.where(labels == c)[0]
        for i in members:
            for j in rng.choice(members, size=3, replace=False):
                src.append(i)
                dst.append(j)
    feat = np.concatenate(
        [np.eye(CLASSES, dtype=np.float32)[labels],
         rng.normal(0, 0.1, (N, DIM - CLASSES)).astype(np.float32)], 1)
    return np.stack([np.array(src), np.array(dst)]), feat, labels


def _make_step(feature_cache=None):
    ei, feat, labels = _cluster_data()
    sampler = NeighborSampler(Graph(CSRTopo(ei, num_nodes=N), device="cpu"),
                              [4, 4], batch_size=BATCH, with_edge=False)
    return make_scanned_node_train_step(sampler, feat, labels, BATCH,
                                        feature_cache=feature_cache)


def _fresh_state(state_dict=None):
    torch.manual_seed(0)
    model = GraphSAGE(DIM, 16, CLASSES, num_layers=2, dropout_rate=0.0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return create_train_state(model, adam(1e-2))


_SHARED = {}


def _shared_step():
    # One step object serves every cache-less loop (its closure holds no
    # state besides the CUDA graphs, which the CPU never captures).
    if "step" not in _SHARED:
        _SHARED["step"] = _make_step()
    return _SHARED["step"]


def _make_loop(checkpointer=None, fault_plan=None, step=None, rng_seed=7,
               key_seed=3):
    return TrainLoop(step or _shared_step(), _fresh_state(),
                     np.arange(SEEDS), BATCH, GROUP, epochs=EPOCHS,
                     rng=np.random.default_rng(rng_seed),
                     base_key=trandom.PRNGKey(key_seed, device="cpu"),
                     checkpointer=checkpointer, fault_plan=fault_plan)


def _params_equal(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


# ---------------------------------------------------------------------------
# store: atomic publish, checksums, fallback (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_store_roundtrip(tmp_path):
    root = str(tmp_path)
    comps = {
        "a": {"x": np.arange(6, dtype=np.int64).reshape(2, 3),
              "t": torch.arange(4, dtype=torch.int32),
              "nested": {"f": 1.5, "s": "hi", "n": None, "b": True},
              "lst": [1, 2, np.float32(3.5)]},
        "b": {"arr": np.linspace(0, 1, 5, dtype=np.float32),
              "mask": torch.tensor([True, False])},
    }
    path = write_checkpoint(root, 7, comps, extras={"why": "test"})
    assert os.path.isdir(path)
    step, got, extras = read_checkpoint(root)
    assert step == 7 and extras == {"why": "test"}
    np.testing.assert_array_equal(got["a"]["x"], comps["a"]["x"])
    np.testing.assert_array_equal(got["a"]["t"], np.arange(4, dtype=np.int32))
    assert got["a"]["t"].dtype == np.int32
    assert got["a"]["nested"] == {"f": 1.5, "s": "hi", "n": None, "b": True}
    assert got["a"]["lst"][2] == 3.5
    np.testing.assert_array_equal(got["b"]["arr"], comps["b"]["arr"])
    np.testing.assert_array_equal(got["b"]["mask"], [True, False])


@pytest.mark.parametrize("shape", [(4, 3), (), (0, 5)])
def test_store_bf16_bit_exact(tmp_path, shape):
    """bfloat16 (not npz-native) rides raw bytes + dtype tag and reads
    back as a bfloat16 tensor, bit-exact."""
    t = torch.from_numpy(np.random.default_rng(0).normal(
        size=shape).astype(np.float32)).to(torch.bfloat16)
    write_checkpoint(str(tmp_path), 1, {"m": {"w": t}})
    _, got, _ = read_checkpoint(str(tmp_path))
    back = got["m"]["w"]
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == shape
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_store_latest_pointer_and_fallback(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 1, {"c": {"v": 1}})
    write_checkpoint(root, 2, {"c": {"v": 2}})
    assert latest_step(root) == 2
    os.remove(os.path.join(root, "LATEST"))
    assert latest_step(root) == 2
    assert list_steps(root) == [1, 2]


def test_store_ignores_and_sweeps_tmp_leftovers(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 3, {"c": {"v": 3}})
    torn = os.path.join(root, ".tmp-step_00000009-12345")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as fh:
        fh.write("{ torn")
    assert list_steps(root) == [3]
    assert latest_step(root) == 3
    assert ckpt_store.sweep_tmp(root) == 0
    old = time.time() - 120
    os.utime(torn, (old, old))
    assert ckpt_store.sweep_tmp(root) == 1
    assert not os.path.exists(torn)


def test_store_corruption_detected_and_resume_falls_back(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 1, {"c": {"v": np.arange(4)}})
    write_checkpoint(root, 2, {"c": {"v": np.arange(8)}})
    with open(os.path.join(root, "step_00000002", "arrays.npz"),
              "r+b") as fh:
        fh.seek(30)
        fh.write(b"\xff\xff")
    with pytest.raises(CheckpointCorruptError):
        read_checkpoint(root, 2)
    snap = Checkpointer(root).resume()
    assert snap.step == 1
    np.testing.assert_array_equal(snap.components["c"]["v"], np.arange(4))


def test_store_prune_never_drops_latest(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        write_checkpoint(root, s, {"c": {"v": s}})
    assert ckpt_store.prune(root, keep=2) == [1, 2]
    assert list_steps(root) == [3, 4] and latest_step(root) == 4


def test_store_rejects_reserved_key_and_bad_leaf(tmp_path):
    with pytest.raises(CheckpointError, match="reserved"):
        write_checkpoint(str(tmp_path), 1, {"c": {"__a__": 1}})
    with pytest.raises(CheckpointError, match="unserializable"):
        write_checkpoint(str(tmp_path), 1, {"c": {"bad": object()}})


def test_store_overwrite_same_step(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 5, {"c": {"v": 1}})
    write_checkpoint(root, 5, {"c": {"v": 2}})
    assert read_checkpoint(root, 5)[1]["c"]["v"] == 2


# ---------------------------------------------------------------------------
# one store format for both packages
# ---------------------------------------------------------------------------

def _mixed(rng):
    return {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "i64": rng.integers(-9, 9, 7),
            "u32": rng.integers(0, 2**32, 4, dtype=np.uint64).astype(
                np.uint32),
            "b": rng.random(6) < 0.5,
            "meta": {"epoch": 3, "name": "x", "none": None}}


def test_jax_checkpoint_reads_equal_in_port(tmp_path):
    import jax.numpy as jnp
    from glt_tpu.ckpt import read_checkpoint as jread
    from glt_tpu.ckpt import write_checkpoint as jwrite

    rng = np.random.default_rng(1)
    comps = _mixed(rng)
    bf = jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16)
    jwrite(str(tmp_path), 4, {"c": comps, "m": {"w": bf}},
           extras={"by": "jax"})
    step, got, extras = read_checkpoint(str(tmp_path))
    assert step == 4 and extras == {"by": "jax"}
    for k in ("f32", "i64", "u32", "b"):
        assert got["c"][k].dtype == comps[k].dtype
        np.testing.assert_array_equal(got["c"][k], comps[k])
    assert got["c"]["meta"] == comps["meta"]
    w = got["m"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(bf.view(jnp.uint16)))
    # glt_tpu's own reader agrees with itself on the same files.
    assert jread(str(tmp_path))[0] == 4


def test_port_checkpoint_reads_equal_in_jax(tmp_path):
    import jax.numpy as jnp
    from glt_tpu.ckpt import read_checkpoint as jread

    rng = np.random.default_rng(2)
    comps = _mixed(rng)
    bf = torch.from_numpy(rng.normal(size=(2, 6)).astype(
        np.float32)).to(torch.bfloat16)
    write_checkpoint(str(tmp_path), 9, {
        "c": comps, "m": {"w": bf, "t": torch.arange(5)}})
    step, got, _ = jread(str(tmp_path))
    assert step == 9
    for k in ("f32", "i64", "u32", "b"):
        np.testing.assert_array_equal(got["c"][k], comps[k])
    np.testing.assert_array_equal(got["m"]["t"], np.arange(5))
    w = got["m"]["w"]
    assert str(w.dtype) == "bfloat16" and w.shape == (2, 6)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(w).view(jnp.uint16)),
        bf.view(torch.int16).numpy().view(np.uint16))


def test_feature_cache_snapshot_crosses_packages():
    import jax.numpy as jnp
    from glt_tpu.ckpt import capture_pytree as jcapture
    from glt_tpu.ckpt import restore_pytree as jrestore
    from glt_tpu.data import feature_cache as jcache

    jc = jcache.cache_init(30, 6, 4)
    jc = jc._replace(table=jnp.arange(28.0).reshape(7, 4),
                     slot_ids=jnp.arange(7, dtype=jnp.int32) - 1,
                     hits=jnp.asarray(5, jnp.int32))
    tc = restore_pytree(jcapture(jc), like=cache_init(30, 6, 4,
                                                      device="cpu"))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert b.dtype == torch.from_numpy(np.array(a)).dtype
    back = jrestore(capture_pytree(tc), like=jcache.cache_init(30, 6, 4))
    for a, b in zip(back, jc):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keys_cross_packages():
    import jax
    from glt_tpu.ckpt import capture_key as jcapture_key

    want = jcapture_key(jax.random.PRNGKey(3))
    got = capture_key(trandom.PRNGKey(3, device="cpu"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    k = restore_key(want, device="cpu")
    assert torch.equal(k, trandom.PRNGKey(3, device="cpu"))
    assert torch.equal(trandom.fold_in(k, 5),
                       trandom.fold_in(trandom.PRNGKey(3, device="cpu"), 5))


def test_restore_key_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_key(np.zeros(2, np.uint32))


# ---------------------------------------------------------------------------
# state capture
# ---------------------------------------------------------------------------

def test_rng_capture_continues_identical_stream(tmp_path):
    rng = np.random.default_rng(42)
    rng.random(10)
    snap = capture_rng(rng)
    want = rng.random(16)
    np.testing.assert_array_equal(want, restore_rng(snap).random(16))
    other = np.random.default_rng(0)
    load_rng(other, snap)
    np.testing.assert_array_equal(want, other.random(16))
    write_checkpoint(str(tmp_path), 1, {"rng": snap})
    back = read_checkpoint(str(tmp_path))[1]["rng"]
    np.testing.assert_array_equal(want, restore_rng(back).random(16))


def test_pytree_restore_validates_against_template():
    tree = {"w": torch.zeros(2, 2), "n": np.arange(3), "step": 7}
    snap = capture_pytree(tree)
    back = restore_pytree(snap, like={"w": torch.ones(2, 2),
                                      "n": np.zeros(3, np.int64), "step": 0})
    assert torch.equal(back["w"], tree["w"]) and back["step"] == 7
    assert isinstance(back["n"], np.ndarray)
    with pytest.raises(CheckpointError, match="leaves"):
        restore_pytree(snap, like={"w": torch.zeros(2, 2), "n": np.zeros(3),
                                   "step": 0, "x": 1})
    with pytest.raises(CheckpointError, match="template"):
        restore_pytree(snap, like={"w": torch.zeros(3, 2),
                                   "n": np.zeros(3, np.int64), "step": 0})
    with pytest.raises(CheckpointError, match="template"):
        restore_pytree(snap, like={"w": torch.zeros(2, 2, dtype=torch.int32),
                                   "n": np.zeros(3, np.int64), "step": 0})


def test_train_state_roundtrip_bit_exact(tmp_path):
    """Model (bf16 and f32 parameters), Adam's moments and step through
    the store into a fresh model and optimizer, bit for bit; the model's
    parameters keep their storage (an in-place copy)."""
    state = _fresh_state()
    state.model.convs[0].to(torch.bfloat16)
    state = create_train_state(state.model, adam(1e-2))
    loss = sum(p.float().square().sum() for p in state.model.parameters())
    loss.backward()
    state.optimizer.step()
    state = state._replace(step=3)
    write_checkpoint(str(tmp_path), 3, {"ts": capture_train_state(state)})
    snap = read_checkpoint(str(tmp_path))[1]["ts"]
    fresh = _fresh_state()
    fresh.model.convs[0].to(torch.bfloat16)
    fresh = create_train_state(fresh.model, adam(1e-2))
    ptrs = [p.data_ptr() for p in fresh.model.parameters()]
    got = restore_train_state(snap, like=fresh)
    assert got.step == 3 and got.model is fresh.model
    assert [p.data_ptr() for p in got.model.parameters()] == ptrs
    assert _params_equal(got, state)
    sa, sb = state.optimizer.state_dict(), got.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    with pytest.raises(CheckpointError, match="keys"):
        restore_train_state(snap, like=create_train_state(
            GraphSAGE(DIM, 16, CLASSES, num_layers=3), adam(1e-2)))


# ---------------------------------------------------------------------------
# Checkpointer and the TrainLoop
# ---------------------------------------------------------------------------

def test_checkpointer_drives_state_dict_objects(tmp_path):
    class Counter:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, d):
            self.n = int(d["n"])

    a = Counter()
    a.n = 5
    ck = Checkpointer(str(tmp_path), every_n_steps=2)
    assert [ck.due(s) for s in range(5)] == [False, False, True, False, True]
    ck.save(1, {"counter": a, "raw": {"v": np.arange(3)}})
    b = Counter()
    snap = ck.resume({"counter": b})
    assert b.n == 5 and snap.step == 1 and ck.latest_step() == 1
    np.testing.assert_array_equal(snap.components["raw"]["v"], np.arange(3))


@pytest.fixture(scope="module")
def uninterrupted():
    loop = _make_loop()
    state = loop.run()
    assert len(loop.losses) == 6        # 3 real batches x 2 epochs
    return state, list(loop.losses)


@pytest.mark.parametrize("k", list(range(1, TOTAL_STEPS)))
def test_preempt_at_every_step_resumes_bit_identical(tmp_path, k,
                                                     uninterrupted):
    """Preempt after block k (checkpoint every block), rebuild the loop
    with a fresh model and optimizer and WRONG seeds, resume: the
    remaining losses and the final parameters are bit-identical."""
    ref_state, ref_losses = uninterrupted
    root = str(tmp_path)
    plan = FaultPlan(preempt_at_train_step=k)
    victim = _make_loop(Checkpointer(root, every_n_steps=1, keep=2),
                        fault_plan=plan)
    with pytest.raises(SimulatedPreemption):
        victim.run()
    assert latest_step(root) == k and plan.injected_preemptions == 1
    revived = _make_loop(Checkpointer(root), rng_seed=999, key_seed=0)
    snap = revived.resume()
    assert snap is not None and snap.step == k
    assert revived.start_step == k
    final = revived.run()
    assert revived.losses == ref_losses[len(ref_losses)
                                        - len(revived.losses):]
    assert final.step == ref_state.step
    assert _params_equal(final, ref_state)


def test_resume_falls_back_past_corrupt_newest(tmp_path, uninterrupted):
    ref_state, ref_losses = uninterrupted
    root = str(tmp_path)
    victim = _make_loop(Checkpointer(root, every_n_steps=1, keep=3),
                        fault_plan=FaultPlan(preempt_at_train_step=2))
    with pytest.raises(SimulatedPreemption):
        victim.run()
    with open(os.path.join(root, "step_00000002", "arrays.npz"),
              "r+b") as fh:
        fh.seek(40)
        fh.write(b"\x00\x00\x00")
    revived = _make_loop(Checkpointer(root))
    assert revived.resume().step == 1
    final = revived.run()
    assert revived.losses == ref_losses[len(ref_losses)
                                        - len(revived.losses):]
    assert _params_equal(final, ref_state)


def test_feature_cache_state_rides_checkpoints(tmp_path):
    """The cross-block cache is captured and restored: the resumed
    run's parameters, cache counters and slots match the uninterrupted
    run's."""
    def cached_loop(checkpointer=None, fault_plan=None):
        return _make_loop(checkpointer, fault_plan,
                          step=_make_step(cache_init(N, 32, DIM,
                                                     device="cpu")))

    ref = cached_loop()
    ref_state = ref.run()
    ref_cache = ref.step.feature_cache()
    root = str(tmp_path)
    victim = cached_loop(Checkpointer(root, every_n_steps=1, keep=2),
                         fault_plan=FaultPlan(preempt_at_train_step=2))
    with pytest.raises(SimulatedPreemption):
        victim.run()
    assert "feature_cache" in read_checkpoint(root)[1]
    revived = cached_loop(Checkpointer(root))
    assert revived.resume() is not None
    final = revived.run()
    assert _params_equal(final, ref_state)
    got = revived.step.feature_cache()
    assert int(got.hits) == int(ref_cache.hits) > 0
    assert int(got.misses) == int(ref_cache.misses)
    assert torch.equal(got.slot_ids, ref_cache.slot_ids)
    assert torch.equal(got.table, ref_cache.table)


def test_trainloop_without_checkpointer_is_plain(uninterrupted):
    _, ref_losses = uninterrupted
    loop = _make_loop()
    assert loop.resume() is None
    loop.run()
    assert loop.losses == ref_losses


def test_extra_components_ride_along(tmp_path):
    from glt_tpu_torch.data import Dataset
    from glt_tpu_torch.loader import NeighborLoader

    ei, feat, labels = _cluster_data()
    ds = (Dataset(device="cpu").init_graph(ei, num_nodes=N)
          .init_node_features(feat).init_node_labels(labels))
    mk = lambda: NeighborLoader(ds, [4, 4], np.arange(N), batch_size=16,  # noqa: E731
                                shuffle=True, seed=11)
    ld = mk()
    list(ld)
    loop = TrainLoop(_shared_step(), _fresh_state(), np.arange(SEEDS),
                     BATCH, GROUP, 1, np.random.default_rng(7),
                     trandom.PRNGKey(3, device="cpu"),
                     checkpointer=Checkpointer(str(tmp_path),
                                               every_n_steps=1),
                     extra_components={"loader": ld})
    loop.run()
    other = mk()
    revived = TrainLoop(_shared_step(), _fresh_state(), np.arange(SEEDS),
                        BATCH, GROUP, 1, np.random.default_rng(0),
                        trandom.PRNGKey(0, device="cpu"),
                        checkpointer=Checkpointer(str(tmp_path)),
                        extra_components={"loader": other})
    revived.resume()
    assert other.state_dict()["epoch"] == ld.state_dict()["epoch"] == 1
    assert [b.batch.tolist() for b in other] == [b.batch.tolist()
                                                 for b in ld]


def test_trainloop_refuses_a_supervisor():
    """A supervisor whose peer is dead makes the loop refuse to go on:
    it stops at the first block boundary with ``SupervisedExit``."""
    import threading

    from glt_tpu_torch.distributed.supervisor import (SupervisedExit,
                                                      Supervisor)

    died = threading.Event()
    sup = Supervisor(deadline_secs=0.01, poll_interval=0.01,
                     on_dead=lambda peer, report: died.set())
    sup.register("server-0")
    assert died.wait(60)
    loop = TrainLoop(_shared_step(), _fresh_state(), np.arange(SEEDS), BATCH,
                     GROUP, 1, np.random.default_rng(7),
                     trandom.PRNGKey(3, device="cpu"), supervisor=sup)
    with pytest.raises(SupervisedExit) as err:
        loop.run()
    assert err.value.step == 1 and err.value.checkpoint_path is None
    assert err.value.report["peer"] == "server-0"
    sup.stop()


def test_trainloop_losses_match_jax(uninterrupted):
    """glt_tpu's TrainLoop and the port's, from the same weights, seeds,
    shuffle stream and key: losses within 1e-5, parameters within 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax
    from glt_tpu.ckpt import TrainLoop as JaxLoop
    from glt_tpu.data import Dataset as JaxDataset
    from glt_tpu.models import GraphSAGE as JaxSAGE
    from glt_tpu.models import TrainState as JaxState
    from glt_tpu.models.train import make_scanned_node_train_step as jstep
    from glt_tpu.sampler import NeighborSampler as JaxSampler
    from glt_tpu_torch.models import params_from_flax

    ei, feat, labels = _cluster_data()
    jds = (JaxDataset().init_graph(ei, graph_mode="HOST", num_nodes=N)
           .init_node_features(feat).init_node_labels(labels))
    model = JaxSAGE(hidden_features=16, out_features=CLASSES, num_layers=2,
                    dropout_rate=0.0)
    tx = optax.adam(1e-2)
    sampler = JaxSampler(jds.get_graph(), [4, 4], batch_size=BATCH,
                         with_edge=False, sample_force="xla")
    x0 = jnp.zeros((sampler.node_capacity, DIM), jnp.float32)
    params = model.init({"params": jax.random.PRNGKey(0)}, x0,
                        jnp.full((2, 8), -1, jnp.int32),
                        jnp.zeros((8,), bool))
    jloop = JaxLoop(jstep(model, tx, sampler, jds.get_node_feature(),
                          labels, BATCH),
                    JaxState(params, tx.init(params),
                             jnp.zeros((), jnp.int32)),
                    np.arange(SEEDS), BATCH, GROUP, EPOCHS,
                    np.random.default_rng(7), jax.random.PRNGKey(3))
    jstate = jloop.run()
    loop = TrainLoop(_shared_step(), _fresh_state(params_from_flax(params)),
                     np.arange(SEEDS), BATCH, GROUP, EPOCHS,
                     np.random.default_rng(7),
                     trandom.PRNGKey(3, device="cpu"))
    state = loop.run()
    np.testing.assert_allclose(loop.losses, jloop.losses, atol=1e-5,
                               rtol=1e-5)
    want = params_from_flax(jstate.params)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def _plan_trace(mod):
    """One scripted sequence through a FaultPlan of ``mod``."""
    plan = mod.FaultPlan(preempt_at_train_step=3, fail_serving_batch=2,
                         fail_disk_read_at=2, delay_disk_read=(1,),
                         kill_producer_after_puts=2,
                         kill_replica_after_serving_batches=3,
                         replica_kill_hook=lambda: None)
    seen = []
    for hook in ("on_train_step", "on_serving_batch", "on_disk_read",
                 "on_producer_put"):
        for _ in range(4):
            try:
                getattr(plan, hook)()
                seen.append((hook, "ok"))
            except BaseException as exc:  # noqa: BLE001 — recorded
                seen.append((hook, type(exc).__name__))
    counters = {k: v for k, v in vars(plan).items()
                if k.startswith(("injected_", "_train", "_serving",
                                 "_disk", "_puts"))}
    return seen, counters


def test_fault_plan_counts_like_jax():
    from glt_tpu.testing import faults as jfaults
    from glt_tpu_torch.testing import faults

    ours, ref = _plan_trace(faults), _plan_trace(jfaults)
    assert ours == ref
    assert ("on_train_step", "SimulatedPreemption") in ours[0]
    assert ours[1]["injected_preemptions"] == 1
    assert ours[1]["injected_disk_failures"] == 1


# ---------------------------------------------------------------------------
# a real SIGKILL: this file is the worker
# ---------------------------------------------------------------------------

def _worker(root, out, kill_at=None):
    """One (possibly self-SIGKILLed) training process: checkpoint every
    block; without ``kill_at``, resume from ``root`` and write the
    losses and a digest of the final parameters to ``out``."""
    import hashlib

    plan = None if kill_at is None else FaultPlan(
        kill_at_train_step=int(kill_at))
    loop = _make_loop(Checkpointer(root, every_n_steps=1, keep=3), plan)
    snap = loop.resume()
    state = loop.run()           # a kill_at run dies in here
    h = hashlib.sha256()
    for v in state.model.state_dict().values():
        h.update(v.numpy().tobytes())
    res = {"resumed_from": None if snap is None else snap.step,
           "losses": loop.losses, "param_digest": h.hexdigest()}
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(res, fh)
    os.replace(tmp, out)


def test_real_sigkill_resume_bit_identical(tmp_path):
    """A subprocess SIGKILLs itself after block 3 (no atexit, no
    cleanup); a second one resumes from the published checkpoints; the
    losses and the parameter digest equal an uninterrupted run's."""
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*args):
        return subprocess.run([sys.executable, os.path.abspath(__file__),
                               *args], capture_output=True, text=True,
                              env=env, cwd=REPO, timeout=240)

    ref_json = str(tmp_path / "ref.json")
    proc = run(str(tmp_path / "ref"), ref_json)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.load(open(ref_json))
    root, out = str(tmp_path / "chaos"), str(tmp_path / "chaos.json")
    killed = run(root, out, "3")
    assert killed.returncode == -signal.SIGKILL, (killed.returncode,
                                                  killed.stderr[-2000:])
    assert not os.path.exists(out) and latest_step(root) == 3
    resumed = run(root, out)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    got = json.load(open(out))
    assert got["resumed_from"] == 3
    assert got["param_digest"] == ref["param_digest"]
    assert got["losses"] == ref["losses"][len(ref["losses"])
                                          - len(got["losses"]):]


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
