"""The port's worker-mode loaders against ``glt_tpu``'s (cf.
``tests/test_dist_loader.py``): messages key for key, the mp producer's
chunk plan, the mp batches themselves (matched by their seeds), and
exactly-once delivery across a worker's death.  Every process samples on
``device="cpu"``; workers are spawned."""
import os
import signal
import time

import numpy as np
import pytest
import torch

from glt_tpu_torch.channel import ShmChannel
from glt_tpu_torch.data import Dataset, attach_dataset, share_dataset
from glt_tpu_torch.distributed import (
    CollocatedSamplingWorkerOptions,
    DistHeteroNeighborLoader,
    DistLinkNeighborLoader,
    DistNeighborLoader,
    DistSubGraphLoader,
    MpSamplingWorkerOptions,
    batch_to_message,
    message_to_batch,
)
from glt_tpu_torch.distributed.dist_sampling_producer import (
    MpSamplingProducer, _sampling_worker_loop)
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.sampler import NegativeSampling

torch.set_num_threads(1)

N = 24
BATCH_FIELDS = ("node", "edge_index", "node_mask", "edge_mask", "edge_id",
                "batch", "x", "y")


def build_ring(n=N, dim=3, device="cpu"):
    """Node i links to i+1 and i+2 (mod n); x[i] = i, y[i] = i % 3.
    Top-level so spawned workers can rebuild it."""
    src = np.repeat(np.arange(n), 2)
    dst = np.concatenate([[(i + 1) % n, (i + 2) % n] for i in range(n)])
    feat = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, dim),
                                                             np.float32)
    return (Dataset(device=device)
            .init_graph(np.stack([src, dst]), num_nodes=n)
            .init_node_features(feat)
            .init_node_labels(np.arange(n, dtype=np.int32) % 3))


def build_hetero_ring(u=16, i=8, device="cpu"):
    u_src = np.repeat(np.arange(u), 2)
    i_dst = np.concatenate([[x % i, (x + 1) % i] for x in range(u)])
    ei = {("user", "clicks", "item"): np.stack([u_src, i_dst]),
          ("item", "rev_clicks", "user"): np.stack([i_dst, u_src])}
    feats = {"user": (np.arange(u, dtype=np.float32)[:, None]
                      * [1.0, 0.0]).astype(np.float32),
             "item": (np.arange(i, dtype=np.float32)[:, None]
                      * [0.0, 1.0]).astype(np.float32)}
    return (Dataset(device=device)
            .init_graph(ei, num_nodes={"user": u, "item": i})
            .init_node_features(feats)
            .init_node_labels({"user": (np.arange(u) % 3).astype(np.int32)}))


def check_batch(b, n=N):
    nodes, mask = b.node.numpy(), b.node_mask.numpy()
    np.testing.assert_array_equal(b.x.numpy()[mask][:, 0], nodes[mask])
    np.testing.assert_array_equal(b.y.numpy()[mask], nodes[mask] % 3)
    ei, em = b.edge_index.numpy(), b.edge_mask.numpy()
    assert ((nodes[ei[0][em]] - nodes[ei[1][em]]) % n <= 2).all()
    assert ((nodes[ei[0][em]] - nodes[ei[1][em]]) % n >= 1).all()


def seeds_of(b):
    return b.batch[:b.batch_size].tolist()


def mp_opts(**kw):
    kw.setdefault("channel_capacity_bytes", 1 << 20)
    return MpSamplingWorkerOptions(device="cpu", **kw)


def test_batch_to_message_equals_glt_tpu():
    """Both packages' loaders on the same ring give the same batches;
    their messages agree key for key, dtype and value."""
    from glt_tpu.distributed.sample_message import (
        batch_to_message as jax_to_message)
    from glt_tpu.loader.node_loader import NeighborLoader as JaxLoader
    from tests.test_dist_loader import build_ring_dataset

    jl = JaxLoader(build_ring_dataset(), [2, 2], np.arange(N),
                   batch_size=6, shuffle=True, seed=3)
    pl = NeighborLoader(build_ring(), [2, 2], np.arange(N), batch_size=6,
                        shuffle=True, seed=3)
    for jb, pb in zip(jl, pl):
        jm, pm = jax_to_message(jb), batch_to_message(pb)
        assert list(jm) == list(pm)
        for k in jm:
            assert pm[k].dtype == jm[k].dtype, k
            np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)
        back = message_to_batch(pm, device="cpu")
        for f in BATCH_FIELDS:
            assert torch.equal(getattr(back, f), getattr(pb, f)), f


def test_batch_to_message_bf16_and_metadata():
    from glt_tpu_torch.loader.transform import Batch

    x = torch.randn(5, 3).to(torch.bfloat16)
    b = Batch(x=x, y=torch.arange(5), edge_index=torch.zeros(2, 4,
                                                            dtype=torch.int32),
              edge_id=None, node=torch.arange(5, dtype=torch.int32),
              node_mask=torch.ones(5, dtype=torch.bool),
              edge_mask=torch.ones(4, dtype=torch.bool), batch=None,
              batch_size=2, metadata={"edge_label": torch.tensor([1., 0.])})
    m = batch_to_message(b)
    assert m["x"].dtype == np.uint16 and m["node_mask"].dtype == np.bool_
    back = message_to_batch(m, device="cpu")
    assert torch.equal(back.x, x)
    assert torch.equal(back.metadata["edge_label"], torch.tensor([1., 0.]))


def test_collocated_mode():
    loader = DistNeighborLoader([2, 2], np.arange(N), batch_size=6,
                                dataset=build_ring())
    seen = []
    for b in loader:
        check_batch(b)
        seen += seeds_of(b)
    assert sorted(seen) == list(range(N))
    assert isinstance(loader.options, CollocatedSamplingWorkerOptions)


def _fake_spawned(prod, k):
    """Give a producer ``k`` live stand-in workers (no processes), so
    its epoch plan can be read from the task queues."""
    class Q(list):
        put = list.append

    class P:
        def is_alive(self):
            return True

    prod._task_queues = [Q() for _ in range(k)]
    prod._workers = [P() for _ in range(k)]


@pytest.mark.parametrize("n,bs,k,shuffle",
                         [(24, 6, 2, False), (50, 4, 3, True),
                          (7, 4, 4, True), (100, 8, 2, True)])
def test_chunk_plan_equals_glt_tpu(n, bs, k, shuffle):
    """Seeds to workers, their order, epoch after epoch."""
    from glt_tpu.distributed.dist_options import (
        MpSamplingWorkerOptions as JaxOpts)
    from glt_tpu.distributed.dist_sampling_producer import (
        MpSamplingProducer as JaxProducer)

    jp = JaxProducer(None, (), [2], np.arange(n) * 3, bs,
                     JaxOpts(num_workers=k, worker_seed=5), None,
                     shuffle=shuffle, seed=11)
    pp = MpSamplingProducer(None, (), [2], np.arange(n) * 3, bs,
                            mp_opts(num_workers=k, worker_seed=5), None,
                            shuffle=shuffle, seed=11)
    for p in (jp, pp):
        _fake_spawned(p, k)
    for epoch in range(3):
        jp.produce_all()
        pp.produce_all()
        assert len(jp._chunks) == len(pp._chunks) == k
        for a, b in zip(jp._chunks, pp._chunks):
            np.testing.assert_array_equal(a, b)
        for qa, qb in zip(jp._task_queues, pp._task_queues):
            assert [t[1].tolist() for t in qa] == [t[1].tolist() for t in qb]
        assert jp.num_expected() == pp.num_expected()


def test_mp_batches_equal_glt_tpu_mp_batches():
    """Two workers in each package, the same options and loader seed:
    every batch (matched by its seeds) is the same array by array."""
    from glt_tpu.distributed import DistNeighborLoader as JaxDistLoader
    from glt_tpu.distributed import MpSamplingWorkerOptions as JaxOpts
    from tests.test_dist_loader import build_ring_dataset

    def collect(loader):
        out = {}
        try:
            for b in loader:
                out[tuple(seeds_of(b))] = {
                    f: np.asarray(getattr(b, f)) for f in BATCH_FIELDS}
        finally:
            loader.shutdown()
        return out

    kw = dict(batch_size=5, shuffle=True, seed=2)
    jax_b = collect(JaxDistLoader(
        [2, 2], np.arange(N), dataset_builder=build_ring_dataset,
        worker_options=JaxOpts(num_workers=2, channel_capacity_bytes=1 << 20,
                               worker_seed=1), **kw))
    port_b = collect(DistNeighborLoader(
        [2, 2], np.arange(N), dataset_builder=build_ring,
        worker_options=mp_opts(num_workers=2, worker_seed=1), device="cpu",
        **kw))
    assert sorted(jax_b) == sorted(port_b) and len(port_b) == 5
    for key, arrs in jax_b.items():
        for f, a in arrs.items():
            np.testing.assert_array_equal(port_b[key][f], a,
                                          err_msg=f"{key} {f}")


def test_mp_worker_mode_two_epochs():
    loader = DistNeighborLoader(
        [2, 2], np.arange(N), batch_size=6, dataset_builder=build_ring,
        worker_options=mp_opts(num_workers=2), device="cpu")
    try:
        assert len(loader) == 4
        for _ in range(2):
            seen = []
            for b in loader:
                assert b.node.device.type == "cpu"
                check_batch(b)
                seen += seeds_of(b)
            assert sorted(seen) == list(range(N))
    finally:
        loader.shutdown()


def test_mp_worker_mode_shared_memory_dataset():
    """Workers attach the trainer's shared dataset instead of
    rebuilding it: every seed once an epoch."""
    handle = share_dataset(build_ring())
    loader = DistNeighborLoader(
        [2, 2], np.arange(N), batch_size=6, dataset_builder=attach_dataset,
        builder_args=(handle, 0.0, "cpu"),
        worker_options=mp_opts(num_workers=2), device="cpu")
    try:
        for _ in range(2):
            seen = []
            for b in loader:
                check_batch(b)
                seen += seeds_of(b)
            assert sorted(seen) == list(range(N))
    finally:
        loader.shutdown()
        handle.unlink()


def test_mp_link_loader_weighted_negatives():
    """Positive seed edges decode to ring successors; weighted negatives
    come from the weight's support only (it crosses the spawn)."""
    support = {3, 7, 11}
    w = np.zeros(N, np.float32)
    w[list(support)] = 1.0
    src = np.arange(N)
    eli = np.stack([src, (src + 1) % N])
    loader = DistLinkNeighborLoader(
        [2], eli, neg_sampling=NegativeSampling("binary", 2, weight=w),
        batch_size=6, dataset_builder=build_ring,
        worker_options=mp_opts(num_workers=2), device="cpu")
    try:
        npos, neg_seen = 0, set()
        for b in loader:
            nodes = b.node.numpy()
            elx = b.metadata["edge_label_index"].numpy()
            lab = b.metadata["edge_label"].numpy()
            gsrc, gdst = nodes[elx[0]], nodes[elx[1]]
            pos = lab > 0.5
            assert ((gdst[pos] - gsrc[pos]) % N == 1).all()
            npos += int(pos.sum())
            neg_seen |= set(gsrc[~pos].tolist()) | set(gdst[~pos].tolist())
        assert npos == N and len(loader) == 4
        assert neg_seen and neg_seen <= support, neg_seen
    finally:
        loader.shutdown()


def test_mp_subgraph_loader():
    loader = DistSubGraphLoader(
        [3], np.arange(N), batch_size=4, max_degree=8,
        dataset_builder=build_ring, worker_options=mp_opts(num_workers=2),
        device="cpu")
    try:
        seen = []
        for b in loader:
            nodes = b.node.numpy()
            ei, em = b.edge_index.numpy(), b.edge_mask.numpy()
            assert em.any()
            assert ((nodes[ei[1][em]] - nodes[ei[0][em]]) % N >= 1).all()
            assert ((nodes[ei[1][em]] - nodes[ei[0][em]]) % N <= 2).all()
            seen += seeds_of(b)
        assert sorted(seen) == list(range(N)) and len(loader) == 6
    finally:
        loader.shutdown()


def test_mp_hetero_loader():
    loader = DistHeteroNeighborLoader(
        [2, 2], ("user", np.arange(16)), batch_size=4,
        dataset_builder=build_hetero_ring,
        worker_options=mp_opts(num_workers=2), device="cpu")
    try:
        seen = []
        for b in loader:
            users = b.node["user"].numpy()
            um = b.node_mask["user"].numpy()
            np.testing.assert_array_equal(b.x["user"].numpy()[um][:, 0],
                                          users[um])
            np.testing.assert_array_equal(b.y["user"].numpy()[um],
                                          users[um] % 3)
            assert b.input_type == "user"
            seen += users[:b.batch_size].tolist()
        assert sorted(seen) == list(range(16))
    finally:
        loader.shutdown()


def test_mp_node_kwargs_rejected():
    with pytest.raises(TypeError, match="as_pyg_v1"):
        DistNeighborLoader([2], np.arange(N), dataset_builder=build_ring,
                           worker_options=mp_opts(num_workers=1),
                           device="cpu", as_pyg_v1=True)


def test_mp_worker_death_mid_epoch():
    """A SIGKILLed worker loses no batch and hangs nothing: its
    undelivered seed range goes to a respawned worker."""
    n = 60
    loader = DistNeighborLoader(
        [2, 2], np.arange(n), batch_size=6, dataset_builder=build_ring,
        builder_args=(n,), device="cpu",
        worker_options=mp_opts(num_workers=2, channel_capacity_bytes=8192,
                               heartbeat_secs=0.5))
    try:
        it = iter(loader)
        b = next(it)
        check_batch(b, n)
        seen = seeds_of(b)
        os.kill(loader._producer._workers[0].pid, signal.SIGKILL)
        for b in it:
            check_batch(b, n)
            seen += seeds_of(b)
        assert sorted(seen) == list(range(n))
    finally:
        loader.shutdown()


def test_mp_producer_drain_reissue_exactly_once():
    """A worker killed while its batches sit in the ring: the drain
    yields those (never reissued), the respawned worker the rest."""
    n = 48
    channel = ShmChannel(capacity_bytes=1 << 20)
    prod = MpSamplingProducer(build_ring, (n,), [2, 2], np.arange(n), 4,
                              mp_opts(num_workers=2, heartbeat_secs=0.5),
                              channel, shuffle=False, seed=0)
    prod.init()
    try:
        prod.produce_all()
        it = prod.iter_messages()
        msgs = [next(it)]
        deadline = time.monotonic() + 30.0
        while channel.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        os.kill(prod._workers[0].pid, signal.SIGKILL)
        msgs.extend(it)
        assert len(msgs) == prod.num_expected()
        seen = []
        for m in msgs:
            b = message_to_batch(m, device="cpu")
            check_batch(b, n)
            seen += seeds_of(b)
        assert sorted(seen) == list(range(n))
    finally:
        prod.shutdown()
        channel.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_worker_without_a_card_raises():
    """A worker asked for "cuda" never samples on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _sampling_worker_loop(0, build_ring, (), [2], 4, None, None, 0,
                              device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistNeighborLoader([2], np.arange(N), dataset_builder=build_ring,
                           worker_options=MpSamplingWorkerOptions())
