"""Multiprocess sampling producers feeding a shm channel (cf.
``glt_tpu/distributed/dist_sampling_producer.py``).

``MpSamplingProducer`` spawns ``num_workers`` sampling subprocesses,
each running ``_sampling_worker_loop``: build the dataset from a
picklable builder (typically :func:`~glt_tpu_torch.data.attach_dataset`
of a shared handle, or a function that loads the arrays), build a
sampler on the options' ``device``, pull seed chunks from a task queue
and push fully collated messages (features gathered worker-side) into
the shm channel.  Workers are spawned, never forked: a forked child of a
process that initialised CUDA cannot use the card.  On ``"cuda"`` each
worker has its own CUDA context on the card and samples through the
port's kernels (B1 and the threefry hash kernel in its sampler, B2 for
the feature gather); ``glt_tpu``'s workers sample on the host CPU, a TPU
constraint that does not carry over.  A ``"cuda"`` worker without a card
raises; it never samples on the CPU.
"""
from __future__ import annotations

import multiprocessing as mp
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..channel import ShmChannel
from ..obs import propagate as _prop
from ..obs.trace import auto_trace, auto_trace_export
from ..obs.trace import current as _current_tracer
from ..obs.trace import span as _span
from .dist_options import MpSamplingWorkerOptions
from .sample_message import batch_to_message

_CMD_SAMPLE_EPOCH = 0
_CMD_STOP = 1

_WORKER_KEY = "#worker"
# Worker clock stamp riding each message: [worker pid, send time in the
# worker's trace clock (us)].  Popped by the consumer (_account) and
# recorded as an ``obs.clock_oneway`` sample (the shm ring has no
# response path).  Only attached while the worker traces.
_OBS_KEY = "#obs"

# Sampler-construction kwargs the worker loop honors for the node kind;
# dist_loader validates mp-mode kwargs against this same set.
WORKER_SAMPLER_KWARGS = frozenset({"frontier_cap", "with_edge",
                                   "last_hop_dedup"})


def _sampling_worker_loop(worker_id, dataset_builder, builder_args,
                          num_neighbors, batch_size, channel, task_queue,
                          seed, kind="node", kind_kwargs=None,
                          device="cuda"):
    """Subprocess body.  ``kind`` selects the task:
      * 'node': chunk entries are seed node ids;
      * 'hetero_node': seed ids of ``kind_kwargs['input_type']``;
      * 'link': chunks are ``(edge_label_index[2, n], labels-or-None)``
        slices;
      * 'subgraph': seed node ids, induced extraction with
        ``kind_kwargs['max_degree']``.
    The builder's dataset must live on ``device``; the sampler and the
    feature gather run there.
    """
    import os

    import torch

    from ..loader.node_loader import NodeLoader
    from ..sampler.base import EdgeSamplerInput, NodeSamplerInput
    from ..sampler.neighbor_sampler import NeighborSampler
    from ..utils.device import resolve_device
    from .sample_message import hetero_batch_to_message

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kk = kind_kwargs or {}
    data = dataset_builder(*builder_args)
    if torch.device(data.device).type != dev.type:
        raise ValueError(
            f"the dataset builder made a dataset on {data.device}, but "
            f"the worker samples on {dev}")
    if kind == "hetero_node":
        from ..loader.hetero_neighbor_loader import HeteroNeighborLoader

        input_type = kk["input_type"]
        collate_loader = HeteroNeighborLoader(
            data, num_neighbors, (input_type, np.empty(0, np.int64)),
            batch_size=batch_size, frontier_cap=kk.get("frontier_cap"),
            seed=seed + worker_id,
            last_hop_dedup=kk.get("last_hop_dedup", True))
        sampler = collate_loader.sampler
    else:
        sampler = NeighborSampler(data.get_graph(), num_neighbors,
                                  batch_size=batch_size,
                                  frontier_cap=kk.get("frontier_cap"),
                                  with_edge=kk.get("with_edge", True),
                                  seed=seed + worker_id,
                                  last_hop_dedup=kk.get("last_hop_dedup",
                                                        True))
        collate_loader = NodeLoader(data, sampler, np.empty(0, np.int64),
                                    batch_size=batch_size)

    def chunk_len(payload):
        if kind == "link":
            return payload[0].shape[1]
        return payload.shape[0]

    def sample(payload, lo, hi):
        if kind == "node":
            return sampler.sample_from_nodes(
                NodeSamplerInput(payload[lo:hi]))
        if kind == "hetero_node":
            return sampler.sample_from_nodes(
                NodeSamplerInput(payload[lo:hi], kk["input_type"]))
        if kind == "link":
            eli_c, lab_c = payload
            return sampler.sample_from_edges(EdgeSamplerInput(
                row=eli_c[0, lo:hi], col=eli_c[1, lo:hi],
                label=None if lab_c is None else lab_c[lo:hi],
                neg_sampling=kk.get("neg_sampling")))
        if kind == "subgraph":
            return sampler.subgraph(NodeSamplerInput(payload[lo:hi]),
                                    max_degree=kk["max_degree"])
        raise ValueError(f"unknown sampling kind {kind!r}")

    # GLT_OBS_TRACE_DIR: the worker writes its own trace file, exported
    # when the parent sends _CMD_STOP.
    trace_path = auto_trace(f"worker{worker_id}")

    while True:
        # Idle worker awaiting commands: the parent owns its liveness, and
        # shutdown() sends _CMD_STOP then terminates stragglers: the wait
        # is bounded by the parent.
        # gltlint: disable-next=unbounded-blocking-get
        task = task_queue.get()
        cmd, payload, meta = (task if len(task) == 3
                              else (task[0], task[1], None))
        if cmd == _CMD_STOP:
            auto_trace_export(trace_path)
            break
        ctx = meta or {}
        n = chunk_len(payload)
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            with _span("worker.sample_batch", worker=worker_id,
                       lo=lo) as sp:
                sp.link(ctx.get("tid"), ctx.get("sid"))
                out = sample(payload, lo, hi)
                batch = collate_loader._collate_fn(out, hi - lo)
                if kind == "hetero_node":
                    msg = hetero_batch_to_message(batch)
                else:
                    msg = batch_to_message(batch)
            # Provenance tag: the consumer attributes delivered batches
            # per worker and reissues a dead worker's unfinished range.
            msg[_WORKER_KEY] = np.array([worker_id], np.int64)
            tracer = _current_tracer()
            if tracer is not None:
                msg[_OBS_KEY] = np.array(
                    [float(os.getpid()), tracer.now_us()], np.float64)
            channel.send(msg)


class MpSamplingProducer:
    """Spawn and drive sampling workers (the reference's
    ``DistMpSamplingProducer``).

    Args:
      dataset_builder: picklable top-level callable building the Dataset
        inside each worker, on ``options.device`` (e.g.
        ``attach_dataset`` with ``builder_args=(handle, 0.0, device)``).
      input_nodes: global seed ids for this loader.
    """

    def __init__(
        self,
        dataset_builder: Callable,
        builder_args: tuple,
        num_neighbors: Sequence[int],
        input_nodes: np.ndarray,
        batch_size: int,
        options: MpSamplingWorkerOptions,
        channel: ShmChannel,
        shuffle: bool = False,
        kind: str = "node",
        kind_kwargs: Optional[dict] = None,
        seed: int = 0,
    ):
        self.kind = kind
        # The seed-edge arrays stay host-side in the producer; workers get
        # per-chunk slices in their task payload (shipping the full array
        # to every spawned worker would copy it num_workers times).
        self.kind_kwargs = dict(kind_kwargs or {})
        self._link_eli = self.kind_kwargs.pop("edge_label_index", None)
        self._link_label = self.kind_kwargs.pop("edge_label", None)
        self.input_nodes = np.asarray(input_nodes).astype(np.int64)
        self.batch_size = int(batch_size)
        self.options = options
        self.channel = channel
        self.shuffle = shuffle
        # Loader seed + options.worker_seed both feed the stream so mp mode
        # honors per-loader seeding the way collocated mode does.
        self._base_seed = int(options.worker_seed) + int(seed)
        self._rng = np.random.default_rng(self._base_seed)
        self._ctx = mp.get_context("spawn")
        self._task_queues = []
        self._workers = []
        self._chunks = []
        self._delivered = []
        self._builder = (dataset_builder, builder_args, list(num_neighbors))
        self._epoch_trace_ctx: Optional[dict] = None
        self.max_respawns = 3
        # Cooperative stop for consumers blocked in iter_messages (e.g. a
        # server forwarder thread): set before shutdown() so the iterator
        # exits instead of treating the stopped workers as crashed.
        self._stopping = threading.Event()

    def _spawn(self, w: int):
        builder, args, nn = self._builder
        tq = self._ctx.Queue()
        p = self._ctx.Process(
            target=_sampling_worker_loop,
            args=(w, builder, args, nn, self.batch_size, self.channel,
                  tq, self._base_seed, self.kind,
                  self.kind_kwargs, self.options.device),
            daemon=True)
        p.start()
        return p, tq

    def init(self) -> None:
        for w in range(self.options.num_workers):
            p, tq = self._spawn(w)
            self._task_queues.append(tq)
            self._workers.append(p)

    def _respawn(self, w: int) -> None:
        p, tq = self._spawn(w)
        self._workers[w] = p
        self._task_queues[w] = tq

    def _ensure_alive(self) -> None:
        """Restart dead workers (the reference's mp workers die silently
        and the epoch hangs)."""
        for w, p in enumerate(self._workers):
            if not p.is_alive():
                self._respawn(w)

    def num_expected(self) -> int:
        n = self.input_nodes.shape[0]
        return (n + self.batch_size - 1) // self.batch_size

    def _payload(self, chunk: np.ndarray):
        """Task payload for a seed chunk: the ids themselves, or for the
        link kind the sliced seed-edge endpoints/labels (``chunk`` holds
        positions into the producer-held ``edge_label_index``)."""
        if self.kind == "link":
            lab = (None if self._link_label is None
                   else self._link_label[chunk])
            return (self._link_eli[:, chunk], lab)
        return chunk

    def produce_all(self, trace_ctx: Optional[dict] = None) -> None:
        """Kick one epoch: split seeds batch-aligned across workers (see
        :meth:`chunk_plan`).

        ``trace_ctx`` (the epoch's wire trace context) rides the task
        payload so worker-side sampling spans join the epoch's trace.
        """
        self._ensure_alive()
        self._epoch_trace_ctx = trace_ctx
        self._chunks = self.chunk_plan()
        self._delivered = [0] * len(self._chunks)
        for chunk, tq in zip(self._chunks, self._task_queues):
            if chunk.shape[0] > 0:
                tq.put((_CMD_SAMPLE_EPOCH, self._payload(chunk),
                        trace_ctx))

    def chunk_plan(self):
        """The next epoch's seed chunk of each worker: the epoch's order
        (a permutation from the producer's stream when shuffling) cut
        into ``ceil(batches / workers)`` whole batches a worker, the
        last worker taking the rest.  Draws from the shuffle stream."""
        ids = self.input_nodes
        if self.shuffle:
            ids = ids[self._rng.permutation(ids.shape[0])]
        k = max(1, self.options.num_workers)
        batches_per_worker = (self.num_expected() + k - 1) // k
        span = batches_per_worker * self.batch_size
        return [ids[w * span: (w + 1) * span] for w in range(k)]

    def iter_messages(self):
        """Yield every message of the current epoch, surviving mid-epoch
        worker death.

        recv has a heartbeat timeout; on timeout, dead workers are found,
        the channel is drained of their in-flight batches (the shm ring
        outlives the producer process, so nothing sent is lost), and each
        dead worker is respawned with its undelivered batch-aligned seed
        remainder.  Every batch of the epoch is yielded exactly once.
        """
        total = self.num_expected()
        got = 0
        fruitless_respawns = 0
        while got < total:
            if self._stopping.is_set():
                return
            msg = self.channel.recv(timeout=self.options.heartbeat_secs)
            if msg is not None:
                self._account(msg)
                got += 1
                fruitless_respawns = 0
                yield msg
                continue
            dead = [w for w, p in enumerate(self._workers)
                    if not p.is_alive()]
            if not dead:
                continue  # slow batch, keep waiting
            # Drain in-flight messages before computing remainders: a batch
            # already in the ring must not be reissued.
            while True:
                m = self.channel.recv(timeout=0)
                if m is None:
                    break
                self._account(m)
                got += 1
                yield m
            # Deterministic failures (bad builder, import error) would
            # otherwise respawn forever; give up once respawns stop
            # yielding any progress.
            fruitless_respawns += 1
            if fruitless_respawns > self.max_respawns:
                raise RuntimeError(
                    f"sampling workers died {fruitless_respawns} times "
                    f"without delivering a batch; giving up (check the "
                    f"dataset_builder runs in a spawned subprocess)")
            for w in dead:
                rest = self._chunks[w][
                    self._delivered[w] * self.batch_size:]
                self._respawn(w)
                self._chunks[w] = rest
                self._delivered[w] = 0
                if rest.shape[0] > 0:
                    self._task_queues[w].put(
                        (_CMD_SAMPLE_EPOCH, self._payload(rest),
                         self._epoch_trace_ctx))

    def _account(self, msg) -> None:
        tag = msg.pop(_WORKER_KEY, None)
        if tag is not None:
            self._delivered[int(np.asarray(tag).ravel()[0])] += 1
        stamp = msg.pop(_OBS_KEY, None)
        if stamp is not None:
            arr = np.asarray(stamp).ravel()
            if arr.shape[0] >= 2:
                _prop.record_clock_oneway(int(arr[0]), "worker",
                                          float(arr[1]))

    def shutdown(self) -> None:
        self._stopping.set()
        for tq in self._task_queues:
            try:
                tq.put((_CMD_STOP, None, None))
            except Exception:
                pass
        for p in self._workers:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._workers.clear()
        self._task_queues.clear()
