"""Channel-fed loader front-end, worker mode (cf.
``glt_tpu/distributed/dist_loader.py``).

The options' type selects the mode: collocated falls through to the
in-process loaders on ``dataset``; mp mode spawns sampling subprocesses
(:class:`~glt_tpu_torch.distributed.dist_sampling_producer.
MpSamplingProducer`, each on the options' device) and the trainer
iterates the shm channel's messages; remote mode streams batches from a
sampling server (:class:`~glt_tpu_torch.distributed.dist_client.
RemoteNeighborLoader`).  In the mp and remote modes each message becomes
a batch of tensors on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from ..channel import ShmChannel
from ..loader.node_loader import NeighborLoader
from ..loader.transform import Batch
from ..obs import metrics as _metrics
from ..utils.device import DeviceLike, resolve_device
from ..obs.trace import span as _span
from .dist_options import (
    CollocatedSamplingWorkerOptions,
    MpSamplingWorkerOptions,
    RemoteSamplingWorkerOptions,
)
from .dist_sampling_producer import MpSamplingProducer, WORKER_SAMPLER_KWARGS
from .sample_message import message_to_batch


class _DistLoaderBase:
    """Shared deployment-mode plumbing for the concrete loaders.

    Collocated mode needs a live ``dataset``; mp mode needs a picklable
    ``dataset_builder`` (each worker builds its dataset on the options'
    device); remote mode needs ``worker_options.server_addr``.
    ``device`` is where mp and remote batches land.
    """

    _KIND = "node"
    # When set, mp mode rejects kind_kwargs outside this set (workers would
    # silently drop them); None means the subclass's explicit signature
    # already bounds what reaches the workers.
    _ALLOWED_MP_KWARGS: Optional[frozenset] = None

    def __init__(
        self,
        num_neighbors: Sequence[int],
        input_seeds: np.ndarray,
        batch_size: int = 512,
        shuffle: bool = False,
        dataset=None,
        dataset_builder: Optional[Callable] = None,
        builder_args: tuple = (),
        worker_options=None,
        seed: int = 0,
        device: DeviceLike = None,
        **kind_kwargs,
    ):
        worker_options = worker_options or CollocatedSamplingWorkerOptions()
        self.options = worker_options
        # Collocated batches come from the dataset's own device.
        self.device = (None if isinstance(worker_options,
                                          CollocatedSamplingWorkerOptions)
                       else resolve_device(device))
        self._inner = None
        self._remote = None
        self._producer: Optional[MpSamplingProducer] = None

        if isinstance(worker_options, RemoteSamplingWorkerOptions):
            # Producers live on the sampling server named by
            # ``worker_options.server_addr``; batches stream back over the
            # fault-tolerant socket protocol.
            if worker_options.server_addr is None:
                raise ValueError(
                    "remote mode requires "
                    "RemoteSamplingWorkerOptions(server_addr=(host, port))")
            if self._KIND != "node":
                raise NotImplementedError(
                    f"remote mode serves node sampling only (got "
                    f"{self._KIND!r}); use an mp/collocated loader")
            from .dist_client import RemoteNeighborLoader

            self._remote = RemoteNeighborLoader(
                tuple(worker_options.server_addr), num_neighbors,
                input_seeds, batch_size=batch_size, seed=seed,
                worker_options=worker_options, device=self.device)
            self._inner = self._remote
        elif isinstance(worker_options, CollocatedSamplingWorkerOptions):
            if dataset is None:
                raise ValueError("collocated mode requires dataset=")
            self._inner = self._make_inner(
                dataset, num_neighbors, input_seeds, batch_size, shuffle,
                seed, kind_kwargs)
        elif isinstance(worker_options, MpSamplingWorkerOptions):
            if dataset_builder is None:
                raise ValueError("mp mode requires dataset_builder=")
            if self._ALLOWED_MP_KWARGS is not None:
                bad = set(kind_kwargs) - self._ALLOWED_MP_KWARGS
                if bad:
                    raise TypeError(
                        f"mp sampling workers do not support {sorted(bad)}"
                        f" (collocated mode only)")
            self.channel = ShmChannel(
                capacity_bytes=worker_options.channel_capacity_bytes)
            self._producer = MpSamplingProducer(
                dataset_builder, builder_args, num_neighbors, input_seeds,
                batch_size, worker_options, self.channel, shuffle=shuffle,
                kind=self._KIND, kind_kwargs=kind_kwargs or None, seed=seed)
            self._producer.init()
            self._num_batches = self._producer.num_expected()
        else:
            raise TypeError(f"unknown worker options {worker_options!r}")

    def _make_inner(self, dataset, num_neighbors, input_seeds, batch_size,
                    shuffle, seed, kind_kwargs):
        raise NotImplementedError

    def __iter__(self) -> Iterator[Batch]:
        if self._inner is not None:
            yield from self._inner
            return
        # iter_messages survives mid-epoch worker death (recv heartbeat +
        # seed reissue).
        with _span("dist_loader.mp_epoch"):
            self._producer.produce_all()
            mp_batches = _metrics.counter(
                "glt.loader.mp_batches",
                "batches received over the shm channel (mp mode)")
            for msg in self._producer.iter_messages():
                mp_batches.inc()
                yield message_to_batch(msg, device=self.device)

    def __len__(self) -> int:
        if self._inner is not None:
            return len(self._inner)
        return self._num_batches

    def shutdown(self) -> None:
        if self._remote is not None:
            self._remote.shutdown()
            self._remote = None
            self._inner = None
        if self._producer is not None:
            self._producer.shutdown()
            self.channel.close()
            self._producer = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


class DistNeighborLoader(_DistLoaderBase):
    """Worker-mode neighbor loader: ``input_seeds`` are global seed node
    ids; each delivered :class:`Batch` is a fully collated multi-hop
    sample (features and labels gathered worker-side in mp mode,
    server-side in remote mode, in-process in collocated mode).
    """

    _KIND = "node"
    _ALLOWED_MP_KWARGS = WORKER_SAMPLER_KWARGS

    def _make_inner(self, dataset, num_neighbors, input_seeds, batch_size,
                    shuffle, seed, kind_kwargs):
        return NeighborLoader(
            dataset, num_neighbors, input_seeds, batch_size=batch_size,
            shuffle=shuffle, seed=seed, **kind_kwargs)


class DistHeteroNeighborLoader(_DistLoaderBase):
    """Worker-mode heterogeneous neighbor loader: ``input_nodes`` is
    ``(node_type, ids)``; channel messages carry the per-type flattening
    (:func:`~glt_tpu_torch.distributed.sample_message.
    hetero_batch_to_message`).
    """

    _KIND = "hetero_node"

    def __init__(
        self,
        num_neighbors,
        input_nodes,
        batch_size: int = 512,
        shuffle: bool = False,
        frontier_cap: Optional[int] = None,
        dataset=None,
        dataset_builder: Optional[Callable] = None,
        builder_args: tuple = (),
        worker_options=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if not (isinstance(input_nodes, tuple) and len(input_nodes) == 2):
            raise ValueError(
                "input_nodes must be (node_type, ids) for hetero loading")
        input_type, ids = input_nodes
        super().__init__(
            num_neighbors, np.asarray(ids).astype(np.int64),
            batch_size=batch_size, shuffle=shuffle, dataset=dataset,
            dataset_builder=dataset_builder, builder_args=builder_args,
            worker_options=worker_options, seed=seed, device=device,
            input_type=input_type, frontier_cap=frontier_cap)

    def _make_inner(self, dataset, num_neighbors, input_seeds, batch_size,
                    shuffle, seed, kind_kwargs):
        from ..loader.hetero_neighbor_loader import HeteroNeighborLoader

        return HeteroNeighborLoader(
            dataset, num_neighbors,
            (kind_kwargs["input_type"], input_seeds),
            batch_size=batch_size, shuffle=shuffle,
            frontier_cap=kind_kwargs.get("frontier_cap"), seed=seed)


class DistLinkNeighborLoader(_DistLoaderBase):
    """Worker-mode link loader: seed *edges* drive ``sample_from_edges``;
    the messages carry ``edge_label_index`` / ``edge_label`` (binary) or
    the triplet indices, the metadata the collocated
    :class:`~glt_tpu_torch.loader.LinkNeighborLoader` emits.
    """

    _KIND = "link"

    def __init__(
        self,
        num_neighbors: Sequence[int],
        edge_label_index: np.ndarray,
        edge_label: Optional[np.ndarray] = None,
        neg_sampling=None,
        batch_size: int = 512,
        shuffle: bool = False,
        dataset=None,
        dataset_builder: Optional[Callable] = None,
        builder_args: tuple = (),
        worker_options=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        eli = np.asarray(edge_label_index).astype(np.int64)
        lab = None if edge_label is None else np.asarray(edge_label)
        super().__init__(
            num_neighbors, np.arange(eli.shape[1], dtype=np.int64),
            batch_size=batch_size, shuffle=shuffle, dataset=dataset,
            dataset_builder=dataset_builder, builder_args=builder_args,
            worker_options=worker_options, seed=seed, device=device,
            edge_label_index=eli, edge_label=lab, neg_sampling=neg_sampling)

    def _make_inner(self, dataset, num_neighbors, input_seeds, batch_size,
                    shuffle, seed, kind_kwargs):
        from ..loader.link_loader import LinkNeighborLoader

        return LinkNeighborLoader(
            dataset, num_neighbors, kind_kwargs["edge_label_index"],
            edge_label=kind_kwargs.get("edge_label"),
            neg_sampling=kind_kwargs.get("neg_sampling"),
            batch_size=batch_size, shuffle=shuffle, seed=seed)


class DistSubGraphLoader(_DistLoaderBase):
    """Worker-mode induced-subgraph loader."""

    _KIND = "subgraph"

    def __init__(
        self,
        num_neighbors: Sequence[int],
        input_seeds: np.ndarray,
        batch_size: int = 64,
        max_degree: int = 64,
        shuffle: bool = False,
        dataset=None,
        dataset_builder: Optional[Callable] = None,
        builder_args: tuple = (),
        worker_options=None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__(
            num_neighbors, input_seeds, batch_size=batch_size,
            shuffle=shuffle, dataset=dataset,
            dataset_builder=dataset_builder, builder_args=builder_args,
            worker_options=worker_options, seed=seed, device=device,
            max_degree=max_degree)

    def _make_inner(self, dataset, num_neighbors, input_seeds, batch_size,
                    shuffle, seed, kind_kwargs):
        from ..loader.subgraph_loader import SubGraphLoader

        return SubGraphLoader(
            dataset, num_neighbors, input_seeds, batch_size=batch_size,
            max_degree=kind_kwargs["max_degree"], shuffle=shuffle, seed=seed)
