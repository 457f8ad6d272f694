"""Cross-process dataset sharing over POSIX shared memory (cf.
``glt_tpu/data/shared.py``).

``share_dataset`` copies a dataset's host arrays (CSR topology, edge
weights, feature rows and their id indirection, labels) into named shm
segments once; the returned :class:`DatasetHandle` pickles to a few
hundred bytes.  Spawned sampling workers ``attach_dataset`` it: the host
arrays map the same physical pages (one host copy for the whole fleet,
not one a worker), and each worker builds its own device tier from
them: the CSR on its device and the feature rows of its ``split_ratio``
(a CUDA worker holds its own copy of those on the card; its context
cannot read another process's device memory without IPC handles, which
the port does not use).

Usage with the worker-mode loaders (the handle rides the picklable
``dataset_builder`` mechanism)::

    handle = share_dataset(ds)            # once, in the trainer
    loader = DistNeighborLoader(
        [15, 10, 5], seeds,
        dataset_builder=attach_dataset, builder_args=(handle,),
        worker_options=MpSamplingWorkerOptions(num_workers=4))
    ...
    handle.unlink()                       # after the last epoch

The creator owns the segments: ``handle.unlink()`` (or process exit,
through the registered finalizer) frees them; attached processes only
unmap.  A segment is reserved whole at creation, so one that does not
fit in /dev/shm raises ``OSError`` with the size asked for (instead of a
SIGBUS at the first write past the free space).
"""
from __future__ import annotations

import atexit
import os
import secrets
import threading
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from ..utils.device import DeviceLike
from .dataset import Dataset
from .feature import Feature
from .graph import Graph
from .topology import CSRTopo

# Serializes the pre-3.13 register-suppression window in SharedArray.attach.
_attach_lock = threading.Lock()


class SharedArray:
    """A numpy array whose buffer lives in a named shm segment.

    Picklable: the pickle carries ``(name, shape, dtype)`` only; the
    receiving process attaches to the same physical pages.
    """

    def __init__(self, shm: shared_memory.SharedMemory, shape, dtype,
                 owner: bool):
        self._shm = shm
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._owner = owner
        self.array = np.ndarray(self.shape, self.dtype, buffer=shm.buf)

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "SharedArray":
        arr = np.ascontiguousarray(arr)
        size = max(arr.nbytes, 1)
        name = f"glt_{secrets.token_hex(8)}"
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        try:
            os.posix_fallocate(shm._fd, 0, size)
        except OSError as e:
            shm.close()
            shm.unlink()
            raise OSError(
                e.errno, f"cannot reserve {size} bytes of shared memory for "
                f"an array of shape {arr.shape} ({arr.dtype}): "
                f"{os.strerror(e.errno)}; /dev/shm is too small") from None
        out = cls(shm, arr.shape, arr.dtype, owner=True)
        out.array[...] = arr
        return out

    @classmethod
    def attach(cls, name: str, shape, dtype) -> "SharedArray":
        try:
            # 3.13+: attachers never register with this process's
            # resource tracker (only the creator may unlink).
            shm = shared_memory.SharedMemory(name=name, track=False)
        except TypeError:
            # Before 3.13 an attach registers with the resource tracker,
            # so the attacher's exit would unlink the creator's segment.
            # Suppress that one registration (scoped to this segment).
            from multiprocessing import resource_tracker

            seg = name if name.startswith("/") else "/" + name
            with _attach_lock:
                orig = resource_tracker.register

                def _skip_ours(rname, rtype, _orig=orig, _seg=seg):
                    if rtype == "shared_memory" and rname == _seg:
                        return None
                    return _orig(rname, rtype)

                resource_tracker.register = _skip_ours
                try:
                    shm = shared_memory.SharedMemory(name=name)
                finally:
                    resource_tracker.register = orig
        return cls(shm, shape, dtype, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def __reduce__(self):
        return (SharedArray.attach, (self._shm.name, self.shape, self.dtype))

    def close(self) -> None:
        """Unmap; the owner also frees the segment."""
        try:
            self._shm.close()
            if self._owner:
                self._shm.unlink()
        except FileNotFoundError:
            pass

    def __repr__(self) -> str:
        return (f"SharedArray(name={self._shm.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, owner={self._owner})")


def _share(arr: Optional[np.ndarray]) -> Optional[SharedArray]:
    return None if arr is None else SharedArray.from_array(np.asarray(arr))


class _SharedFeature:
    """One shared feature store: the host rows, the id indirection, the
    gathered dtype and the split ratio."""

    def __init__(self, f: Feature, share=_share):
        if f._host_full is None:
            raise ValueError(
                "a store-backed Feature (Feature.from_store) has no host "
                "rows to share; share the store's directory instead")
        self.rows = share(f._host_full)
        self.id2index = share(f._id2index_np)
        self.split_ratio = f.split_ratio
        self.dtype = f.dtype             # a torch dtype (picklable)

    def arrays(self):
        yield self.rows
        if self.id2index is not None:
            yield self.id2index

    def attach(self, split_ratio: Optional[float], device) -> Feature:
        sr = self.split_ratio if split_ratio is None else split_ratio
        return Feature(
            self.rows.array, split_ratio=sr,
            id2index=None if self.id2index is None else self.id2index.array,
            dtype=self.dtype, device=device)


def _share_feature_group(nf, share=_share):
    if nf is None:
        return {}
    group = nf if isinstance(nf, dict) else {None: nf}
    return {k: (None if f is None else _SharedFeature(f, share))
            for k, f in group.items()}


class DatasetHandle:
    """Picklable description of a shared dataset (a few hundred bytes):
    members hold :class:`SharedArray` handles, whose pickles carry
    segment names, not data."""

    def __init__(self, hetero, topos, node_feats, edge_feats, labels):
        self.hetero = hetero
        self.topos = topos            # key -> (indptr, indices, eids, w)
        self.node_feats = node_feats  # key -> _SharedFeature | None
        self.edge_feats = edge_feats  # key -> _SharedFeature | None
        self.labels = labels          # key -> SharedArray | None
        self._finalizer = None

    def _arrays(self):
        for group in (self.node_feats, self.edge_feats):
            for v in group.values():
                if v is not None:
                    yield from v.arrays()
        for v in self.labels.values():
            if v is not None:
                yield v
        for parts in self.topos.values():
            for v in parts:
                if v is not None:
                    yield v

    def nbytes(self) -> int:
        """Bytes held in shared memory."""
        return sum(a.array.nbytes for a in self._arrays())

    def unlink(self) -> None:
        """Free the shm segments (owner side)."""
        for a in self._arrays():
            a.close()
        if self._finalizer is not None:
            atexit.unregister(self.unlink)
            self._finalizer = None


def share_dataset(ds: Dataset) -> DatasetHandle:
    """Copy ``ds``'s host arrays into shared memory once; returns the
    picklable handle.  Segments are freed by ``handle.unlink()`` or at
    process exit."""
    hetero = ds.is_hetero
    graphs = ds.graph if hetero else {None: ds.graph}

    def narrow(arr):
        # Graph reads int32; sharing int64 would make every worker's
        # conversion a private copy.  Narrow once here.
        arr = np.asarray(arr)
        if (arr.dtype == np.int64
                and (arr.size == 0 or arr.max() < np.iinfo(np.int32).max)):
            return arr.astype(np.int32)
        return arr

    made = []

    def share(arr):
        out = _share(arr)
        if out is not None:
            made.append(out)
        return out

    try:
        topos = {}
        for k, g in graphs.items():
            t = g.topo
            topos[k] = (share(narrow(t.indptr)), share(narrow(t.indices)),
                        share(narrow(t.edge_ids)), share(t.edge_weights))
        nl = ds.node_labels
        labels_in = nl if isinstance(nl, dict) else {None: nl}
        labels = {k: share(v) for k, v in labels_in.items()}
        handle = DatasetHandle(hetero, topos,
                               _share_feature_group(ds.node_features, share),
                               _share_feature_group(ds.edge_features, share),
                               labels)
    except BaseException:
        for a in made:           # free what was shared before the failure
            a.close()
        raise
    atexit.register(handle.unlink)
    handle._finalizer = True
    return handle


def attach_dataset(handle: DatasetHandle,
                   split_ratio: Optional[float] = 0.0,
                   device: DeviceLike = None) -> Dataset:
    """Map a shared dataset into this process.

    The host arrays stay in the shared pages; the CSR and the device
    tier of each feature (``split_ratio`` of its rows) are built on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``"cpu"``).  ``split_ratio`` defaults to 0.0, ``glt_tpu``'s: every
    row stays in the shared host pages and gathers stage them to the
    device; ``None`` keeps each feature's own ratio (a CUDA process then
    holds its own device copy of those rows).
    """
    def topo(parts):
        indptr, indices, eids, w = parts
        return CSRTopo.from_csr_arrays(
            indptr.array, indices.array,
            None if eids is None else eids.array,
            None if w is None else w.array)

    ds = Dataset(device=device)
    # Pin the SharedArray objects (and their mappings) to the dataset:
    # the numpy views below point into them, and SharedMemory unmaps its
    # pages on GC.
    ds._shm_refs = list(handle._arrays())
    if handle.hetero:
        ds.graph = {k: Graph(topo(p), device=ds.device)
                    for k, p in handle.topos.items()}
    else:
        ds.graph = Graph(topo(handle.topos[None]), device=ds.device)

    def group(feats):
        return {k: (None if f is None else f.attach(split_ratio, ds.device))
                for k, f in feats.items()}

    nfeats = group(handle.node_feats)
    efeats = group(handle.edge_feats)
    if handle.hetero:
        ds.node_features = nfeats or None
        ds.edge_features = efeats or None
        lab = {k: v.array for k, v in handle.labels.items()
               if v is not None}
        ds.node_labels = lab or None
    else:
        ds.node_features = nfeats.get(None)
        ds.edge_features = efeats.get(None)
        lab = handle.labels.get(None)
        ds.node_labels = None if lab is None else lab.array
    return ds
