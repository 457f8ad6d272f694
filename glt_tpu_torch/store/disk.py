"""Disk-resident feature tier: raw row-major file + checksummed manifest
(cf. ``glt_tpu/store/disk.py``, same on-disk format).

One ``features.bin`` of C-contiguous ``[num_rows, dim]`` rows next to one
``manifest.json`` carrying ``format_version``, the LOGICAL ``dtype``,
``shape``, the file's ``sha256`` and, for a compressed store, ``codec``
and (int8) ``quant.scale/zero``.  A store written by either package
opens in the other, and the same input and codec give the same sha256:
bf16 rows are the same bytes whether they were rounded by ``ml_dtypes``
or by :mod:`glt_tpu_torch.store.quant` (which carries them on the host
as ``np.uint16`` patterns).

Publish discipline: the store directory is written under a private
``.tmp-*`` name and published with ONE ``os.replace`` (an overwrite
moves the old root to ``.trash-*`` first), so a reader sees the whole
old store or the whole new one.  Truncation surfaces at open time as
:class:`StoreCorruptError` (size check), bit rot through
:meth:`DiskFeatureStore.verify` (full checksum).

Reads go through ``np.memmap`` fancy indexing in row chunks; numpy
releases the GIL during the copy, so chunks fan out over a thread pool.
``faults`` is a duck-typed hook: its ``on_disk_read()`` is called before
every chunk read, so a test can place a read error or stall at an exact
point.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np

from . import quant

FORMAT_VERSION = 1
DATA_NAME = "features.bin"
MANIFEST_NAME = "manifest.json"


class StoreError(RuntimeError):
    """Feature-store read/write failed (missing, malformed, out of range)."""


class StoreCorruptError(StoreError):
    """The store file contradicts its manifest: truncated or bit-rotted.

    Raised at open time (size mismatch) or by :meth:`DiskFeatureStore.
    verify` (checksum mismatch).  Structured by design — a corrupt tier
    must never surface as a zero-row batch."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    # Best-effort directory fsync (some filesystems refuse dir fds).
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_feature_store(root: str, array: np.ndarray, codec: str = "raw",
                        overwrite: bool = False) -> str:
    """Write ``array`` (``[N, d]``) as a feature store directory at ``root``.

    Atomic publish: everything lands under ``.tmp-<pid>`` next
    to ``root`` and ONE ``os.replace`` makes it visible.  Returns
    ``root``.

    Args:
      codec: row encoding — ``"raw"`` stores ``array`` bit-exactly;
        ``"bf16"``/``"int8"`` compress through :mod:`.quant` (manifest
        records the codec and, for int8, the per-column scale/zero).  The manifest ``dtype`` is always the
        LOGICAL dtype readers decode to.
      overwrite: with an existing ``root``, ``False`` (the default)
        refuses; ``True`` publishes over it atomically — the new tree
        is fully written under ``.tmp-*``, the old root is moved aside
        to a ``.trash-*`` sibling, the tmp is renamed in, and the trash
        is deleted.  Readers see either the complete old store or the
        complete new one, never a mix.
    """
    array = np.asarray(array)
    if array.ndim == 1:
        array = array[:, None]
    if array.ndim != 2:
        raise StoreError(
            f"feature store rows must be [N, d]; got shape {array.shape}")
    root = os.path.abspath(root)
    if os.path.exists(root) and not overwrite:
        raise StoreError(f"feature store target already exists: {root}")
    encoded, spec = quant.encode(array, codec)
    parent = os.path.dirname(root) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".tmp-{os.path.basename(root)}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    data_path = os.path.join(tmp, DATA_NAME)
    np.ascontiguousarray(encoded).tofile(data_path)
    manifest = {
        "format_version": FORMAT_VERSION,
        "dtype": np.dtype(spec.logical_dtype).str,
        "shape": [int(array.shape[0]), int(array.shape[1])],
        "sha256": _sha256(data_path),
    }
    manifest.update(quant.spec_to_manifest(spec))
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as fh:
        json.dump(manifest, fh)
        fh.flush()
        os.fsync(fh.fileno())
    with open(data_path, "rb") as fh:
        os.fsync(fh.fileno())
    _fsync_dir(tmp)
    if os.path.exists(root):
        trash = os.path.join(
            parent, f".trash-{os.path.basename(root)}-{os.getpid()}")
        os.replace(root, trash)
        os.replace(tmp, root)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, root)
    _fsync_dir(parent)
    return root


class DiskFeatureStore:
    """mmap-served row reads over one published feature-store directory.

    :meth:`gather_into` takes ``(out, row_ids, pool, row_chunk)`` and
    copies GIL-releasing row chunks.  Thread-safe: the byte counters are
    lock-protected and the memmap is read-only.

    Args:
      root: published store directory (``features.bin`` + manifest).
      faults: optional hook object; its ``on_disk_read()`` is called
        before every chunk read (it may raise or sleep).
      verify: checksum the data file against the manifest at open
        (full-file read — the cheap size check always runs).
    """

    def __init__(self, root: str, faults=None, verify: bool = False):
        self.root = os.path.abspath(root)
        mpath = os.path.join(self.root, MANIFEST_NAME)
        try:
            with open(mpath) as fh:
                man = json.load(fh)
        except (OSError, ValueError) as e:
            raise StoreError(f"unreadable store manifest {mpath}: {e}")
        if man.get("format_version") != FORMAT_VERSION:
            raise StoreError(
                f"store format {man.get('format_version')!r} != "
                f"{FORMAT_VERSION} at {self.root}")
        # ``dtype`` is the STORAGE dtype (what features.bin holds and
        # what flows through memmap reads, stager buffers and device
        # transfers); ``logical_dtype`` is what rows decode to.  For a
        # raw store the two coincide and nothing changes.
        self.codec = man.get("codec", "raw")
        self.logical_dtype = np.dtype(man["dtype"])
        try:
            self.dtype = quant.storage_dtype(self.codec, self.logical_dtype)
        except ValueError as e:
            raise StoreError(f"bad store manifest {mpath}: {e}")
        self._quant_spec = quant.spec_from_manifest(man)
        shape = man["shape"]
        self.num_rows, self.dim = int(shape[0]), int(shape[1])
        self.row_nbytes = self.dim * self.dtype.itemsize
        if (self.codec == "int8"
                and len(np.asarray(self._quant_spec.scale)) != self.dim):
            raise StoreError(
                f"int8 store manifest {mpath} carries "
                f"{len(np.asarray(self._quant_spec.scale))} scale entries "
                f"for dim {self.dim}")
        self.sha256 = man["sha256"]
        self._data_path = os.path.join(self.root, DATA_NAME)
        expected = self.num_rows * self.row_nbytes
        try:
            actual = os.path.getsize(self._data_path)
        except OSError as e:
            raise StoreError(f"missing store data file: {e}")
        if actual != expected:
            raise StoreCorruptError(
                f"store data file {self._data_path} holds {actual} bytes, "
                f"manifest says {expected} ([{self.num_rows}, {self.dim}] "
                f"{self.dtype}) — truncated or torn")
        self.faults = faults
        self._arr: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self.bytes_read = 0
        self.chunk_reads = 0

    def verify(self) -> None:
        """Full checksum against the manifest (reads the whole file)."""
        got = _sha256(self._data_path)
        if got != self.sha256:
            raise StoreCorruptError(
                f"store data file {self._data_path} sha256 {got[:12]}… != "
                f"manifest {self.sha256[:12]}… — bit rot or torn write")

    @property
    def shape(self):
        return (self.num_rows, self.dim)

    @property
    def is_compressed(self) -> bool:
        return self.codec != "raw"

    def quant_spec(self) -> "quant.QuantSpec":
        """The :class:`~glt_tpu_torch.store.quant.QuantSpec` decoding this
        store."""
        return self._quant_spec

    def _mapped(self) -> np.ndarray:
        """The read-only memmap view, created lazily (one per store)."""
        if self._arr is None:
            self._arr = np.memmap(self._data_path, dtype=self.dtype,
                                  mode="r", shape=(self.num_rows, self.dim))
        return self._arr

    def _read_chunk(self, out: np.ndarray, sel: np.ndarray,
                    row_ids: np.ndarray, lo: int, hi: int) -> None:
        """One GIL-releasing page-cache copy of rows ``sel[lo:hi]``."""
        if self.faults is not None:
            self.faults.on_disk_read()
        arr = self._mapped()
        idx = sel[lo:hi]
        out[idx] = arr[row_ids[idx]]
        with self._lock:
            self.bytes_read += int(idx.size) * self.row_nbytes
            self.chunk_reads += 1

    def gather_into(self, out: np.ndarray, row_ids: np.ndarray,
                    pool=None, row_chunk: int = 16384) -> list:
        """Gather ``row_ids`` (< 0 = skip) into ``out`` rows, row-chunked.

        With ``pool`` the read splits into ``row_chunk``-row work items and returns their
        futures (caller awaits); without, it runs inline and returns
        ``[]``.  Out-of-range ids raise a structured :class:`StoreError`
        before any byte moves.
        """
        row_ids = np.asarray(row_ids)
        sel = np.where(row_ids >= 0)[0]
        if sel.size == 0:
            return []
        mx = int(row_ids[sel].max())
        if mx >= self.num_rows:
            raise StoreError(
                f"row id {mx} out of range for {self.num_rows}-row store "
                f"{self.root}")
        if pool is None:
            self._read_chunk(out, sel, row_ids, 0, sel.size)
            return []
        return [pool.submit(self._read_chunk, out, sel, row_ids,
                            lo, min(lo + row_chunk, sel.size))
                for lo in range(0, sel.size, row_chunk)]

    def read_rows(self, row_ids: np.ndarray) -> np.ndarray:
        """``[len(row_ids), dim]`` rows (zeros at ids < 0)."""
        row_ids = np.asarray(row_ids)
        out = np.zeros((row_ids.shape[0], self.dim), self.dtype)
        self.gather_into(out, row_ids)
        return out

    def __repr__(self) -> str:
        return (f"DiskFeatureStore(shape={self.shape}, dtype={self.dtype}, "
                f"codec={self.codec!r}, root={self.root!r})")


class FeatureStoreWriter:
    """Streaming range writer for a feature store: sweeps land in place,
    :meth:`finalize` checksums and atomically publishes.

    The refresh driver writes one node partition at a time, so the full
    ``[N, d]`` output never materializes in memory: rows land directly
    in a memmapped data file under a DETERMINISTIC ``.partial-<name>``
    sibling of ``root`` (no pid — a restarted writer re-attaches to the
    same partial file).  Resume safety comes from idempotence, not
    journaling: sweeps cover disjoint row ranges and encoding is a pure
    function of ``(rows, spec)``, so rewriting a range after a crash is
    bit-identical and the final sha256 matches an uninterrupted run.

    Publish keeps the same discipline: readers only ever see ``root``
    appear via ``os.replace``; the partial directory is never a valid
    store (no manifest until finalize writes one as its last act).

    ``int8`` needs an explicit pre-calibrated
    :class:`~glt_tpu_torch.store.quant.QuantSpec` (calibration is a whole-matrix reduction a
    streaming writer cannot do); ``raw``/``bf16`` need none.
    """

    def __init__(self, root: str, num_rows: int, dim: int,
                 logical_dtype=np.float32, codec: str = "raw",
                 spec: Optional["quant.QuantSpec"] = None,
                 overwrite: bool = False):
        self.root = os.path.abspath(root)
        if os.path.exists(self.root) and not overwrite:
            raise StoreError(
                f"feature store target already exists: {self.root}")
        self.num_rows, self.dim = int(num_rows), int(dim)
        if spec is None:
            if codec == "int8":
                raise StoreError(
                    "int8 streaming writes need an explicit QuantSpec "
                    "(per-column calibration is a whole-matrix pass)")
            spec = (quant.raw_spec(logical_dtype) if codec == "raw"
                    else quant.QuantSpec(codec, np.dtype(np.float32)))
        self.codec = spec.codec
        self.spec = spec
        self.storage_dtype = quant.storage_dtype(self.codec,
                                                 spec.logical_dtype)
        self._overwrite = overwrite
        parent = os.path.dirname(self.root) or "."
        os.makedirs(parent, exist_ok=True)
        self._tmp = os.path.join(
            parent, f".partial-{os.path.basename(self.root)}")
        os.makedirs(self._tmp, exist_ok=True)
        self._data_path = os.path.join(self._tmp, DATA_NAME)
        nbytes = self.num_rows * self.dim * self.storage_dtype.itemsize
        reattach = (os.path.exists(self._data_path)
                    and os.path.getsize(self._data_path) == nbytes)
        self._mm = np.memmap(self._data_path, dtype=self.storage_dtype,
                             mode="r+" if reattach else "w+",
                             shape=(self.num_rows, self.dim))
        self.reattached = reattach
        self._finalized = False

    def write_rows(self, lo: int, rows: np.ndarray) -> None:
        """Encode and land ``rows`` at row offset ``lo`` (idempotent)."""
        if self._finalized:
            raise StoreError("write_rows after finalize")
        rows = np.asarray(rows)
        hi = lo + rows.shape[0]
        if lo < 0 or hi > self.num_rows or rows.shape[1] != self.dim:
            raise StoreError(
                f"write_rows range [{lo}, {hi}) x {rows.shape[1]} out of "
                f"bounds for [{self.num_rows}, {self.dim}] store")
        self._mm[lo:hi] = quant.encode_with_spec(rows, self.spec)

    def flush(self) -> None:
        """Flush landed rows to the partial file (checkpoint barrier:
        a resumed writer re-attaches to everything flushed here)."""
        if not self._finalized:
            self._mm.flush()

    def abort(self) -> None:
        """Drop the partial tree (nothing was ever visible at root)."""
        self._mm = None
        shutil.rmtree(self._tmp, ignore_errors=True)

    def finalize(self) -> str:
        """Flush, checksum, write the manifest and publish atomically."""
        if self._finalized:
            return self.root
        self._mm.flush()
        self._mm = None
        with open(self._data_path, "rb") as fh:
            os.fsync(fh.fileno())
        manifest = {
            "format_version": FORMAT_VERSION,
            "dtype": np.dtype(self.spec.logical_dtype).str,
            "shape": [self.num_rows, self.dim],
            "sha256": _sha256(self._data_path),
        }
        manifest.update(quant.spec_to_manifest(self.spec))
        with open(os.path.join(self._tmp, MANIFEST_NAME), "w") as fh:
            json.dump(manifest, fh)
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(self._tmp)
        parent = os.path.dirname(self.root) or "."
        if os.path.exists(self.root):
            if not self._overwrite:
                raise StoreError(
                    f"feature store target appeared during write: "
                    f"{self.root}")
            trash = os.path.join(
                parent,
                f".trash-{os.path.basename(self.root)}-{os.getpid()}")
            os.replace(self.root, trash)
            os.replace(self._tmp, self.root)
            shutil.rmtree(trash, ignore_errors=True)
        else:
            os.replace(self._tmp, self.root)
        _fsync_dir(parent)
        self._finalized = True
        return self.root
