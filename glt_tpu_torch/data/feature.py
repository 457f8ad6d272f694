"""Device-resident feature matrix (cf. ``glt_tpu/data/feature.py``).

This slice ports the fully device-resident store (``split_ratio ==
1.0``): the rows live in one tensor on ``device``, ``id2index``
translates global ids to rows, ``dtype`` casts the stored rows (f32 or
bf16), and ``dedup=True`` routes gathers through
:func:`~glt_tpu_torch.ops.dedup_gather.dedup_gather_rows`.  Padding ids
(< 0) give zero rows.  The tiered, cached and disk-backed stores are
later work.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

_I32_MAX = np.iinfo(np.int32).max
_I32_MIN = np.iinfo(np.int32).min

# numpy -> torch dtype of a stored table when no dtype is given: 64-bit
# inputs narrow to 32 bits, as jax does with 64-bit mode off.
_NARROW = {np.dtype(np.float64): torch.float32,
           np.dtype(np.int64): torch.int32}


def require_int32_ids(ids) -> None:
    """Refuse host id VALUES that overflow int32 (the engine runs int32
    ids; a silent downcast would read the wrong rows)."""
    if isinstance(ids, torch.Tensor):
        return
    a = np.asarray(ids)
    if a.dtype.kind in "iu" and a.dtype.itemsize > 4 and a.size:
        mx, mn = int(a.max()), int(a.min())
        if mx > _I32_MAX or mn < _I32_MIN:
            raise OverflowError(
                f"node ids [{mn}, {mx}] overflow int32; the id space must "
                f"fit int32 (relabel/partition first)")


class Feature:
    """Row-gatherable feature matrix on one device.

    Args:
      feature_array: ``[N, d]`` host array.
      split_ratio: fraction of rows on the device; only 1.0 is ported.
      id2index: optional ``[N]`` indirection from global id to row.
      dtype: optional torch dtype of the stored rows (e.g.
        ``torch.bfloat16``).
      dedup: gather each unique row once (bit-identical output).
      device: where the rows live (default ``"cuda"``).
    """

    def __init__(self, feature_array: np.ndarray, split_ratio: float = 1.0,
                 id2index: Optional[np.ndarray] = None,
                 dtype: Optional[torch.dtype] = None, dedup: bool = False,
                 device: DeviceLike = None):
        if float(split_ratio) != 1.0:
            raise NotImplementedError(
                "glt_tpu_torch.Feature holds device-resident stores only "
                "(split_ratio == 1.0); tiered stores are not ported yet")
        self.device = resolve_device(device)
        arr = np.asarray(feature_array)
        if arr.ndim == 1:
            arr = arr[:, None]
        self._n, self._dim = arr.shape
        self.split_ratio = 1.0
        if dtype is None:
            dtype = _NARROW.get(arr.dtype) or torch.from_numpy(arr[:0]).dtype
        self.dtype = dtype
        self.dedup = bool(dedup)
        self._hot = torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=self.device, dtype=dtype)
        self._id2index = (
            None if id2index is None
            else torch.as_tensor(np.asarray(id2index, np.int32)).to(
                self.device))

    def _gather_hot_impl(self, hot: torch.Tensor,
                         id2index: Optional[torch.Tensor],
                         ids: torch.Tensor) -> torch.Tensor:
        from ..ops.dedup_gather import dedup_gather_rows
        from ..ops.gather_cuda import gather_rows

        ids = ids.to(torch.int32)
        if self.dedup:
            return dedup_gather_rows(hot, ids, id2index=id2index)
        valid = ids >= 0
        idx = torch.where(valid, ids, 0)
        if id2index is not None:
            idx = id2index[idx.clamp(max=id2index.shape[0] - 1).long()]
        rows = gather_rows(hot, idx.contiguous())
        return torch.where(valid[:, None], rows, 0)

    def gather(self, ids) -> torch.Tensor:
        """Rows for ``ids`` ``[B]`` (tensor or host array) as ``[B, d]``
        on the feature's device; padding ids give zero rows."""
        require_int32_ids(ids)
        if isinstance(ids, torch.Tensor):
            ids = ids.to(self.device)
        else:
            ids = torch.as_tensor(np.asarray(ids).astype(np.int32)).to(
                self.device)
        return self._gather_hot_impl(self._hot, self._id2index, ids)

    __getitem__ = gather

    # -- shape info --------------------------------------------------------
    @property
    def shape(self):
        return (self._n, self._dim)

    @property
    def size(self) -> int:
        return self._n

    @property
    def id2index(self) -> Optional[torch.Tensor]:
        return self._id2index

    @property
    def hot_rows(self) -> torch.Tensor:
        """The device-resident rows ``[N, d]``."""
        return self._hot

    def __len__(self) -> int:
        return self._n

    def __repr__(self) -> str:
        return (f"Feature(shape={self.shape}, dtype={self.dtype}, "
                f"device={str(self.device)!r})")
