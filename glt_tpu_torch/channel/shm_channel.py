"""Shared-memory channel over the native ring (cf.
``glt_tpu/channel/shm_channel.py``): capacity-bounded cross-process
transport of serialized ``SampleMessage`` dicts, picklable by ring name
so spawned workers re-attach on the other side.
"""
from __future__ import annotations

import ctypes
import os
import uuid
from typing import Optional

from .base import ChannelBase, SampleMessage
from .native import lib
from .serialization import deserialize, serialize


class ShmChannel(ChannelBase):
    """Args:
      capacity_bytes: ring size (64 MiB by default, as ``glt_tpu``'s).
        The segment's pages are reserved at creation: a ring that does
        not fit in /dev/shm raises ``OSError`` naming the size asked for.
      name: optional explicit shm name (attach when it already exists).
    """

    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024,
                 name: Optional[str] = None, _attach: bool = False):
        self._lib = lib()
        self.capacity = int(capacity_bytes)
        self.name = name or f"/glt_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        self._owner = not _attach
        if _attach:
            self._q = self._lib.glt_shmq_attach(self.name.encode())
        else:
            self._q = self._lib.glt_shmq_create(self.name.encode(),
                                                self.capacity)
        if not self._q:
            err = ctypes.get_errno()
            raise OSError(
                err, f"failed to {'attach' if _attach else 'create'} shm "
                f"queue {self.name} of {self.capacity} bytes "
                f"({os.strerror(err)}; /dev/shm may be too small)")

    def send(self, msg: SampleMessage) -> None:
        """Enqueue one message (blocks while the ring is full).  A
        message larger than the ring raises ``ValueError``."""
        data = serialize(msg)
        rc = self._lib.glt_shmq_enqueue(self._q, data, len(data))
        if rc != 0:
            raise ValueError(
                f"message of {len(data)} bytes exceeds channel capacity "
                f"{self.capacity}")

    def recv(self, timeout: Optional[float] = None
             ) -> Optional[SampleMessage]:
        """Dequeue one message, waiting up to ``timeout`` seconds
        (``None``: forever); ``None`` on timeout.  The size peek and the
        payload copy are one native critical section, so several
        consumers of one ring are safe."""
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        buf = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_uint64()
        rc = self._lib.glt_shmq_dequeue_alloc(
            self._q, ctypes.byref(buf), ctypes.byref(size), timeout_ms)
        if rc == 1:
            return None
        if rc != 0:
            raise RuntimeError("shm dequeue failed")
        try:
            # deserialize copies each array out of this view, so freeing
            # the native buffer afterwards is safe.
            view = memoryview(
                (ctypes.c_uint8 * size.value).from_address(
                    ctypes.addressof(buf.contents))).cast("B")
            return deserialize(view)
        finally:
            self._lib.glt_shmq_buf_free(buf)

    def empty(self) -> bool:
        return self._lib.glt_shmq_msg_count(self._q) == 0

    def __reduce__(self):
        return (_attach_channel, (self.name, self.capacity))

    def close(self, unlink: Optional[bool] = None) -> None:
        """Unmap; the creator (or ``unlink=True``) also removes the
        segment."""
        if self._q:
            self._lib.glt_shmq_close(self._q)
            self._q = None
            if unlink if unlink is not None else self._owner:
                self._lib.glt_shmq_unlink(self.name.encode())

    def __del__(self):
        try:
            self.close(unlink=False)
        except Exception:
            pass


def _attach_channel(name: str, capacity: int) -> ShmChannel:
    return ShmChannel(capacity_bytes=capacity, name=name, _attach=True)
