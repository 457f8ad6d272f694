"""Channel interface and bounded queue waits (cf.
``glt_tpu/channel/base.py``).

A ``SampleMessage`` is a flat ``Dict[str, np.ndarray]``; channels move
them between sampling producers and their consumer.
"""
from __future__ import annotations

import queue
import threading
from abc import ABC, abstractmethod
from typing import Callable, Dict, Optional

import numpy as np

SampleMessage = Dict[str, np.ndarray]


class QueueSourceDied(RuntimeError):
    """The producer feeding a queue died with the consumer still waiting.

    Raised by :func:`bounded_get` when its liveness probe turns false and
    a final drain finds the queue empty: an error, never a hang.
    """


def bounded_get(q: "queue.Queue",
                alive: Optional[Callable[[], bool]] = None,
                poll: float = 0.5,
                on_wait: Optional[Callable[[], None]] = None):
    """Get from a queue with bounded waits and a liveness recheck.

    Wakes every ``poll`` seconds, calls ``on_wait`` (lease renewal,
    heartbeat) and rechecks ``alive()``.  Once the source is not alive
    the queue is drained one last time (a source's final put races its
    death) before :class:`QueueSourceDied` is raised.
    """
    while True:
        try:
            return q.get(timeout=poll)
        except queue.Empty:
            pass
        if on_wait is not None:
            on_wait()
        if alive is not None and not alive():
            try:
                return q.get_nowait()
            except queue.Empty:
                raise QueueSourceDied(
                    "queue source died (or stopped) with the consumer "
                    "still waiting") from None


def bounded_put(q: "queue.Queue", item, stop: threading.Event,
                timeout: float = 0.5) -> bool:
    """Put into a bounded queue, giving up when ``stop`` is set (a
    producer whose consumer vanished exits instead of wedging on a full
    queue).  Returns False iff stopped before the item was enqueued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=timeout)
            return True
        except queue.Full:
            continue
    return False


class ChannelBase(ABC):
    @abstractmethod
    def send(self, msg: SampleMessage) -> None:
        raise NotImplementedError

    @abstractmethod
    def recv(self) -> SampleMessage:
        raise NotImplementedError

    def empty(self) -> bool:
        return False
