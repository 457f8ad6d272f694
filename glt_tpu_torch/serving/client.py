"""InferenceClient: the thin latency-path client for subgraph serving
(cf. ``glt_tpu/serving/client.py``).

A :class:`~glt_tpu_torch.distributed.dist_client.RemoteServerConnection`
underneath (the same framed protocol, reconnect, backoff and failover),
driven with serving knobs: every ``subgraph`` round trip carries a
per-op socket timeout derived from the request's deadline, and
structured server rejections surface as the typed
:mod:`glt_tpu_torch.serving.errors` exceptions (``Overloaded`` with its
``retry_after_ms`` hint, ``DeadlineExceeded``, ``BadRequest``), never as
retry loops hidden inside the client.  Each answer becomes a
:class:`~glt_tpu_torch.loader.transform.Batch` of tensors on the
client's ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import json
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from ..channel.serialization import deserialize
from ..distributed.dist_client import RemoteServerConnection
from ..distributed.dist_server import _KIND_JSON, _KIND_SUB
from ..distributed.sample_message import message_to_batch
from ..obs import metrics as _metrics
from ..obs import propagate as _prop
from ..obs.trace import span as _span
from ..utils.device import DeviceLike, resolve_device
from .errors import DeadlineExceeded, ServingError

_H_CLIENT = _metrics.histogram(
    "glt.serving.client_ms",
    "client-observed subgraph round trip (serialize+wire+serve)")


def retryable_transport(exc: BaseException) -> bool:
    """True for transport-class failures a retry can plausibly fix
    (ECONNRESET, socket timeouts, EOF mid-frame, desynced framing), as
    opposed to structured serving rejections, which surface untouched.

    ``RemoteServerConnection._exchange`` wraps its final transport
    failure in a ``RuntimeError`` chained from the last retryable
    exception, so the cause is inspected too.
    """
    if isinstance(exc, ServingError):
        return False
    if isinstance(exc, RemoteServerConnection.RETRYABLE):
        return True
    if isinstance(exc, RuntimeError):
        return isinstance(exc.__cause__, RemoteServerConnection.RETRYABLE)
    return False


class InferenceClient:
    """Request ego-subgraphs from a serving-enabled ``DistServer``.

    Args:
      addr: server ``(host, port)``.
      timeout: default per-request deadline budget, SECONDS: sent to the
        server as ``deadline_ms`` and used for the per-op socket timeout.
      op_timeout_margin: added to the deadline for the socket timeout
        (serialization, scheduling, and a bucket's first capture).
      max_retries: transport-level retries per exchange (reconnect and
        resend; serving requests are stateless server-side).  Structured
        rejections are never retried here.
      device: where each answer's tensors go (default ``"cuda"``; without
        a card pass ``"cpu"``).
    """

    def __init__(self, addr: Tuple[int, int], timeout: float = 1.0,
                 op_timeout_margin: float = 30.0,
                 max_retries: int = 1,
                 fallback_addrs: Sequence[Tuple[str, int]] = (),
                 backoff_base: float = 0.05, backoff_cap: float = 2.0,
                 fault_plan=None, seed: int = 0,
                 device: DeviceLike = None):
        self.default_timeout = float(timeout)
        self.op_timeout_margin = float(op_timeout_margin)
        self.device = resolve_device(device)
        self._retries = int(max_retries)
        self.conn = RemoteServerConnection(
            addr, max_retries=max_retries,
            backoff_base=backoff_base, backoff_cap=backoff_cap,
            fallback_addrs=tuple(fallback_addrs),
            fault_plan=fault_plan, seed=seed)

    def subgraph_message(self, seeds, timeout: Optional[float] = None):
        """One ego-subgraph request; returns the server's message (host
        numpy arrays), whose first ``batch_size`` node slots are the
        deduplicated seeds.  :meth:`subgraph` turns it into a batch."""
        t = self.default_timeout if timeout is None else float(timeout)
        req = {
            "op": "subgraph_request",
            "seeds": np.asarray(seeds).astype(np.int64).ravel().tolist(),
            "deadline_ms": t * 1e3,
        }
        with _span("serving.client_request",
                   seeds=len(req["seeds"])) as sp, _H_CLIENT.time():
            _prop.inject(req, sp)
            kind, data, t0, t3 = self.conn._exchange(
                json.dumps(req).encode(), retries=self._retries,
                timeout=t + self.op_timeout_margin)
            if kind == _KIND_JSON:
                resp = json.loads(data)
                if "error" in resp:
                    self.conn._raise_structured(resp)
                raise RuntimeError(
                    f"expected a subgraph frame, got JSON {resp!r}")
            if kind != _KIND_SUB:
                raise RuntimeError(f"unexpected frame kind {kind}")
            if _prop.WIRE_KEY in req:
                payload, echo = _prop.split_trailer(data)
                _prop.record_clock_sync(echo, t0, t3)
            else:
                payload = memoryview(data)
            return deserialize(payload)

    def subgraph(self, seeds, timeout: Optional[float] = None):
        """One ego-subgraph request; returns a
        :class:`~glt_tpu_torch.loader.transform.Batch` on the client's
        device whose first ``batch_size`` node slots are the
        (deduplicated) seeds.

        Raises the typed serving errors on structured rejection and the
        transport errors past the retry budget.
        """
        return message_to_batch(self.subgraph_message(seeds, timeout),
                                device=self.device)

    def subgraph_with_retry(self, seeds, timeout: Optional[float] = None,
                            attempts: int = 3,
                            max_backoff_s: float = 0.5,
                            deadline_ms: Optional[float] = None):
        """``subgraph`` plus a bounded, budgeted retry loop.

        Retries a structured ``Overloaded`` after its ``retry_after_ms``
        hint (capped at ``max_backoff_s``) and a retryable transport
        error after the connection's jittered exponential backoff; any
        other serving error propagates at once.  ``deadline_ms`` caps the
        TOTAL budget across attempts and sleeps: past it the loop raises
        :class:`~glt_tpu_torch.serving.errors.DeadlineExceeded` chained
        from the last failure, and each attempt's timeout is clipped to
        what remains.
        """
        start = time.monotonic()
        budget_s = None if deadline_ms is None else float(deadline_ms) / 1e3

        def remaining() -> Optional[float]:
            if budget_s is None:
                return None
            return budget_s - (time.monotonic() - start)

        last: Optional[BaseException] = None
        for attempt in range(max(1, int(attempts))):
            rem = remaining()
            if rem is not None and rem <= 0:
                raise DeadlineExceeded(
                    f"retry budget of {deadline_ms:.0f} ms exhausted "
                    f"after {attempt} attempt(s)") from last
            t = self.default_timeout if timeout is None else float(timeout)
            if rem is not None:
                t = min(t, rem)
            try:
                return self.subgraph(seeds, timeout=t)
            except ServingError as e:
                if e.code != "overloaded":
                    raise
                last = e
                hint = (e.retry_after_ms or 10.0) / 1e3
                sleep_s = min(max_backoff_s, hint)
            except Exception as e:  # noqa: BLE001 — reclassified below
                if not retryable_transport(e):
                    raise
                last = e
                # The connection's own seeded, jittered backoff.
                sleep_s = min(self.conn.backoff_cap,
                              self.conn.backoff_base * (2 ** attempt))
                sleep_s *= 0.5 + 0.5 * self.conn._rng.random()
            rem = remaining()
            if rem is not None:
                sleep_s = min(sleep_s, max(0.0, rem))
            time.sleep(sleep_s)
        raise last

    def stats(self) -> dict:
        """The server's ``serving_stats`` table (queue depth, rejection
        counters, compiled buckets)."""
        return self.conn.request(op="serving_stats")

    def close(self) -> None:
        self.conn.close()
