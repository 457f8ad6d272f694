"""Structured serving errors (cf. ``glt_tpu/serving/errors.py``; the
same classes and wire codes).

Every failure the serving path can inflict on a client carries a stable
wire ``code``, so the structured-error protocol (``{"error": ...,
"code": ...}`` responses, :mod:`glt_tpu_torch.distributed.dist_server`)
round-trips it: a client tells "back off and retry" (:class:`Overloaded`,
with a ``retry_after_ms`` hint) from "too late" (:class:`DeadlineExceeded`)
from "the engine broke" (:class:`ServingError`) without parsing text.
``distributed.dist_client`` maps error responses back through
:func:`error_from_response`.  Standard library only.
"""
from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """A serving request failed server-side (engine fault, shutdown).

    The generic member of the family; subclasses refine the wire code.
    ``retry_after_ms`` is an optional backoff hint (only
    :class:`Overloaded` populates it today).
    """

    code = "serving_failed"

    def __init__(self, message: str,
                 retry_after_ms: Optional[float] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class Overloaded(ServingError):
    """Admission control rejected the request: the bounded inflight
    queue is full.  Back off for ~``retry_after_ms`` and retry — the
    rejection is the server protecting its SLO for accepted requests,
    not a failure of this one."""

    code = "overloaded"


class DeadlineExceeded(ServingError):
    """The request missed its deadline before (or while) being served;
    the coalescer dropped it rather than spend a device slot on an
    answer nobody is waiting for."""

    code = "deadline_exceeded"


class BadRequest(ServingError):
    """The request itself is invalid (empty/oversized seed set, ids out
    of range).  Never retried — the same request will always fail."""

    code = "bad_request"


class ServingDisabled(ServingError):
    """The server was started without ``serving=ServingOptions(...)``."""

    code = "serving_disabled"


class ServingDown(ServingError):
    """The serving front is stopped or its dispatcher died."""

    code = "serving_down"


class ServingTimeout(ServingError):
    """The connection handler gave up waiting for the coalescer —
    server-side wait budget exhausted (distinct from the client's own
    socket timeout)."""

    code = "serving_timeout"


class NoHealthyReplica(ServingError):
    """The fleet router exhausted its bounded failover budget: the
    request's shard owner and its successor(s) were all dead or
    unreachable.  Structured by design — a whole-fleet outage surfaces
    as this error after a bounded number of jittered retries, never as
    a hang or a raw socket traceback (the ``bounded_get`` discipline
    applied to the client path)."""

    code = "no_healthy_replica"


_BY_CODE = {cls.code: cls for cls in (
    ServingError, Overloaded, DeadlineExceeded, BadRequest,
    ServingDisabled, ServingDown, ServingTimeout, NoHealthyReplica)}

#: Wire codes this module owns; ``RemoteServerConnection`` routes error
#: responses with these codes through :func:`error_from_response`.
SERVING_CODES = frozenset(_BY_CODE)


def error_from_response(resp: dict) -> ServingError:
    """Rebuild the typed error from a structured error response."""
    cls = _BY_CODE.get(str(resp.get("code")), ServingError)
    return cls(str(resp.get("error", "serving request failed")),
               retry_after_ms=resp.get("retry_after_ms"))
