"""Structured serving errors (cf. ``glt_tpu/serving/errors.py``).

Each error carries a stable wire ``code``.  This slice holds the base
class and :class:`BadRequest`, the engine's only failure; the admission
and fleet errors come with the serving front.
"""
from __future__ import annotations

from typing import Optional


class ServingError(RuntimeError):
    """A serving request failed server-side."""

    code = "serving_failed"

    def __init__(self, message: str,
                 retry_after_ms: Optional[float] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms


class BadRequest(ServingError):
    """The request itself is invalid (empty/oversized seed set, ids out
    of range).  Never retried — the same request will always fail."""

    code = "bad_request"
