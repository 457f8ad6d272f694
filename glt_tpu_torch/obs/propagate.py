"""Cross-process trace propagation over the sampling service's wire
(cf. ``glt_tpu/obs/propagate.py``; the same keys and framing, so a port
peer and a ``glt_tpu`` peer trace each other).

Three optional, backward-compatible wire pieces:

* **Request context**: a traced client adds :data:`WIRE_KEY`
  (``"#trace"``) to a JSON control request: ``{"tid": trace id, "sid":
  parent span id, "ts": client send time}``.  A peer that does not
  trace reads only the keys it knows.
* **Response echo**: a traced server answers with :data:`WIRE_KEY` in
  the JSON response, ``{"pid", "role", "t1": receive time, "t2": send
  time}`` in the server's trace clock.  With the client's send and
  receive times this is one NTP-style sample ``(t0, t1, t2, t3)`` from
  which ``obs merge`` (:mod:`.merge`) estimates each process's clock
  offset.
* **Sample-frame trailer**: a binary sample frame carries the echo in an
  append-only trailer after the payload, ``payload || trailer-json ||
  u32 len || b"GLTT"``, only when the request carried :data:`WIRE_KEY`,
  so a client that does not trace never sees trailer bytes.

Clock-sync events recorded into the current trace (:mod:`.trace`):
``obs.clock_sync`` (a full NTP sample) and ``obs.clock_oneway`` (a
one-way sample from a peer with no response path: the shm ring's
sampling workers).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Optional, Tuple, Union

from .trace import Span, Tracer, current

#: Reserved JSON key carrying the trace context in both directions.
WIRE_KEY = "#trace"

#: Trailer magic closing a traced ``_KIND_MSG`` frame.
TRAILER_MAGIC = b"GLTT"
_TRAILER_FOOTER = struct.Struct("<I4s")  # trailer-json length + magic


def inject(req: Dict[str, Any], span: Span) -> Dict[str, Any]:
    """Attach ``span``'s wire context to a JSON request (in place).

    No-op (and no key) when tracing is off — the request stays
    byte-identical to the pre-trace protocol.
    """
    ctx = span.context()
    if ctx is not None:
        req[WIRE_KEY] = ctx
    return req


def extract(req: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Pop the trace context from an inbound request (None if absent)."""
    ctx = req.pop(WIRE_KEY, None)
    return ctx if isinstance(ctx, dict) else None


def server_echo(tracer: Optional[Tracer], t_recv_us: float,
                role: str = "server") -> Optional[Dict[str, Any]]:
    """The server's half of one NTP sample: receive + send timestamps in
    the server's trace clock (``t2`` stamped here, just before send)."""
    if tracer is None:
        return None
    return {"pid": tracer.pid, "role": role,
            "t1": round(t_recv_us, 3), "t2": round(tracer.now_us(), 3)}


def record_clock_sync(echo: Optional[Dict[str, Any]],
                      t0_us: Optional[float],
                      t3_us: Optional[float]) -> None:
    """Record one full NTP sample against the peer that sent ``echo``.

    ``t0``/``t3`` are this process's send/receive times (trace clock),
    ``echo`` the peer's ``{"pid", "role", "t1", "t2"}``.  Silently does
    nothing unless tracing is on and all four timestamps exist.
    """
    tracer = current()
    if (tracer is None or not isinstance(echo, dict)
            or t0_us is None or t3_us is None
            or "t1" not in echo or "t2" not in echo):
        return
    tracer.instant(
        "obs.clock_sync",
        peer_pid=echo.get("pid"),
        peer_role=echo.get("role"),
        t0_us=round(t0_us, 3),
        t1_us=float(echo["t1"]),
        t2_us=float(echo["t2"]),
        t3_us=round(t3_us, 3),
    )


def record_clock_oneway(peer_pid: Optional[int], peer_role: Optional[str],
                        t_send_peer_us: float) -> None:
    """Record a one-directional sync sample at receive time (shm-channel
    peers — sampling workers — have no response path to complete NTP)."""
    tracer = current()
    if tracer is None or peer_pid is None:
        return
    tracer.instant(
        "obs.clock_oneway",
        peer_pid=int(peer_pid),
        peer_role=peer_role,
        t_send_peer_us=round(float(t_send_peer_us), 3),
        t_recv_us=round(tracer.now_us(), 3),
    )


def pack_trailer(payload: bytes, echo: Optional[Dict[str, Any]]) -> bytes:
    """Append the trace echo to a binary sample payload (append-only:
    the original payload bytes are untouched)."""
    if echo is None:
        return payload
    blob = json.dumps(echo).encode()
    return payload + blob + _TRAILER_FOOTER.pack(len(blob), TRAILER_MAGIC)


def split_trailer(data: Union[bytes, memoryview]
                  ) -> Tuple[memoryview, Optional[Dict[str, Any]]]:
    """Split ``(payload, echo-or-None)`` off a possibly-trailed frame.

    Safe on untrailed frames: without the closing magic (or with an
    implausible length) the whole buffer is the payload.
    """
    mv = memoryview(data)
    n = len(mv)
    if n < _TRAILER_FOOTER.size:
        return mv, None
    blob_len, magic = _TRAILER_FOOTER.unpack_from(
        mv, n - _TRAILER_FOOTER.size)
    if magic != TRAILER_MAGIC or blob_len > n - _TRAILER_FOOTER.size:
        return mv, None
    start = n - _TRAILER_FOOTER.size - blob_len
    try:
        echo = json.loads(bytes(mv[start:n - _TRAILER_FOOTER.size]))
    except (ValueError, UnicodeDecodeError):
        return mv, None
    if not isinstance(echo, dict):
        return mv, None
    return mv[:start], echo
