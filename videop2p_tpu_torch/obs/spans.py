"""Request-scoped tracing: spans as ledger events (port of
``videop2p_tpu/obs/spans.py``, stdlib only).

A span is one ``span`` line in a :class:`~videop2p_tpu_torch.obs.ledger.
RunLedger`: a 128-bit ``trace_id`` shared by every hop of one request, a
64-bit ``span_id``, a ``parent_id`` link, a wall-clock anchor
(``time.time_ns()``, the one clock two processes share) and a measured
``duration_s`` (monotonic, like every other timed region of the package).

Cross-process propagation uses a W3C-trace-context-style ``traceparent``
HTTP header (``00-<32hex trace>-<16hex span>-01``): the client stamps it and
``serve/http.py`` hands it to the engine, which continues the caller's
trace.

Tracing is OFF by default. A disabled :class:`Tracer` is inert: no ids are
minted and no events written.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "SPAN_EVENT_FIELDS",
    "Tracer",
    "format_traceparent",
    "make_span_id",
    "make_trace_id",
    "parse_traceparent",
]

# Schema pin: every `span` ledger event carries AT LEAST these keys
# (extra span attributes ride along as additional top-level fields).
# `wall_ns` anchors the span start to the wall clock — the only clock two
# processes share — while `duration_s` is measured on the monotonic clock.
SPAN_EVENT_FIELDS = (
    "trace_id",    # 32 hex chars — shared by every span of one request
    "span_id",     # 16 hex chars — this span
    "parent_id",   # 16 hex chars or None — the causal parent
    "name",        # dotted taxonomy: serve.request, serve.dispatch, ...
    "wall_ns",     # int epoch nanoseconds at span start (time.time_ns())
    "duration_s",  # float seconds, monotonic-measured
    "status",      # "ok" | terminal request status | "cached"
)

def make_trace_id() -> str:
    """A fresh 128-bit trace id (32 lowercase hex chars)."""
    return uuid.uuid4().hex


def make_span_id() -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return uuid.uuid4().hex[:16]


def format_traceparent(trace_id: str, span_id: str) -> str:
    """The W3C-style propagation header: ``00-<trace>-<span>-01``."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, span_id)`` from a traceparent header, or None.

    Tolerant by design — a malformed header from a foreign client must
    degrade to "start a fresh trace", never to a 500.
    """
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


class Tracer:
    """Span emission bound to one ledger, gated on one ``enabled`` bit.

    Disabled (the default) it is inert: ``emit`` returns immediately and
    the hot path pays one attribute read — no ids minted, no dict built,
    no ledger write. Enabled, every ``emit`` is one ``span`` ledger event;
    :meth:`RunLedger.event` already serializes under the ledger lock, so
    concurrent spans from handler threads never tear.
    """

    def __init__(self, ledger=None, *, enabled: bool = False):
        self.ledger = ledger
        self.enabled = bool(enabled) and ledger is not None

    def emit(self, name: str, *, trace_id: str, span_id: str,
             parent_id: Optional[str] = None,
             wall_ns: Optional[int] = None, duration_s: float = 0.0,
             status: str = "ok", **attrs: Any) -> Optional[Dict[str, Any]]:
        """Record one completed span. Returns the event fields (for tests
        and buffering callers), or None when disabled."""
        if not self.enabled:
            return None
        fields: Dict[str, Any] = {
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "name": name,
            "wall_ns": int(time.time_ns() if wall_ns is None else wall_ns),
            "duration_s": round(float(duration_s), 6),
            "status": status,
        }
        fields.update(attrs)
        self.ledger.event("span", **fields)
        return fields
