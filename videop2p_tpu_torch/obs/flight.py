"""Always-on flight recorder: a bounded ring of the most recent ledger
events (obs Layer 7; port of ``videop2p_tpu/obs/flight.py``).

The ledger already sees everything worth capturing — spans, faults,
breaker transitions, fleet signals, stream windows — but it streams to
disk and rotates away; when an incident fires, the interesting part is
the *last few thousand events*, in memory, right now. The
:class:`FlightRecorder` is that black box: :class:`~videop2p_tpu_torch.obs.
ledger.RunLedger` tees every event record into it with ONE guarded deque
append (``ledger.flight = recorder``; recorder-off stays a single
``None`` attribute check, so the off path is bit-exact), and
:class:`~videop2p_tpu_torch.obs.incident.IncidentManager` dumps the ring into
each incident bundle as replayable JSONL.

Overhead is *recorded, not asserted* (the latency-reservoir
convention): :meth:`FlightRecorder.overhead_probe` measures the
per-record cost on this box and the incident manifest carries it, so a
post-mortem can state what the black box cost instead of a test
guessing a threshold.

Stdlib only.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List

__all__ = ["FLIGHT_DEFAULT_CAPACITY", "FlightRecorder"]

FLIGHT_DEFAULT_CAPACITY = 2048


class FlightRecorder:
    """Bounded, thread-safe, most-recent-wins ring of ledger event dicts.

    ``record`` is the hot path (called inline from ``RunLedger.event``):
    one lock acquire + one ``deque`` append — the ``maxlen`` deque does
    the eviction, so memory is flat no matter how long the run. It must
    never raise into the ledger; any failure is swallowed.
    """

    def __init__(self, capacity: int = FLIGHT_DEFAULT_CAPACITY):
        self.capacity = max(int(capacity), 1)
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seen = 0

    def record(self, rec: Dict[str, Any]) -> None:
        """Tee one event record into the ring (never raises)."""
        try:
            with self._lock:
                self._ring.append(rec)
                self._seen += 1
        except Exception:  # noqa: BLE001 — the black box must not crash the plane
            pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring's current contents, oldest first (shallow copies —
        ledger records are write-once, but the caller may annotate)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def stats(self) -> Dict[str, Any]:
        """Ring accounting for the incident manifest: how much history
        the bundle holds and how much scrolled off the end."""
        with self._lock:
            buffered = len(self._ring)
            seen = self._seen
        return {
            "capacity": self.capacity,
            "buffered": buffered,
            "seen": seen,
            "dropped": max(seen - buffered, 0),
        }

    def overhead_probe(self, n: int = 256) -> float:
        """Measured per-record cost in nanoseconds on THIS box (recorded
        into the incident manifest, never asserted). Probes a scratch
        ring so the real history is untouched."""
        scratch = FlightRecorder(capacity=min(self.capacity, 256))
        rec = {"event": "flight_probe", "t": 0.0}
        t0 = time.perf_counter()
        for _ in range(max(int(n), 1)):
            scratch.record(rec)
        dt = time.perf_counter() - t0
        return round(dt * 1e9 / max(int(n), 1), 1)

    def dump_jsonl(self, path: str) -> int:
        """Write the ring as replayable JSONL (same shape the ledger
        writes, so ``read_ledger``/``obs_diff``/``trace_view`` all parse
        it). Returns the number of events written."""
        events = self.snapshot()
        with open(path, "w") as f:
            for e in events:
                try:
                    f.write(json.dumps(e, default=str) + "\n")
                except (TypeError, ValueError):
                    f.write(json.dumps(
                        {"event": "encode_error",
                         "kind": str(e.get("event"))}) + "\n")
        return len(events)
