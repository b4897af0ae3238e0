"""Per-phase wall-clock timing (port of ``phase_timer``, ``phase_records``
and ``reset`` of ``videop2p_tpu/utils/profiling.py``): each phase also goes
to the active run ledger (``obs/ledger.py``) as a ``phase`` event, where
there is one. ``time.perf_counter`` is monotonic. On the
card a phase's time includes only the work the host waited for: a caller
that wants device work inside it synchronises before it closes."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Tuple

__all__ = ["phase_timer", "phase_records", "reset"]

_RECORDS: List[Tuple[str, float]] = []
_RECORDS_LOCK = threading.Lock()


def phase_records() -> Dict[str, float]:
    """Total seconds per phase name since the last :func:`reset`."""
    out: Dict[str, float] = {}
    with _RECORDS_LOCK:
        records = list(_RECORDS)
    for name, dt in records:
        out[name] = out.get(name, 0.0) + dt
    return out


def reset() -> None:
    """Drop the accumulated records."""
    with _RECORDS_LOCK:
        _RECORDS.clear()


@contextlib.contextmanager
def phase_timer(name: str) -> Iterator[None]:
    """Time a region, record it and print it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _RECORDS_LOCK:
            _RECORDS.append((name, dt))
        print(f"[phase] {name}: {dt:.2f}s")
        from videop2p_tpu_torch.obs.ledger import current_ledger

        led = current_ledger()
        if led is not None:
            led.phase(name, dt)
