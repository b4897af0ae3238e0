"""Per-phase wall-clock timing and device traces (port of
``videop2p_tpu/utils/profiling.py``): each phase also goes to the active run
ledger (``obs/ledger.py``) as a ``phase`` event, where there is one.
``time.perf_counter`` is monotonic. On the card a phase's time includes only
the work the host waited for: a caller that wants device work inside it
synchronises before it closes. :func:`trace` adds a ``torch.profiler``
capture of the phase when ``VIDEOP2P_TRACE_DIR`` is set."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["phase_timer", "phase_records", "last_phase_seconds", "reset", "trace"]

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


def last_phase_seconds(name: str) -> Optional[float]:
    """The most recent duration of phase ``name`` (None if it never ran)."""
    with _RECORDS_LOCK:
        records = list(_RECORDS)
    for rec_name, dt in reversed(records):
        if rec_name == name:
            return dt
    return None


def reset() -> None:
    """Drop the accumulated records."""
    with _RECORDS_LOCK:
        _RECORDS.clear()


@contextlib.contextmanager
def phase_timer(name: str, *, verbose: bool = True, count: Optional[int] = None,
                unit: str = "it") -> Iterator[None]:
    """Time a region, record it, write it to the active ledger and print
    it; ``count`` adds the ms per ``unit`` to the printed line and the
    ``phase`` event (an upper bound when the region stops early)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _RECORDS_LOCK:
            _RECORDS.append((name, dt))
        from videop2p_tpu_torch.obs.ledger import current_ledger

        led = current_ledger()
        if led is not None:
            led.phase(name, dt, **({"count": count, "unit": unit} if count else {}))
        if verbose:
            per = f" ({dt / count * 1e3:.1f} ms/{unit})" if count else ""
            print(f"[phase] {name}: {dt:.2f}s{per}")


@contextlib.contextmanager
def trace(name: str, *, device=None) -> Iterator[None]:
    """A :func:`phase_timer` region, captured with ``torch.profiler`` into
    ``$VIDEOP2P_TRACE_DIR/<name>/trace_<name>.json`` when that variable is
    set (CUDA and host activity when ``device`` is a CUDA device, the
    host's alone otherwise; the card is synchronized before the capture
    stops); a plain phase otherwise. With an active run ledger a ``trace``
    event (name and directory) follows, which ``obs/report.py`` mines into
    a ``trace_analysis``."""
    trace_dir = os.environ.get("VIDEOP2P_TRACE_DIR")
    if not trace_dir:
        with phase_timer(name):
            yield
        return
    import torch

    from videop2p_tpu_torch.obs.trace import capture

    target = os.path.join(trace_dir, name)
    os.makedirs(target, exist_ok=True)
    with capture(device) as prof:
        with phase_timer(name):
            yield
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(target, f"trace_{name}.json"))
    from videop2p_tpu_torch.obs.ledger import current_ledger

    led = current_ledger()
    if led is not None:
        led.event("trace", name=name, trace_dir=target)
