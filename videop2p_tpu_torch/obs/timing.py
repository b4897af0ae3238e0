"""Per-dispatch execute-latency distributions (port of
``videop2p_tpu/obs/timing.py``, stdlib only).

Per program label, the *distribution* of its execute latencies:

  * ``dispatch`` — how long the call took to RETURN (with CUDA's
    asynchronous launches this is the host-side cost of queueing the work);
  * ``blocked`` — how long until ``torch.cuda.synchronize`` after it (the
    real latency of the dispatch on the card).

A program whose dispatch p50 is a fraction of its blocked p50 overlaps the
host with the card; the two converging means the host serializes on it.

Samples accumulate in bounded per-program reservoirs
(:class:`LatencyReservoir` — Algorithm-R reservoir sampling with a
deterministic per-reservoir RNG, so identical runs summarize identically;
count and max are tracked exactly outside the sample so a tail spike can
never be sampled away). Summaries land in the run ledger as one
``execute_timing`` event per program (``EXECUTE_TIMING_FIELDS``).

Timing is OFF by default (``VIDEOP2P_OBS_LATENCY=1`` or a ledger built with
``latency=True`` turns it on): the off path never synchronizes, so the
card's queue keeps its overlap with the host.
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "EXECUTE_TIMING_FIELDS",
    "RESERVOIR_CAPACITY",
    "LatencyReservoir",
    "latency_enabled",
    "measure_overhead_p50",
    "percentile",
]

_LATENCY_ENV = "VIDEOP2P_OBS_LATENCY"

# default bound on stored samples per program: 512 pairs of floats is
# ~8 KiB — per-program cost stays trivial over arbitrarily long runs
RESERVOIR_CAPACITY = 512

# schema-stable field set of the execute_timing ledger event (the JAX
# package's names)
EXECUTE_TIMING_FIELDS = (
    "count",
    "sampled",
    "dispatch_p50_s",
    "dispatch_p95_s",
    "dispatch_p99_s",
    "dispatch_max_s",
    "blocked_p50_s",
    "blocked_p95_s",
    "blocked_p99_s",
    "blocked_max_s",
    "dispatch_fraction",
    # exemplars: the trace ids behind the exact max and the nearest-rank
    # p99 sample, so a latency outlier names its trace. Always present;
    # None when tracing was off (the common case).
    "max_trace_id",
    "p99_trace_id",
)


def latency_enabled() -> bool:
    """Process-wide opt-in for per-dispatch execute timing."""
    return os.environ.get(_LATENCY_ENV, "0") == "1"


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of a sequence (q in [0, 100]).

    Nearest-rank (not interpolated) so every reported value is an
    actually-observed latency — a p99 that no dispatch ever exhibited
    would be noise dressed as evidence. Empty input returns 0.0.
    """
    if not samples:
        return 0.0
    ordered = sorted(samples)
    rank = math.ceil(q * len(ordered) / 100.0)  # 1-based nearest rank
    return ordered[min(max(rank, 1), len(ordered)) - 1]


class LatencyReservoir:
    """Bounded reservoir of ``(dispatch_s, blocked_s)`` pairs.

    Algorithm R: the first ``capacity`` samples are kept verbatim; each
    later sample replaces a uniformly random slot with probability
    ``capacity / n``. The RNG is seeded per reservoir, so two identical
    runs keep identical samples and summarize identically. ``count`` and the component maxima
    are exact regardless of sampling.

    Thread-safe: dispatches land from the engine's worker and watchdog
    threads.
    """

    def __init__(self, capacity: int = RESERVOIR_CAPACITY, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.count = 0
        self.dispatch_max = 0.0
        self.blocked_max = 0.0
        self.max_trace_id: Optional[str] = None
        self._samples: List[Tuple[float, float, Optional[str]]] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def add(self, dispatch_s: float, blocked_s: float,
            trace_id: Optional[str] = None) -> None:
        d, b = float(dispatch_s), float(blocked_s)
        with self._lock:
            self.count += 1
            self.dispatch_max = max(self.dispatch_max, d)
            if b >= self.blocked_max:
                # exact exemplar: the max is tracked outside the sample,
                # so its trace link must be too (a sampled-away spike
                # still names its trace)
                self.blocked_max = b
                if trace_id is not None:
                    self.max_trace_id = trace_id
            if len(self._samples) < self.capacity:
                self._samples.append((d, b, trace_id))
            else:
                j = self._rng.randrange(self.count)
                if j < self.capacity:
                    self._samples[j] = (d, b, trace_id)

    def samples(self) -> List[Tuple[float, float, Optional[str]]]:
        with self._lock:
            return list(self._samples)

    def summary(self) -> Optional[Dict[str, float]]:
        """The ``execute_timing`` event payload (``EXECUTE_TIMING_FIELDS``),
        or None when nothing was recorded."""
        with self._lock:
            if not self._samples:
                return None
            dispatch = [d for d, _, _ in self._samples]
            blocked = [b for _, b, _ in self._samples]
            count, sampled = self.count, len(self._samples)
            d_max, b_max = self.dispatch_max, self.blocked_max
            max_trace = self.max_trace_id
            # the p99 exemplar: the trace behind the nearest-rank p99
            # blocked sample (an actually-observed latency, like the
            # percentile itself)
            by_blocked = sorted(self._samples, key=lambda s: s[1])
            rank = math.ceil(99 * len(by_blocked) / 100.0)
            p99_trace = by_blocked[min(max(rank, 1), len(by_blocked)) - 1][2]
        b_p50 = percentile(blocked, 50)
        d_p50 = percentile(dispatch, 50)
        return {
            "count": count,
            "sampled": sampled,
            "dispatch_p50_s": round(d_p50, 6),
            "dispatch_p95_s": round(percentile(dispatch, 95), 6),
            "dispatch_p99_s": round(percentile(dispatch, 99), 6),
            "dispatch_max_s": round(d_max, 6),
            "blocked_p50_s": round(b_p50, 6),
            "blocked_p95_s": round(percentile(blocked, 95), 6),
            "blocked_p99_s": round(percentile(blocked, 99), 6),
            "blocked_max_s": round(b_max, 6),
            # the async-overlap signal: ~0 = the call returned immediately
            # and execution proceeded in the background; ~1 = the host
            # blocked for the full execution inside the dispatch itself
            "dispatch_fraction": round(d_p50 / b_p50, 4) if b_p50 > 0 else 1.0,
            "max_trace_id": max_trace,
            "p99_trace_id": p99_trace,
        }


def measure_overhead_p50(run_off, run_on, *, repeats: int = 9) -> Dict[str, float]:
    """Overhead of ``run_on`` over ``run_off`` (each must wait for its own
    result) on the p50s of interleaved reservoirs: both warm up once, then
    the repeats alternate off / on so that a drifting machine biases both
    sides alike. Returns ``obs/telemetry.py:telemetry_overhead_record``'s
    schema."""
    from videop2p_tpu_torch.obs.telemetry import telemetry_overhead_record

    run_off()
    run_on()
    off, on = LatencyReservoir(), LatencyReservoir()
    for _ in range(max(int(repeats), 1)):
        t0 = time.perf_counter()
        run_off()
        dt = time.perf_counter() - t0
        off.add(dt, dt)
        t0 = time.perf_counter()
        run_on()
        dt = time.perf_counter() - t0
        on.add(dt, dt)
    return telemetry_overhead_record(off.summary()["blocked_p50_s"],
                                     on.summary()["blocked_p50_s"])
