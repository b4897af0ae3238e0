"""Deterministic fault injection + the serving resilience primitives (port
of ``videop2p_tpu/serve/faults.py``).

Every failure mode the resilience layer must survive is reproducible on
CPU without a real outage: a :class:`FaultPlan` is a small, deterministic
schedule of injected faults threaded through the engine's dispatch seam
and the store's disk-load seam. No randomness anywhere — the plan keys on
its own 1-based dispatch-attempt counter, so the same plan against the
same request sequence injects the same faults every run.

Plan DSL (comma-separated directives; also accepted as a JSON object):

  * ``fail@K``       — dispatch attempt K raises a *transient* failure
    (the retry path must absorb it);
  * ``hang@K:S``     — dispatch attempt K sleeps S seconds before the
    device call (the watchdog/deadline path must bound it);
  * ``unavail@A-B``  — dispatch attempts A..B (inclusive) raise
    backend-unavailable (an outage in miniature: long enough windows
    must trip the circuit breaker);
  * ``corrupt:PAT``  — persisted store entries whose key contains ``PAT``
    (``*`` = every key) load corrupted (the rehydration path must detect
    and fall back to a fresh inversion, never serve garbage);
  * ``wrong:PAT``    — finished requests whose store key (or request id)
    contains ``PAT`` (``*`` = every request) return a deterministically
    perturbed video tensor while still answering 200 and passing
    ``/healthz`` — the *wrong-but-healthy* replica only a cross-replica
    answer audit can catch. Deterministic by design: the replica stays self-consistent (the determinism probe
    passes) but its content hash diverges from the fleet's.

JSON form: ``{"fail": [2, 3], "hang": {"4": 1.5}, "unavail": [5, 7],
"corrupt": ["*"], "wrong": ["*"]}``.

The env var ``VIDEOP2P_SERVE_FAULTS`` (or ``cli/serve.py --faults``)
activates a plan process-wide. An injected ``hang`` is a host sleep in the
dispatch seam, before any work reaches the card.

This module also hosts the two pure resilience primitives the engine
composes — :class:`RetryPolicy` (capped exponential backoff, jitter-free
by design so schedules are reproducible) and :class:`CircuitBreaker`
(closed → open → half-open with a timed recovery probe) — plus the
machine-readable exception types the HTTP layer maps to status codes, and
:func:`is_transient`, which sorts real failures (CUDA's among them) into
those worth a retry and those that are not.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "TransientDispatchError",
    "BackendUnavailableError",
    "DeadlineExceeded",
    "QueueFull",
    "EngineUnavailable",
    "RetryPolicy",
    "CircuitBreaker",
    "is_transient",
    "FAULTS_ENV",
]

FAULTS_ENV = "VIDEOP2P_SERVE_FAULTS"


# ---- exceptions ----------------------------------------------------------


class InjectedFault(Exception):
    """Base for faults raised by a :class:`FaultPlan` (never by real
    code paths) — error messages always contain ``"injected"`` so doomed
    requests are attributable in chaos runs."""


class TransientDispatchError(InjectedFault):
    """An injected transient dispatch failure — the retry path absorbs it."""


class BackendUnavailableError(InjectedFault):
    """An injected backend-unavailable window — retries inside the window
    keep failing, so consecutive batches fail and the breaker trips."""


class DeadlineExceeded(RuntimeError):
    """A dispatch (or a queued request) exceeded its deadline budget.
    Never retried — the budget is already burned."""


class QueueFull(RuntimeError):
    """Load shed: the bounded admit queue is full (HTTP 429)."""

    def __init__(self, depth: int, limit: int):
        self.depth = int(depth)
        self.limit = int(limit)
        super().__init__(
            f"admit queue full ({depth} in flight >= max_queue {limit})"
        )


class EngineUnavailable(RuntimeError):
    """Fast-fail: the engine cannot take the request now (HTTP 503) —
    breaker open or engine closed. ``retry_after_s`` is the client hint
    (None when there is nothing to wait for, e.g. a closed engine)."""

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        self.retry_after_s = retry_after_s
        super().__init__(message)


# transient markers: messages of failures that may pass (the JAX
# runtime's RESOURCE_EXHAUSTED / UNAVAILABLE classes; CUDA's "out of
# memory", its counterpart of RESOURCE_EXHAUSTED, and "busy or unavailable")
_TRANSIENT_MARKERS = (
    "unavailable", "resource exhausted", "deadline exceeded",
    "connection reset", "socket closed", "failed precondition",
    "out of memory",
)

# CUDA's sticky errors: after one of these the context is unusable and every
# later call in the process fails too, so a retry can only burn its budget
_STICKY_MARKERS = (
    "illegal memory access", "unspecified launch failure", "illegal instruction",
    "misaligned address", "device-side assert", "uncorrectable ecc",
    "launch timed out", "hardware stack error", "invalid program counter",
)


def is_transient(exc: BaseException) -> bool:
    """True when a dispatch failure is worth retrying: injected transient
    faults, injected unavailable windows, ``torch.cuda.OutOfMemoryError``
    (an allocation that may fit once other work frees memory), and errors
    whose message carries a transient marker. A sticky CUDA error (an
    illegal memory access, an unspecified launch failure, ...) is never
    transient, nor is :class:`DeadlineExceeded`."""
    if isinstance(exc, DeadlineExceeded):
        return False
    if isinstance(exc, (TransientDispatchError, BackendUnavailableError)):
        return True
    msg = str(exc).lower()
    if any(m in msg for m in _STICKY_MARKERS):
        return False
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return any(m in msg for m in _TRANSIENT_MARKERS)


# ---- the fault plan ------------------------------------------------------


class FaultPlan:
    """A deterministic schedule of injected faults.

    The plan owns its 1-based dispatch-attempt counter (each retry is its
    own attempt), so a fresh plan replays identically regardless of any
    prior engine history. Thread-safe; ``injected`` records what actually
    fired, in order.
    """

    def __init__(
        self,
        *,
        fail: Sequence[int] = (),
        hang: Optional[Dict[int, float]] = None,
        unavail: Optional[Tuple[int, int]] = None,
        corrupt: Sequence[str] = (),
        wrong: Sequence[str] = (),
        spec: str = "",
    ):
        self.fail = frozenset(int(k) for k in fail)
        self.hang = {int(k): float(s) for k, s in (hang or {}).items()}
        self.unavail = (None if unavail is None
                        else (int(unavail[0]), int(unavail[1])))
        self.corrupt = tuple(str(p) for p in corrupt)
        self.wrong = tuple(str(p) for p in wrong)
        self.spec = spec
        self.injected: List[Dict[str, Any]] = []
        # observer hook (the engine sets it to its fault-event recorder so
        # every injection becomes a `fault` ledger event as it fires)
        self.on_inject = None
        self._attempt = 0
        self._lock = threading.Lock()

    # ---- construction ----------------------------------------------------

    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        """Parse the DSL (or a JSON object string); None/empty → None."""
        if not spec or not str(spec).strip():
            return None
        spec = str(spec).strip()
        if spec.startswith("{"):
            d = json.loads(spec)
            hang = {int(k): float(v) for k, v in (d.get("hang") or {}).items()}
            unavail = d.get("unavail")
            return cls(
                fail=[int(k) for k in d.get("fail") or ()],
                hang=hang,
                unavail=tuple(unavail) if unavail else None,
                corrupt=list(d.get("corrupt") or ()),
                wrong=list(d.get("wrong") or ()),
                spec=spec,
            )
        fail: List[int] = []
        hang = {}
        unavail = None
        corrupt: List[str] = []
        wrong: List[str] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                if part.startswith("fail@"):
                    fail.append(int(part[5:]))
                elif part.startswith("hang@"):
                    at, _, secs = part[5:].partition(":")
                    hang[int(at)] = float(secs or "1.0")
                elif part.startswith("unavail@"):
                    a, _, b = part[8:].partition("-")
                    unavail = (int(a), int(b or a))
                elif part.startswith("corrupt:"):
                    corrupt.append(part[8:] or "*")
                elif part.startswith("wrong:"):
                    wrong.append(part[6:] or "*")
                else:
                    raise ValueError(part)
            except (ValueError, TypeError):
                raise ValueError(
                    f"bad fault directive {part!r} — expected fail@K, "
                    "hang@K:S, unavail@A-B, corrupt:PAT or wrong:PAT"
                ) from None
        return cls(fail=fail, hang=hang, unavail=unavail, corrupt=corrupt,
                   wrong=wrong, spec=spec)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        return cls.parse(os.environ.get(FAULTS_ENV))

    # ---- injection seams -------------------------------------------------

    def on_dispatch(self) -> int:
        """The engine's dispatch seam: called once per dispatch ATTEMPT
        (inside the watchdog-guarded region, so an injected hang is bounded
        exactly like a real wedge). May sleep, may raise; returns the
        attempt index it consumed."""
        with self._lock:
            self._attempt += 1
            k = self._attempt
        hang_s = self.hang.get(k)
        if hang_s:
            self._record("hang", attempt=k, seconds=hang_s)
            time.sleep(hang_s)
        if self.unavail is not None and self.unavail[0] <= k <= self.unavail[1]:
            self._record("backend_unavailable", attempt=k)
            raise BackendUnavailableError(
                f"injected backend-unavailable window (attempt {k})"
            )
        if k in self.fail:
            self._record("dispatch_fail", attempt=k)
            raise TransientDispatchError(
                f"injected transient dispatch failure (attempt {k})"
            )
        return k

    def corrupts(self, key: str) -> bool:
        """The store's disk-load seam: does this persisted entry load
        corrupted?"""
        hit = any(p == "*" or p in key for p in self.corrupt)
        if hit:
            self._record("store_corrupt", key=key)
        return hit

    def wrongs(self, key: str) -> bool:
        """The engine's answer seam: does this finished request return a
        silently wrong (deterministically perturbed) video tensor? Unlike
        :meth:`corrupts`, nothing downstream detects this — the replica
        answers 200 with a stable-but-divergent content hash, which is
        exactly what the cross-replica answer audit exists to catch."""
        hit = any(p == "*" or p in key for p in self.wrong)
        if hit:
            self._record("wrong_output", key=key)
        return hit

    def _record(self, kind: str, **fields: Any) -> None:
        with self._lock:
            self.injected.append({"kind": kind, **fields})
        cb = self.on_inject
        if cb is not None:
            try:
                cb(kind, **fields)
            except Exception:  # noqa: BLE001 — observation never blocks injection
                pass

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._attempt

    def __repr__(self) -> str:
        return f"FaultPlan({self.spec or 'programmatic'!r})"


# ---- retry policy --------------------------------------------------------


class RetryPolicy:
    """Capped exponential backoff with NO jitter: retry schedules must be
    reproducible (the chaos tests pin attempt counts), and the single
    engine worker means there is no thundering herd to de-synchronize."""

    def __init__(self, max_retries: int = 2, base_s: float = 0.05,
                 cap_s: float = 2.0):
        self.max_retries = max(int(max_retries), 0)
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based): base·2^attempt,
        capped."""
        return min(self.base_s * (2.0 ** attempt), self.cap_s)


# ---- circuit breaker -----------------------------------------------------


class CircuitBreaker:
    """closed → open → half-open with a timed recovery probe.

    ``record_failure`` after every exhausted-retries/deadline batch
    failure; ``threshold`` consecutive failures trip the breaker OPEN.
    While open, :meth:`allow` is False (submits fast-fail 503 with
    ``retry_after_s``). After ``open_s`` the breaker moves to HALF-OPEN:
    submits are admitted again and the next dispatch is the probe —
    success closes the breaker (recovery is automatic), failure re-opens
    it for another ``open_s``. Transitions are reported through the
    optional ``on_transition`` callback (the engine ledgers them as
    ``breaker`` events)."""

    def __init__(self, threshold: int = 3, open_s: float = 5.0,
                 on_transition=None):
        self.threshold = max(int(threshold), 1)
        self.open_s = float(open_s)
        self.on_transition = on_transition
        self.consecutive_failures = 0
        self.trips = 0
        self._state = "closed"
        self._opened_at = 0.0
        self._lock = threading.Lock()

    def _transition(self, new_state: str):
        """Caller holds the lock. Returns the ``on_transition`` thunk to
        run AFTER the lock is released — a callback that re-enters
        breaker state (the incident plane's ``/metrics`` target probe
        snapshots it mid-capture) must not deadlock on this lock."""
        old, self._state = self._state, new_state
        if old == new_state or self.on_transition is None:
            return None
        failures, trips = self.consecutive_failures, self.trips

        def fire():
            try:
                self.on_transition(old, new_state,
                                   consecutive_failures=failures,
                                   trips=trips)
            except Exception:  # noqa: BLE001 — observability never breaks the breaker
                pass

        return fire

    @property
    def state(self) -> str:
        """Current state; an elapsed open window lazily becomes
        half-open (the probe admission)."""
        fire = None
        with self._lock:
            if (self._state == "open"
                    and time.perf_counter() - self._opened_at >= self.open_s):
                fire = self._transition("half_open")
            state = self._state
        if fire is not None:
            fire()
        return state

    def allow(self) -> bool:
        """May a new request be admitted right now?"""
        return self.state != "open"

    def retry_after_s(self) -> float:
        """Remaining open time (the 503 Retry-After hint); 0 when not open."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(self.open_s - (time.perf_counter() - self._opened_at),
                       0.0)

    def record_failure(self) -> None:
        self.state  # noqa: B018 — resolve a lapsed open window into half-open first
        fire = None
        with self._lock:
            self.consecutive_failures += 1
            if self._state == "half_open" or (
                self._state == "closed"
                and self.consecutive_failures >= self.threshold
            ):
                self.trips += 1
                self._opened_at = time.perf_counter()
                fire = self._transition("open")
        if fire is not None:
            fire()

    def record_success(self) -> None:
        fire = None
        with self._lock:
            self.consecutive_failures = 0
            if self._state != "closed":
                fire = self._transition("closed")
        if fire is not None:
            fire()

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` and ``/healthz`` breaker section."""
        state = self.state  # resolves a lapsed open window first
        return {
            "state": state,
            "consecutive_failures": self.consecutive_failures,
            "threshold": self.threshold,
            "trips": self.trips,
            "open_s": self.open_s,
            "retry_after_s": round(self.retry_after_s(), 3),
        }
