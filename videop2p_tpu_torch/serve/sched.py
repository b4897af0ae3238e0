"""Pluggable request schedulers for the edit-serving engine (port of
``videop2p_tpu/serve/sched.py``, stdlib plus the batch planner).

Iteration-level (continuous) batching admits work into the NEXT dispatch
instead of the next plan boundary, and multi-tenant QoS needs per-tenant
lanes with fair queuing. The scheduling decisions sit behind one small
interface the engine drives:

  * :class:`DrainScheduler` (``"drain"``) — the compatibility baseline:
    one admit window, ``plan_batches`` grouping, plans dispatched in
    order. Two opt-in knobs relax its worst latency pathology without
    changing the default: ``order="oldest"`` dispatches planned chunks by
    the arrival of their OLDEST member (an early rare-key request no
    longer delays the dominant key's batch), and ``max_batch_wait_s``
    caps the admit window by the first request's total time-in-queue so
    latency-sensitive tenants are not held hostage to batch fill.
  * :class:`ContinuousScheduler` (``"continuous"``) — Orca/vLLM-style
    iteration-level admission: the engine re-collects between dispatches,
    so a compatible request arriving while a batch is on the devices
    joins the NEXT dispatch (observed ``batch_size`` grows) instead of
    waiting for the whole plan to drain. Pending work is ordered
    deadline-first (tightest ``deadline_at``, then arrival), and batch
    formation never stalls an idle queue: a partial batch dispatches
    immediately once nothing else is queued, bounded above by the
    optional ``max_batch_wait_s`` fill-wait.
  * :class:`FairScheduler` (``"fair"``) — per-tenant QoS: one lane per
    tenant, served by deficit-round-robin (DRR) fair queuing. Every
    scheduling round grants each backlogged lane ``quantum × weight``
    credit; lanes are scanned in (priority, name) order and the first
    lane with ≥ 1 credit dispatches up to ``min(max_batch, credit)``
    compatible requests. Because every backlogged lane accrues credit
    each round, a low-weight tenant keeps NONZERO throughput under
    saturation. Per-tenant
    deadline budgets ride :class:`TenantConfig`; shed accounting lives in
    the engine's per-tenant counters (``serve_health``/``/metrics``).

The scheduler owns batch formation only. The engine keeps everything that
touches devices or request records: queue pulls happen through
``engine._collect_window`` (the scheduler parameterizes the window), and
resolve/dispatch stay on the engine's single worker thread.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from videop2p_tpu_torch.serve.batching import Batch, plan_batches

__all__ = [
    "SCHEDULER_POLICIES",
    "TenantConfig",
    "parse_tenants",
    "Scheduler",
    "DrainScheduler",
    "ContinuousScheduler",
    "FairScheduler",
    "make_scheduler",
]

SCHEDULER_POLICIES = ("drain", "continuous", "fair")


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant QoS: DRR ``weight`` (share of throughput under the fair
    policy), ``priority`` (lower scans first within a DRR round), and an
    optional per-tenant default ``deadline_s`` budget applied to requests
    that do not carry their own."""

    weight: int = 1
    priority: int = 0
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if int(self.weight) < 1:
            raise ValueError(f"tenant weight must be >= 1, got {self.weight}")


def parse_tenants(spec: Optional[str]) -> Dict[str, TenantConfig]:
    """Parse the CLI/loadgen tenant syntax into ``{name: TenantConfig}``.

    ``"A:5,B:1"`` — name:weight pairs; ``"A:5:0,B:1:1"`` adds a priority
    lane per tenant (``name:weight:priority``). A JSON object form carries
    the full config: ``{"A": {"weight": 5, "deadline_s": 2.0}}``.
    None/empty → ``{}`` (every tenant gets the default config).
    """
    if not spec or not str(spec).strip():
        return {}
    spec = str(spec).strip()
    if spec.startswith("{"):
        out = {}
        for name, cfg in json.loads(spec).items():
            cfg = dict(cfg or {})
            unknown = set(cfg) - {"weight", "priority", "deadline_s"}
            if unknown:
                raise ValueError(
                    f"unknown tenant config key(s) for {name!r}: {sorted(unknown)}"
                )
            out[str(name)] = TenantConfig(
                weight=int(cfg.get("weight", 1)),
                priority=int(cfg.get("priority", 0)),
                deadline_s=(float(cfg["deadline_s"])
                            if cfg.get("deadline_s") is not None else None),
            )
        return out
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        if not bits[0] or len(bits) > 3:
            raise ValueError(
                f"bad tenant spec {part!r} — expected name:weight[:priority]"
            )
        try:
            out[bits[0]] = TenantConfig(
                weight=int(bits[1]) if len(bits) > 1 and bits[1] else 1,
                priority=int(bits[2]) if len(bits) > 2 and bits[2] else 0,
            )
        except ValueError as e:
            raise ValueError(f"bad tenant spec {part!r}: {e}") from None
    return out


class Scheduler:
    """Batch-formation policy for the engine worker loop.

    The engine drives three hooks per scheduling round:

      1. ``collect(engine)`` — pull raw ``(rid, request)`` tuples for this
         round (the scheduler picks the admit-window shape by calling
         ``engine._collect_window`` with its own parameters). ``None``
         means shutdown.
      2. ``add(prepared)`` — resolved items enter the scheduler's pool.
      3. ``next_plan(now, queue_empty)`` — one :class:`Batch` to dispatch,
         or ``None`` when the policy wants to wait/collect instead.

    ``preemptive`` schedulers get a fresh ``collect`` after EVERY dispatch
    (iteration-level admission); non-preemptive ones drain every planned
    batch first (the classic plan boundary).
    """

    name = "base"
    preemptive = False

    def __init__(self, *, max_batch: int = 4, max_wait_s: float = 0.05,
                 max_batch_wait_s: Optional[float] = None,
                 order: str = "first_seen",
                 tenants: Optional[Dict[str, TenantConfig]] = None):
        self.max_batch = max(int(max_batch), 1)
        self.max_wait_s = float(max_wait_s)
        self.max_batch_wait_s = (None if max_batch_wait_s is None
                                 else float(max_batch_wait_s))
        self.order = order
        self.tenants = dict(tenants or {})

    def tenant_config(self, tenant: str) -> TenantConfig:
        return self.tenants.get(tenant) or TenantConfig()

    # ---- hooks the engine drives ----------------------------------------

    def collect(self, engine):
        raise NotImplementedError

    def add(self, prepared: Sequence[Any]) -> None:
        raise NotImplementedError

    def next_plan(self, now: Optional[float] = None,
                  queue_empty: bool = True) -> Optional[Batch]:
        raise NotImplementedError

    def pending(self) -> int:
        """Resolved-but-undispatched items held by the policy."""
        return 0

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe policy state for ``/metrics``."""
        return {"policy": self.name, "pending": self.pending()}


class DrainScheduler(Scheduler):
    """The baseline policy: one admit window → resolve →
    ``plan_batches`` over the whole window → dispatch every plan before
    collecting again. ``order``/``max_batch_wait_s``
    are the opt-in latency knobs (module docstring)."""

    name = "drain"
    preemptive = False

    def __init__(self, **kw):
        super().__init__(**kw)
        if self.order not in ("first_seen", "oldest"):
            raise ValueError(
                f"drain order must be 'first_seen' or 'oldest', got {self.order!r}"
            )
        self._pending: List[Any] = []
        self._plans: List[Batch] = []

    def collect(self, engine):
        if self._plans:  # unreachable in the engine loop; defensive
            return []
        return engine._collect_window(
            self.max_batch, self.max_wait_s,
            oldest_budget_s=self.max_batch_wait_s,
        )

    def add(self, prepared: Sequence[Any]) -> None:
        self._pending.extend(prepared)

    def next_plan(self, now: Optional[float] = None,
                  queue_empty: bool = True) -> Optional[Batch]:
        if self._pending:
            self._plans = plan_batches(
                self._pending, max_batch=self.max_batch,
                order=self.order, arrival_fn=lambda p: p.seq,
            )
            self._pending = []
        return self._plans.pop(0) if self._plans else None

    def pending(self) -> int:
        return len(self._pending) + sum(len(b.items) for b in self._plans)


class ContinuousScheduler(Scheduler):
    """Iteration-level admission (module docstring): re-collect between
    dispatches, deadline-first ordering, partial batches dispatch as soon
    as the queue is idle (bounded by ``max_batch_wait_s`` when set)."""

    name = "continuous"
    preemptive = True

    def __init__(self, **kw):
        super().__init__(**kw)
        self.hold_s = self.max_batch_wait_s or 0.0
        self._pending: List[Any] = []

    def collect(self, engine):
        if not self._pending:
            # idle: block briefly for the first arrival, then grab every
            # request already queued (greedy, no fill wait) — they all
            # enter the pool and the most urgent forms the next batch
            return engine._collect_window(self.max_batch, 0.0, greedy=True)
        timeout = 0.0
        if self.hold_s:
            oldest = min(p.arrival_s for p in self._pending)
            timeout = min(max(oldest + self.hold_s - time.perf_counter(), 0.0),
                          0.05)
        return engine._collect_window(self.max_batch, 0.0,
                                      first_timeout_s=timeout, greedy=True)

    def add(self, prepared: Sequence[Any]) -> None:
        self._pending.extend(prepared)

    def next_plan(self, now: Optional[float] = None,
                  queue_empty: bool = True) -> Optional[Batch]:
        if not self._pending:
            return None
        now = time.perf_counter() if now is None else now
        # deadline-aware ordering: tightest remaining budget first, then
        # arrival — an undeadlined backlog stays FIFO
        self._pending.sort(
            key=lambda p: (p.deadline_at if p.deadline_at is not None
                           else float("inf"), p.seq)
        )
        head = self._pending[0]
        group = [p for p in self._pending if p.compat == head.compat]
        group = group[: self.max_batch]
        if len(group) < self.max_batch:
            if not queue_empty:
                return None  # more work is already queued — let it join
            oldest = min(p.arrival_s for p in group)
            if self.hold_s and (now - oldest) < self.hold_s:
                return None  # bounded batch-formation fill wait
        taken = {id(p) for p in group}
        self._pending = [p for p in self._pending if id(p) not in taken]
        return Batch(key=head.compat, items=group)

    def pending(self) -> int:
        return len(self._pending)


class FairScheduler(Scheduler):
    """Per-tenant priority lanes + deficit-round-robin (module docstring).

    Deterministic: lane scan order is (priority, name); credit grants and
    spends are integer-granular with ``quantum × weight`` per backlogged
    lane per round; an emptied lane drops its deficit (classic DRR).
    """

    name = "fair"
    preemptive = True

    def __init__(self, *, quantum: float = 1.0, **kw):
        super().__init__(**kw)
        self.quantum = float(quantum)
        self._lanes: Dict[str, List[Any]] = {}
        self._deficit: Dict[str, float] = {}

    def collect(self, engine):
        # like continuous: lanes fill from whatever is queued, no fill wait
        if self.pending():
            return engine._collect_window(self.max_batch, 0.0,
                                          first_timeout_s=0.0, greedy=True)
        return engine._collect_window(self.max_batch, 0.0, greedy=True)

    def add(self, prepared: Sequence[Any]) -> None:
        for p in prepared:
            self._lanes.setdefault(getattr(p, "tenant", "default") or "default",
                                   []).append(p)

    def _backlogged(self) -> List[str]:
        return sorted(
            (t for t, lane in self._lanes.items() if lane),
            key=lambda t: (self.tenant_config(t).priority, t),
        )

    def next_plan(self, now: Optional[float] = None,
                  queue_empty: bool = True) -> Optional[Batch]:
        names = self._backlogged()
        if not names:
            return None
        # one grant round always makes some lane eligible (weights >= 1),
        # so two scan passes suffice
        for _ in range(2):
            for t in names:
                if self._deficit.get(t, 0.0) >= 1.0:
                    return self._take(t)
            for t in names:
                self._deficit[t] = (self._deficit.get(t, 0.0)
                                    + self.quantum
                                    * max(self.tenant_config(t).weight, 1))
        return self._take(names[0])  # defensive; unreachable for quantum >= 1

    def _take(self, tenant: str) -> Batch:
        lane = self._lanes[tenant]
        cap = min(self.max_batch,
                  max(int(self._deficit.get(tenant, 1.0)), 1))
        head = lane[0]
        group, rest = [], []
        for p in lane:
            if p.compat == head.compat and len(group) < cap:
                group.append(p)
            else:
                rest.append(p)
        self._lanes[tenant] = rest
        self._deficit[tenant] = self._deficit.get(tenant, 0.0) - len(group)
        if not rest:
            self._deficit.pop(tenant, None)
        return Batch(key=head.compat, items=group)

    def pending(self) -> int:
        return sum(len(lane) for lane in self._lanes.values())

    def snapshot(self) -> Dict[str, Any]:
        return {
            "policy": self.name,
            "pending": self.pending(),
            "lanes": {t: len(lane) for t, lane in self._lanes.items() if lane},
            "deficit": {t: round(d, 3) for t, d in self._deficit.items()},
        }


def make_scheduler(policy: str, **kw) -> Scheduler:
    """Factory for the engine/CLI ``--scheduler`` knob."""
    classes = {"drain": DrainScheduler, "continuous": ContinuousScheduler,
               "fair": FairScheduler}
    if policy not in classes:
        raise ValueError(
            f"unknown scheduler policy {policy!r} — expected one of "
            f"{SCHEDULER_POLICIES}"
        )
    return classes[policy](**kw)
