"""EditEngine: the persistent in-process edit-serving core (port of
``videop2p_tpu/serve/engine.py``).

Request lifecycle (one worker thread owns every device dispatch, so the
order of work on the card is deterministic and the HTTP layer never touches
the card):

  admit → resolve (controller + content-addressed inversion-store lookup;
  a miss first tries REHYDRATION from the store's disk layer — a restarted
  engine rebuilds the capture from the persisted trajectory through its
  warm inversion program, no frame IO and no VAE encode — and only then
  runs VAE encode + capture-inversion ONCE per clip) → batch (compatible
  concurrent requests group into one dispatch, :mod:`~videop2p_tpu_torch.
  serve.batching`, formed by the scheduling policy of
  :mod:`~videop2p_tpu_torch.serve.sched`: ``drain``, ``continuous`` or
  ``fair``) → dispatch (the warm ``serve_edit`` program: the cached-source
  controlled edit + VAE decode, then ``torch.cuda.synchronize``) →
  artifacts (GIFs) + per-request verdicts (``src_err``, compile-event
  delta, store hit, ``queue_wait_s``, ``content_sha256``).

Resilience:

  * **deadlines** — per-request ``deadline_s`` admitted at submit; an
    expired request fails with terminal status ``deadline_exceeded``
    before more device work is spent on it.
  * **watchdog** — the dispatch runs under a bounded wait
    (``dispatch_timeout_s`` and/or the batch's tightest remaining
    deadline); past it the batch fails ``deadline_exceeded`` and the worker
    abandons the stuck thread and keeps serving. On CUDA the abandoned
    work cannot be cancelled: it runs on in the same stream, and the next
    dispatch queues behind it. The fault plan's ``hang`` is a host sleep
    in the dispatch seam, before any device work, so it is bounded
    exactly.
  * **retry + circuit breaker** — transient dispatch failures
    (:func:`~videop2p_tpu_torch.serve.faults.is_transient`: injected
    faults, ``torch.cuda.OutOfMemoryError``, never a sticky CUDA error)
    retry on a capped, jitter-free exponential schedule; consecutive batch
    failures trip the breaker (closed → open → half-open): while open,
    submits fast-fail 503 with ``Retry-After``.
  * **backpressure** — a bounded admit queue (``max_queue`` in flight);
    over it, submits raise :class:`~videop2p_tpu_torch.serve.faults.
    QueueFull` (HTTP 429).
  * **fault injection** — a deterministic :class:`~videop2p_tpu_torch.
    serve.faults.FaultPlan` threads through the dispatch and store seams.

Observability is the engine's run ledger (execute timing on): every
program call, kernel build, fault and breaker transition is an event;
close() writes the ``slo_report`` events (``slo=True``, obs/slo.py), the
``cost_attribution`` rows and one ``serve_health`` summary. ``incidents=``
(a bundle root, or a shared :class:`~videop2p_tpu_torch.obs.incident.
IncidentManager`) tees the ledger into a flight ring and captures a bundle
when the breaker opens or the dispatch watchdog fires. Every device
computation runs under ``torch.no_grad`` in the thread that launches it
(grad mode is thread-local in PyTorch), on the engine's device.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.obs.cost import CostModel
from videop2p_tpu_torch.obs.probe import PROBE_TENANT
from videop2p_tpu_torch.obs.spans import Tracer, make_span_id, make_trace_id, parse_traceparent
from videop2p_tpu_torch.serve.batching import compat_key, stack_items, unstack_outputs
from videop2p_tpu_torch.serve.faults import (
    CircuitBreaker,
    DeadlineExceeded,
    EngineUnavailable,
    FaultPlan,
    QueueFull,
    RetryPolicy,
    is_transient,
)
from videop2p_tpu_torch.serve.programs import ProgramSet, ProgramSpec, check_single_device
from videop2p_tpu_torch.serve.sched import Scheduler, TenantConfig, make_scheduler, parse_tenants
from videop2p_tpu_torch.serve.store import InversionStore

__all__ = ["EditRequest", "EditEngine", "TERMINAL_STATUSES"]

_REQUEST_FIELDS = (
    "image_path", "prompt", "prompts", "save_name", "is_word_swap",
    "blend_word", "eq_params", "cross_replace_steps", "self_replace_steps",
    "seed", "steps", "deadline_s", "tenant", "quant_mode", "reuse_schedule",
    "student",
)

# the machine-readable terminal statuses — everything else is in flight.
# "error": the engine gave up on the request (resolve failure, retries
# exhausted); "deadline_exceeded": its budget expired (queued too long or
# the dispatch watchdog fired); "engine_closed": close() drained it.
TERMINAL_STATUSES = ("done", "error", "deadline_exceeded", "engine_closed")

# bounded in-memory mirror of the fault/breaker ledger events
_FAULT_LOG_MAX = 256

# how long close() waits for each dispatch thread the watchdog abandoned: a
# thread still running when the interpreter exits aborts the process
_ABANDONED_JOIN_S = 60.0


@dataclass
class EditRequest:
    """One edit of one clip — the JSON surface of the HTTP API.

    ``frames`` (host array, (F, H, W, 3) uint8) may replace ``image_path``
    for in-process callers; it never crosses the JSON boundary. ``seed``
    enters the store key; the cached edit draws no noise (η = 0) and the
    encode takes the posterior mean, so nothing else reads it.
    """

    image_path: str = ""
    prompt: str = ""
    prompts: Sequence[str] = field(default_factory=list)
    save_name: str = "edit"
    is_word_swap: bool = False
    blend_word: Optional[Sequence[str]] = None
    eq_params: Optional[Dict] = None
    cross_replace_steps: float = 0.2
    self_replace_steps: float = 0.5
    seed: int = 0
    # per-request DDIM step count: None = the spec's base count; fewer
    # steps run the timestep-subset path from the SAME base-steps inversion.
    # Must be a warmed bucket (else a 400 at admission)
    steps: Optional[int] = None
    # per-request latency budget in seconds from submit (None: the tenant's
    # or the engine's default)
    deadline_s: Optional[float] = None
    # QoS identity: the fair scheduler's lane, the per-tenant deadline
    # default and the per-tenant accounting key on it
    tenant: str = "default"
    # quant_mode is an ASSERTION: weights are quantized when the set is
    # built, so any value other than the set's is a 400. reuse_schedule
    # selects a warmed deep-feature reuse schedule (else a 400)
    quant_mode: Optional[str] = None
    reuse_schedule: Optional[str] = None
    # run the consistency-distilled student over the same teacher capture
    # (admitted only for a set built with a student and a warmed bucket)
    student: bool = False
    frames: Optional[np.ndarray] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EditRequest":
        unknown = set(d) - set(_REQUEST_FIELDS)
        if unknown:
            raise ValueError(f"unknown request field(s): {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in _REQUEST_FIELDS}

    def validate(self) -> None:
        if not self.prompt:
            raise ValueError("request needs a source 'prompt'")
        if len(list(self.prompts)) < 2:
            raise ValueError("request needs 'prompts' = [source, edit, ...] (>= 2 entries)")
        if list(self.prompts)[0] != self.prompt:
            raise ValueError("prompts[0] must equal the source prompt")
        if self.frames is None and not self.image_path:
            raise ValueError("request needs 'image_path' (or in-process frames)")
        if self.steps is not None and (not isinstance(self.steps, int) or self.steps < 1):
            raise ValueError(f"'steps' must be a positive int, got {self.steps!r}")
        if self.deadline_s is not None and (
                not isinstance(self.deadline_s, (int, float))
                or isinstance(self.deadline_s, bool) or self.deadline_s <= 0):
            raise ValueError(f"'deadline_s' must be positive seconds, got {self.deadline_s!r}")
        if self.tenant is not None and not isinstance(self.tenant, str):
            raise ValueError(f"'tenant' must be a string, got {self.tenant!r}")
        if self.quant_mode is not None:
            from videop2p_tpu_torch.models.quant import validate_quant_mode

            validate_quant_mode(self.quant_mode)
        if self.reuse_schedule is not None and not isinstance(self.reuse_schedule, str):
            raise ValueError(f"'reuse_schedule' must be a string, got {self.reuse_schedule!r}")
        if not isinstance(self.student, bool):
            raise ValueError(f"'student' must be a bool, got {self.student!r}")


@dataclass(eq=False)
class _Prepared:
    """A resolved request, ready to batch: its argument tree, its
    compatibility key, its resolved step count and the scheduling metadata
    the policies order on."""

    rid: str
    args: Tuple  # (cached, cond_all, uncond, ctx, anchor)
    compat: str
    steps: int
    reuse: str = "off"
    student: bool = False
    seq: int = 0
    arrival_s: float = 0.0
    deadline_at: Optional[float] = None
    tenant: str = "default"


class EditEngine:
    """Persistent multi-tenant edit engine over one :class:`ProgramSet`, on
    ``device`` (CUDA unless a CPU device is given)."""

    def __init__(
        self,
        spec: ProgramSpec,
        *,
        out_dir: str,
        store_budget_bytes: int = 4 << 30,
        persist_dir: Optional[str] = None,
        max_batch: int = 4,
        max_wait_s: float = 0.05,
        batch_dispatch: str = "scan",
        ledger_path: Optional[str] = None,
        keep_videos: bool = False,
        programs: Optional[ProgramSet] = None,
        scheduler: Any = "drain",
        tenants: Any = None,
        max_batch_wait_s: Optional[float] = None,
        batch_order: str = "first_seen",
        max_queue: int = 64,
        default_deadline_s: Optional[float] = None,
        dispatch_timeout_s: Optional[float] = None,
        max_retries: int = 2,
        retry_base_s: float = 0.05,
        retry_cap_s: float = 2.0,
        breaker_threshold: int = 3,
        breaker_open_s: float = 5.0,
        faults: Optional[FaultPlan] = None,
        tracing: bool = False,
        slo: bool = False,
        incidents: Any = None,
        device="cuda",
    ):
        from videop2p_tpu_torch.cli.common import make_run_ledger

        if batch_dispatch == "vmap":
            raise NotImplementedError(
                "batch_dispatch 'vmap' shards a batch over a data mesh: multi-GPU "
                "serving is not ported (ROADMAP Queue 1 item 13's rest)")
        if batch_dispatch != "scan":
            raise ValueError(f"batch_dispatch must be 'scan', got {batch_dispatch!r}")
        check_single_device(spec)
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.batch_dispatch = batch_dispatch
        self.keep_videos = bool(keep_videos)
        self.max_queue = max(int(max_queue), 1)
        self.default_deadline_s = default_deadline_s
        self.dispatch_timeout_s = dispatch_timeout_s
        self.retry = RetryPolicy(max_retries=max_retries, base_s=retry_base_s,
                                 cap_s=retry_cap_s)
        self.breaker = CircuitBreaker(threshold=breaker_threshold, open_s=breaker_open_s,
                                      on_transition=self._on_breaker)
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.tenants: Dict[str, TenantConfig] = (
            parse_tenants(tenants) if isinstance(tenants, str) else dict(tenants or {}))
        if isinstance(scheduler, Scheduler):
            self.scheduler = scheduler
        else:
            self.scheduler = make_scheduler(
                str(scheduler or "drain"), max_batch=self.max_batch,
                max_wait_s=self.max_wait_s, max_batch_wait_s=max_batch_wait_s,
                order=batch_order, tenants=self.tenants)
        device = programs.device if programs is not None else torch.device(device)
        self.ledger = make_run_ledger(
            ledger_path or os.path.join(out_dir, "serve_ledger.jsonl"),
            enable=True, latency=True, set_latency_env=False, device=device,
            meta={"cli": "serve", "spec": dict(spec.resolved().__dict__),
                  "scheduler": self.scheduler.name,
                  "faults": getattr(self.faults, "spec", None), "tracing": bool(tracing)})
        self.tracer = Tracer(self.ledger, enabled=tracing)
        self._tracing = self.tracer.enabled
        # `slo` evaluates DEFAULT_SLOS into slo_report events at close
        self._slo = bool(slo)
        # cost & capacity plane (obs/cost.py): static program costs stream
        # in through the ledger's analysis observer as each program's first
        # call is analysed; the worker prices every successful dispatch by
        # fair share, terminal records carry the per-request cost vector,
        # close() emits the chargeback rows
        self.cost = CostModel()
        self.ledger.analysis_observers.append(self.cost.observe_program)
        # per-rid fresh-inversion attribution, folded into the terminal cost
        # vector by _finish
        self._resolve_costs: Dict[str, Dict[str, Any]] = {}
        self.fault_log: Deque[Dict[str, Any]] = deque(maxlen=_FAULT_LOG_MAX)
        self.counters: Dict[str, int] = {
            "shed": 0, "rejected_unavailable": 0, "retries": 0,
            "faults_injected": 0, "rehydrations": 0, "fresh_inversions": 0,
        }
        self.tenant_counters: Dict[str, Dict[str, int]] = {}
        self._counter_lock = threading.Lock()
        self._seq = 0
        self._qw_sum = 0.0
        self._qw_count = 0
        if self.faults is not None:
            self.faults.on_inject = self._fault_event
        self.programs = (programs if programs is not None
                         else ProgramSet(spec, device=device))
        self.spec = self.programs.spec
        # per-request steps, reuse schedules and student buckets are admitted
        # only against what was warmed: never a cold build mid-serve
        self.warm_steps = {self.spec.steps}
        self.warm_reuse = {self.spec.reuse_schedule}
        self.warm_student: set = set()
        if self.programs.warmed:
            self.warm_steps.update(self.programs.warmed.get("steps", []))
            self.warm_reuse.update(self.programs.warmed.get("reuse", []))
            self.warm_student.update(self.programs.warmed.get("student", []))
        self.store = InversionStore(store_budget_bytes, persist_dir=persist_dir,
                                    faults=self.faults)
        self._spec_fp = self.spec.fingerprint()
        # incident plane: tee this ledger into the manager's flight ring,
        # register this engine as a /healthz + /metrics snapshot target and
        # its reservoirs as the trace-id exemplar source. A shared manager
        # (an in-process fleet) is used as-is and NOT closed by this
        # engine; a directory builds an owned one with crash hooks.
        self.incidents = None
        self._own_incidents = False
        if incidents is not None:
            from videop2p_tpu_torch.obs.incident import IncidentManager

            if isinstance(incidents, IncidentManager):
                self.incidents = incidents
            else:
                self.incidents = IncidentManager(str(incidents), crash_hooks=True)
                self._own_incidents = True
            self.incidents.attach_ledger(self.ledger)
            self.incidents.note_fingerprint(f"engine:{self.ledger.run_id}", self._spec_fp)
            self.incidents.register_target(
                f"engine:{self.ledger.run_id}",
                lambda: {"healthz": self.health_record(), "metrics": self.metrics()})
            self.incidents.register_exemplars(self.ledger.execute_timing_summary)
        self._requests: Dict[str, Dict[str, Any]] = {}
        self._videos: Dict[str, np.ndarray] = {}
        self._req_lock = threading.Lock()
        self._inflight = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._abandoned: List[threading.Thread] = []
        self._closed = False
        self._drain_until = float("inf")
        self.started = time.perf_counter()
        self._worker = threading.Thread(target=self._worker_loop, name="edit-engine",
                                        daemon=True)
        self._worker.start()
        # finished results wait here for the writer thread (GIFs, content
        # hash, cost books), so the worker goes straight on to the next
        # dispatch; bounded, so a writer that falls behind holds the worker
        self._results: "queue.Queue" = queue.Queue(maxsize=2 * self.max_batch)
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="edit-engine-writer", daemon=True)
        self._writer.start()

    # ---- public API ------------------------------------------------------

    def warm(self, prompts: Sequence[str] = ("a video", "an edited video"), *,
             controller_kwargs: Optional[Dict] = None,
             step_buckets: Sequence[int] = (), reuse_schedules: Sequence[str] = (),
             student_steps: Sequence[int] = ()) -> Dict[str, Any]:
        """Run the request path once on zeros (``ProgramSet.warm``); the
        summary lands in the ledger and ``/healthz``, and its step, reuse and
        student lists become what the engine admits."""
        with self._device_context():
            info = self.programs.warm(
                prompts, controller_kwargs=controller_kwargs, step_buckets=step_buckets,
                reuse_schedules=reuse_schedules, student_steps=student_steps)
        self.warm_steps.update(info.get("steps", []))
        self.warm_reuse.update(info.get("reuse", []))
        self.warm_student.update(info.get("student", []))
        self.ledger.event("serve_warm", **info)
        self.ledger.memory_snapshot("after warm")
        return info

    def submit(self, request: EditRequest, *, traceparent: Optional[str] = None) -> str:
        """Enqueue one request; returns its id at once.

        Fast-fail surfaces: a closed engine or an OPEN breaker raises
        :class:`EngineUnavailable` (503); a full admit queue
        :class:`QueueFull` (429); an unwarmed ``steps`` / ``reuse_schedule``
        / student bucket, a mismatched ``quant_mode`` or a malformed request
        ``ValueError`` (400). ``traceparent`` (tracing on) joins an inbound
        trace."""
        tenant = request.tenant or "default"
        if self._closed:
            raise EngineUnavailable("engine is closed")
        if not self.breaker.allow():
            self._count("rejected_unavailable")
            self._tcount(tenant, "rejected")
            raise EngineUnavailable(
                f"circuit breaker open after {self.breaker.consecutive_failures} "
                "consecutive dispatch failures — backend presumed unhealthy",
                retry_after_s=self.breaker.retry_after_s())
        request.validate()
        steps = int(request.steps) if request.steps else self.spec.steps
        if request.student:
            if self.programs.student_head is None:
                raise ValueError(
                    "student=True but this program set has no student checkpoint — build "
                    "the set with --student_ckpt (ProgramSpec.student_ckpt) and warm "
                    "student buckets (EditEngine.warm(student_steps=...) / cli.serve "
                    "--student_buckets)")
            if steps not in self.warm_student:
                raise ValueError(
                    f"steps={steps} is not a warmed student bucket (warmed student: "
                    f"{sorted(self.warm_student)}) — warm it first "
                    "(EditEngine.warm(student_steps=...) / cli.serve --student_buckets)")
        elif steps not in self.warm_steps:
            raise ValueError(
                f"steps={steps} is not a warmed step bucket (warmed: "
                f"{sorted(self.warm_steps)}) — warm it first "
                "(EditEngine.warm(step_buckets=...) / cli.serve --step_buckets)")
        if request.quant_mode is not None and request.quant_mode != self.spec.quant_mode:
            raise ValueError(
                f"quant_mode={request.quant_mode!r} does not match this program set "
                f"(serving quant_mode={self.spec.quant_mode!r}) — weights are quantized "
                "when the set is built; route to a set built with that mode "
                "(cli.serve --quant_mode)")
        from videop2p_tpu_torch.pipelines.reuse import validate_reuse_schedule

        reuse = (request.reuse_schedule if request.reuse_schedule is not None
                 else self.spec.reuse_schedule)
        reuse = validate_reuse_schedule(reuse, steps)
        if reuse not in self.warm_reuse:
            raise ValueError(
                f"reuse_schedule={reuse!r} is not a warmed schedule (warmed: "
                f"{sorted(self.warm_reuse)}) — warm it first "
                "(EditEngine.warm(reuse_schedules=...) / cli.serve --reuse_buckets)")
        rid = uuid.uuid4().hex[:12]
        now = time.perf_counter()
        # deadline: the request's own > the tenant's default > the engine's
        deadline_s = request.deadline_s
        if deadline_s is None:
            tcfg = self.tenants.get(tenant)
            deadline_s = tcfg.deadline_s if tcfg is not None else None
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        rec = {
            "id": rid,
            "status": "queued",
            "submitted_s": now,
            "deadline_s": deadline_s,
            "deadline_at": now + float(deadline_s) if deadline_s is not None else None,
            "tenant": tenant,
            "request": {k: v for k, v in request.to_dict().items() if k != "frames"},
            "compile_events_before": len(self.ledger.compile_seconds),
            "cache_misses_before": self.programs.cache_misses,
        }
        if self._tracing:
            parsed = parse_traceparent(traceparent)
            trace_id, parent = parsed if parsed else (make_trace_id(), None)
            rec["trace_id"] = trace_id
            rec["span_id"] = make_span_id()
            rec["_span_parent"] = parent
            rec["_wall_ns"] = time.time_ns()
        with self._req_lock:
            if self._inflight >= self.max_queue:
                depth = self._inflight
            else:
                depth = None
                self._seq += 1
                rec["seq"] = self._seq
                self._requests[rid] = rec
                self._inflight += 1
        if depth is not None:
            self._count("shed")
            self._tcount(tenant, "shed")
            raise QueueFull(depth, self.max_queue)
        self._tcount(tenant, "submitted")
        self._queue.put((rid, request))
        return rid

    def poll(self, rid: str) -> Dict[str, Any]:
        """JSON-safe snapshot of one request's record."""
        with self._req_lock:
            rec = self._requests.get(rid)
            if rec is None:
                raise KeyError(f"unknown request id {rid!r}")
            return json.loads(json.dumps(rec, default=str))

    def result(self, rid: str, *, wait_s: float = 0.0,
               poll_interval_s: float = 0.02) -> Dict[str, Any]:
        """The record once terminal; with ``wait_s`` blocks up to that long."""
        deadline = time.perf_counter() + max(float(wait_s), 0.0)
        while True:
            rec = self.poll(rid)
            if rec["status"] in TERMINAL_STATUSES or time.perf_counter() >= deadline:
                return rec
            time.sleep(poll_interval_s)

    def videos(self, rid: str) -> Optional[np.ndarray]:
        """The decoded (P, F, H, W, 3) [0, 1] float32 array for in-process
        callers (kept only with ``keep_videos=True``)."""
        return self._videos.get(rid)

    def take_videos(self, rid: str) -> Optional[np.ndarray]:
        """Pop (and return) one request's kept videos: a streaming job's
        harvest, so a long job holds only its in-flight windows
        instead of every decoded window for the life of the engine."""
        return self._videos.pop(rid, None)

    def metrics(self) -> Dict[str, Any]:
        """The live record ``/metrics`` serves: per-program and per-phase
        latency distributions from the ledger's reservoirs, compile events,
        store hit rates, request counts, queue-depth / in-flight gauges, the
        breaker snapshot, resilience counters, capacity and the card's
        memory."""
        with self._req_lock:
            by_status: Dict[str, int] = {}
            for rec in self._requests.values():
                by_status[rec["status"]] = by_status.get(rec["status"], 0) + 1
            in_flight = self._inflight
        timing = self.ledger.execute_timing_summary()
        uptime_s = time.perf_counter() - self.started
        return {
            "uptime_s": round(uptime_s, 3),
            "spec_fingerprint": self._spec_fp,
            "warm": self.programs.warmed,
            "requests": by_status,
            "queue_depth": self._queue.qsize(),
            "in_flight": in_flight,
            "max_queue": self.max_queue,
            "scheduler": self.scheduler.snapshot(),
            "tenants": self._tenant_records(),
            "breaker": self.breaker.snapshot(),
            "counters": dict(self.counters),
            "store": self.store.stats(),
            "compile": {
                "events": len(self.ledger.compile_seconds),
                "total_s": round(sum(self.ledger.compile_seconds), 4),
                "program_cache_misses": self.programs.cache_misses,
            },
            "request_latency": timing.get("serve_request_e2e"),
            "programs": timing,
            "capacity": self.cost.capacity(uptime_s),
            "devices": self._device_memory(),
        }

    def _tenant_records(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant QoS accounting: terminal outcomes, error/shed rates
        and measured device-seconds per tenant lane."""
        with self._counter_lock:
            counters = {t: dict(c) for t, c in self.tenant_counters.items()}
        costs = self.cost.tenant_costs()
        out: Dict[str, Dict[str, Any]] = {}
        for t, c in counters.items():
            errors = c.get("errors", 0)
            deadline_exceeded = c.get("deadline_exceeded", 0)
            finished = (c.get("done", 0) + errors + deadline_exceeded
                        + c.get("engine_closed", 0))
            attempts = c.get("submitted", 0) + c.get("shed", 0) + c.get("rejected", 0)
            tcost = costs.get(t, {})
            out[t] = {
                **c,
                "error_rate": (round((errors + deadline_exceeded) / finished, 4)
                               if finished else 0.0),
                "shed_rate": (round((c.get("shed", 0) + c.get("rejected", 0)) / attempts, 4)
                              if attempts else 0.0),
                "device_seconds": round(tcost.get("device_seconds", 0.0), 6),
                "saved_device_seconds": round(tcost.get("saved_device_seconds", 0.0), 6),
            }
        return out

    def health_record(self) -> Dict[str, Any]:
        """The ``serve_health`` summary (``SERVE_HEALTH_FIELDS``): outcomes
        by terminal status, error/shed rates, breaker trips, the fault and
        recovery counters, the policy with its mean queue wait, capacity
        facts and the per-tenant sub-records."""
        with self._req_lock:
            by_status: Dict[str, int] = {}
            for rec in self._requests.values():
                by_status[rec["status"]] = by_status.get(rec["status"], 0) + 1
        admitted = sum(by_status.values())
        errors = by_status.get("error", 0)
        deadline_exceeded = by_status.get("deadline_exceeded", 0)
        shed = self.counters["shed"]
        rejected = self.counters["rejected_unavailable"]
        attempts = admitted + shed + rejected
        capacity = self.cost.capacity(time.perf_counter() - self.started)
        return {
            "requests": admitted,
            "done": by_status.get("done", 0),
            "errors": errors,
            "deadline_exceeded": deadline_exceeded,
            "engine_closed": by_status.get("engine_closed", 0),
            "shed": shed,
            "rejected_unavailable": rejected,
            "error_rate": (round((errors + deadline_exceeded) / admitted, 4)
                           if admitted else 0.0),
            "shed_rate": round((shed + rejected) / attempts, 4) if attempts else 0.0,
            "breaker_trips": self.breaker.trips,
            "retries": self.counters["retries"],
            "faults_injected": self.counters["faults_injected"],
            "rehydrations": self.counters["rehydrations"],
            "fresh_inversions": self.counters["fresh_inversions"],
            "store_corrupt": self.store.disk_corrupt,
            "scheduler": self.scheduler.name,
            "queue_wait_mean_s": (round(self._qw_sum / self._qw_count, 4)
                                  if self._qw_count else 0.0),
            "busy_fraction": capacity["busy_fraction"],
            "padding_waste": capacity["padding_waste"],
            "tenants": self._tenant_records(),
        }

    def cost_records(self) -> List[Dict[str, Any]]:
        """The live ``cost_attribution`` rows: the engine-scope capacity
        roll-up plus the per-tenant / per-program chargeback aggregates."""
        return self.cost.attribution_records(time.perf_counter() - self.started)

    def close(self, *, drain_s: float = 0.0) -> None:
        """Stop admitting, stop the worker, and FAIL every still-pending
        request with terminal status ``engine_closed``. With ``drain_s`` > 0,
        queued work first gets that long to finish (the SIGTERM drain of
        ``cli/serve.py``); the dispatch in flight always completes. Writes
        the chargeback rows and ``serve_health``, then closes the ledger."""
        if self._closed:
            return
        self._closed = True
        self._drain_until = time.perf_counter() + max(float(drain_s), 0.0)
        if drain_s > 0:
            while time.perf_counter() < self._drain_until:
                with self._req_lock:
                    if self._inflight == 0:
                        break
                time.sleep(0.02)
        self._queue.put(None)
        self._worker.join(timeout=60.0)
        for thread in self._abandoned:
            thread.join(timeout=_ABANDONED_JOIN_S)
        self._results.put(None)
        self._writer.join(timeout=60.0)
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        with self._req_lock:
            pending = [rid for rid, rec in self._requests.items()
                       if rec["status"] not in TERMINAL_STATUSES]
        for rid in pending:
            self._fail_status(rid, "engine_closed", "engine closed before completion")
        health = self.health_record()
        if self._slo:
            # the declarative objectives over the LIVE summaries, one
            # slo_report event each, before the health summary
            from videop2p_tpu_torch.obs.slo import emit_slo_reports, record_from_summaries

            try:
                emit_slo_reports(self.ledger, record_from_summaries(
                    health=health, timing=self.ledger.execute_timing_summary()))
            except Exception:  # noqa: BLE001 — obs never blocks shutdown
                pass
        for row in self.cost_records():
            self.ledger.event("cost_attribution", label="serve", **row)
        self.ledger.memory_snapshot("at close")
        self.ledger.event("serve_health", **health)
        self.ledger.event("serve_shutdown", requests=len(self._requests))
        if self.incidents is not None and self._own_incidents:
            try:
                self.incidents.close()  # restores the crash hooks
            except Exception:  # noqa: BLE001 — obs never blocks shutdown
                pass
        self.ledger.close()

    def __enter__(self) -> "EditEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- fault / breaker bookkeeping ------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    _TENANT_COUNTER_KEYS = ("submitted", "done", "errors", "deadline_exceeded",
                            "engine_closed", "shed", "rejected")

    def _tcount(self, tenant: str, name: str, n: int = 1) -> None:
        with self._counter_lock:
            d = self.tenant_counters.setdefault(
                tenant, {k: 0 for k in self._TENANT_COUNTER_KEYS})
            d[name] = d.get(name, 0) + n

    def _fault_event(self, kind: str, **fields: Any) -> None:
        """One fault observation (an injection through the FaultPlan's
        ``on_inject``, or engine-classified): a ``fault`` ledger event, the
        bounded in-memory log and the injection counter."""
        detail = ", ".join(f"{k}={v}" for k, v in fields.items()) or kind
        if kind in ("dispatch_fail", "backend_unavailable", "hang", "store_corrupt"):
            self._count("faults_injected")
        self.fault_log.append({"event": "fault", "kind": kind, "detail": detail})
        self.ledger.fault(kind, detail=detail)

    def _on_breaker(self, state_from: str, state_to: str, *,
                    consecutive_failures: int, trips: int) -> None:
        self.fault_log.append({"event": "breaker", "state_from": state_from,
                               "state_to": state_to,
                               "consecutive_failures": consecutive_failures,
                               "trips": trips})
        self.ledger.breaker(state_from, state_to,
                            consecutive_failures=consecutive_failures, trips=trips)
        if state_to == "open" and self.incidents is not None:
            # the breaker declaring the backend unhealthy IS the incident:
            # capture the flight ring while the evidence is still hot
            self.incidents.trigger(
                "breaker_open",
                detail=(f"{state_from}->open after {consecutive_failures} "
                        f"consecutive dispatch failures (trip {trips})"),
                consecutive_failures=consecutive_failures, trips=trips)

    # ---- worker ----------------------------------------------------------

    def _device_context(self):
        """No-grad on the engine's device: entered by every thread that runs
        device work (grad mode and the current CUDA device are per thread)."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self.programs.device.type == "cuda":
            stack.enter_context(torch.cuda.device(self.programs.device))
        return stack

    def _worker_loop(self) -> None:
        """The scheduling loop: the policy picks the admit window
        (``collect``), the worker resolves what it pulled, and the policy
        forms dispatch batches (``next_plan``). Preemptive policies
        (continuous, fair) collect again after EVERY dispatch; drain
        dispatches every planned batch first."""
        sched = self.scheduler
        with self._device_context():
            while True:
                raw = sched.collect(self)
                if raw is None:
                    break
                prepared = []
                for rid, request in raw:
                    p = self._resolve(rid, request)
                    if p is not None:
                        prepared.append(p)
                if prepared:
                    sched.add(prepared)
                while True:
                    plan = sched.next_plan(time.perf_counter(),
                                           queue_empty=self._queue.empty())
                    if plan is None:
                        break
                    try:
                        self._dispatch(plan)
                    except Exception as e:  # noqa: BLE001 — the worker outlives ANY batch
                        for p in plan.items:
                            self._fail(p.rid, f"dispatch failed unexpectedly: {e}",
                                       time.perf_counter())
                    if sched.preemptive:
                        break
        self._done.set()

    def _writer_loop(self) -> None:
        """Finish each dispatched request off the worker thread: its GIFs,
        content hash and cost vector, then the terminal ``done``. A request
        whose artifacts cannot be written fails alone."""
        while True:
            job = self._results.get()
            if job is None:
                return
            try:
                self._finish(*job)
            except Exception as e:  # noqa: BLE001 — the writer outlives ANY request
                self._fail(job[0], f"writing the result failed: {e}", time.perf_counter())

    def _collect_window(self, max_items: int, window_s: float, *,
                        first_timeout_s: float = 0.2,
                        oldest_budget_s: Optional[float] = None, greedy: bool = False):
        """One admit window (the schedulers parameterize it): block up to
        ``first_timeout_s`` for the first request, then keep taking requests
        until ``max_items`` are in hand or ``window_s`` elapses.
        ``oldest_budget_s`` caps the window by the FIRST request's time in
        the queue since submit; ``greedy`` keeps taking already-queued
        requests after the window closes, without blocking. A closed engine
        past its drain window stops collecting."""
        if self._closed and time.perf_counter() >= self._drain_until:
            return None
        try:
            first = self._queue.get(timeout=first_timeout_s)
        except queue.Empty:
            return []
        if first is None:
            return None
        items = [first]
        deadline = time.perf_counter() + window_s
        if oldest_budget_s is not None:
            with self._req_lock:
                rec = self._requests.get(first[0])
                submitted = rec.get("submitted_s") if rec else None
            if submitted is not None:
                deadline = min(deadline, submitted + float(oldest_budget_s))
        while len(items) < max_items:
            remaining = deadline - time.perf_counter()
            try:
                if remaining <= 0:
                    if not greedy:
                        break
                    nxt = self._queue.get_nowait()
                else:
                    nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the sentinel for the outer loop
                break
            items.append(nxt)
        return items

    def _update(self, rid: str, **fields) -> Dict[str, Any]:
        with self._req_lock:
            rec = self._requests[rid]
            rec.update(fields)
            return rec

    def _deadline_remaining(self, rid: str) -> Optional[float]:
        with self._req_lock:
            rec = self._requests.get(rid)
            at = rec.get("deadline_at") if rec else None
        return None if at is None else at - time.perf_counter()

    def _deadline_expired(self, rid: str) -> bool:
        remaining = self._deadline_remaining(rid)
        return remaining is not None and remaining < 0

    def _store_key(self, request: EditRequest, ctx) -> str:
        """Content-addressed identity of the inversion products: the
        program-set fingerprint × the clip's content × the source prompt ×
        the seed × the capture plan the controller implies."""
        from videop2p_tpu_torch.pipelines.cached import capture_windows
        from videop2p_tpu_torch.utils.inv_cache import content_fingerprint, inversion_cache_key

        if request.frames is not None:
            clip = hashlib.sha256(
                np.ascontiguousarray(request.frames).tobytes()).hexdigest()[:16]
        else:
            clip = content_fingerprint(os.path.abspath(request.image_path))
        cross_len, self_window = capture_windows(ctx, self.spec.steps)
        return inversion_cache_key(
            spec=self._spec_fp, clip=clip, prompt=request.prompt, seed=request.seed,
            cross_len=cross_len, self_window=self_window,
            capture_blend=ctx.blend is not None)

    def _resolve(self, rid: str, request: EditRequest) -> Optional[_Prepared]:
        """Admit one request: controller, prompt encodings, store lookup
        (resident → disk rehydration → fresh) and, on a full miss, the
        once-per-clip encode + capture-inversion."""
        t0 = time.perf_counter()
        if self._deadline_expired(rid):
            self._fail_status(rid, "deadline_exceeded", "deadline expired before resolve")
            return None
        with self._req_lock:
            rec0 = self._requests.get(rid) or {}
            submitted = rec0.get("submitted_s")
            seq = rec0.get("seq", 0)
            deadline_at = rec0.get("deadline_at")
            tenant = rec0.get("tenant", "default")
            tid = rec0.get("trace_id") if self._tracing else None
            root_span = rec0.get("span_id")
            wall0 = rec0.get("_wall_ns")
        queue_wait_s = max(t0 - submitted, 0.0) if submitted else 0.0
        self.ledger.record_execute("serve_queue_wait", queue_wait_s, queue_wait_s, tid)
        with self._counter_lock:
            self._qw_sum += queue_wait_s
            self._qw_count += 1
        self._update(rid, status="resolving", queue_wait_s=round(queue_wait_s, 4))
        if tid:
            self.tracer.emit("serve.queue", trace_id=tid, span_id=make_span_id(),
                             parent_id=root_span, wall_ns=wall0, duration_s=queue_wait_s,
                             rid=rid)
        try:
            ps = self.programs
            steps = int(request.steps) if request.steps else self.spec.steps
            controller_kwargs = dict(
                is_word_swap=request.is_word_swap,
                cross_replace_steps=request.cross_replace_steps,
                self_replace_steps=request.self_replace_steps,
                blend_word=request.blend_word, eq_params=request.eq_params)
            # the BASE-steps controller keys the store and the capture
            # (inversions are captured at the base grid); a few-step request
            # also builds its own subset-space controller below
            ctx = ps.controller(list(request.prompts), **controller_kwargs)
            cond_all = ps.encode_prompts(list(request.prompts))
            uncond = ps.encode_prompts([""])[0]
            key = self._store_key(request, ctx)
            products = self.store.get(key)
            source = "memory" if products is not None else None
            if products is None:
                # rehydration: the persisted trajectory's first entry IS the
                # encoded source latents, so the warm inversion program
                # rebuilds the capture from it — no frame IO, no VAE encode
                traj_np = self.store.load_disk(key)
                if traj_np is not None and traj_np.shape[0] == self.spec.steps + 1:
                    anchor = torch.as_tensor(traj_np[0], device=ps.device)
                    _, cached = ps.invert_capture(
                        anchor, ps.encode_prompts([request.prompt]), ctx)
                    products = (cached, anchor)
                    source = "disk"
                    self._count("rehydrations")
                    self.store.put(key, products)  # resident again; already on disk
            if products is None:
                if request.frames is not None:
                    frames = np.asarray(request.frames)
                else:
                    from videop2p_tpu_torch.data.dataset import load_frame_sequence

                    frames = load_frame_sequence(request.image_path, size=self.spec.width,
                                                 num_frames=self.spec.video_len)
                latents = ps.encode(ps.frames_to_video(frames))
                traj, cached = ps.invert_capture(
                    latents, ps.encode_prompts([request.prompt]), ctx)
                products = (cached, latents)
                source = "fresh"
                self._count("fresh_inversions")
                self.store.put(
                    key, products,
                    trajectory=traj.cpu().numpy() if self.store.persist_dir else None,
                    meta={"image_path": request.image_path, "prompt": request.prompt,
                          "steps": self.spec.steps, "width": self.spec.width,
                          "video_len": self.spec.video_len})
                del traj
            if source == "fresh":
                # the measured price a store hit avoids: this clip's encode +
                # capture-inversion seconds, priced to this request as a
                # singleton serve_invert dispatch (so a cold request carries
                # its inversion in its cost vector)
                ps.sync()
                inv_s = time.perf_counter() - t0
                self.cost.note_fresh_inversion(inv_s)
                self._resolve_costs[rid] = self.cost.price_dispatch(
                    inv_s, real=1, padded=1, program="serve_invert")
            cached, anchor = products
            ctx_edit = ctx
            if steps != self.spec.steps:
                from videop2p_tpu_torch.pipelines.cached import check_subset_windows

                ctx_edit = ps.controller(list(request.prompts), steps=steps,
                                         **controller_kwargs)
                _, positions = ps.step_plan(steps)
                check_subset_windows(ctx_edit, cached, positions, steps)
            args = (cached, cond_all, uncond, ctx_edit, anchor)
            dt = time.perf_counter() - t0
            self.ledger.record_execute("serve_resolve", dt, dt, tid)
            self._update(rid, store_hit=source in ("memory", "disk"), store_source=source,
                         store_key=key, steps=steps, resolve_s=round(dt, 4))
            if tid:
                self.tracer.emit(
                    "serve.resolve", trace_id=tid, span_id=make_span_id(),
                    parent_id=root_span,
                    wall_ns=(wall0 + int((t0 - submitted) * 1e9)
                             if wall0 is not None and submitted else None),
                    duration_s=dt, rid=rid, store_source=source, steps=steps)
            reuse = (request.reuse_schedule if request.reuse_schedule is not None
                     else self.spec.reuse_schedule)
            student = bool(request.student)
            return _Prepared(
                rid=rid, args=args, steps=steps, reuse=reuse, student=student,
                compat=compat_key(args, extra=(self._spec_fp, steps, self.spec.guidance_scale,
                                               self.batch_dispatch, reuse, student)),
                seq=seq, arrival_s=t0, deadline_at=deadline_at, tenant=tenant)
        except Exception as e:  # noqa: BLE001 — one bad request must not kill the engine
            self._fail(rid, f"resolve failed: {e}", t0)
            return None

    # ---- dispatch: watchdog + retry + breaker ----------------------------

    def _device_dispatch(self, plan) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The batch's device work (singleton or scan), waited for with
        ``torch.cuda.synchronize``, so the dispatch seconds are the card's
        and not the time it took to queue the launches. The fault seam
        fires first, inside whatever watchdog bounds this call."""
        if self.faults is not None:
            self.faults.on_dispatch()
        ps = self.programs
        # compat keys carry the step count, reuse schedule and student flag:
        # a plan is homogeneous in all three
        p0 = plan.items[0]
        if len(plan.items) == 1:
            outs = [ps.edit_decode(*p0.args, steps=p0.steps, reuse=p0.reuse,
                                   student=p0.student)]
        else:
            batched = ps.edit_decode_batch(stack_items([p.args for p in plan.items]),
                                           dispatch=self.batch_dispatch, steps=p0.steps,
                                           reuse=p0.reuse, student=p0.student)
            outs = unstack_outputs(batched, len(plan.items))
        ps.sync()
        return outs

    def _watchdog_dispatch(self, plan, budget_s: Optional[float]):
        """The dispatch under a bounded wait: past ``budget_s`` the thread
        running it is ABANDONED (a daemon: work already queued on the card
        cannot be cancelled, only orphaned; it runs on in the stream and the
        next dispatch queues behind it) and :class:`DeadlineExceeded` is
        raised so the worker fails the batch and keeps serving; close() joins
        it (bounded). ``budget_s`` None runs inline."""
        if budget_s is None:
            return self._device_dispatch(plan)
        if budget_s <= 0:
            raise DeadlineExceeded("dispatch budget already expired")
        result: Dict[str, Any] = {}
        done = threading.Event()

        def runner():
            try:
                with self._device_context():
                    result["out"] = self._device_dispatch(plan)
            except BaseException as e:  # noqa: BLE001 — carried to the worker
                result["exc"] = e
            done.set()

        thread = threading.Thread(target=runner, daemon=True, name="edit-engine-dispatch")
        thread.start()
        if not done.wait(timeout=budget_s):
            self._abandoned.append(thread)
            self._fault_event("watchdog_timeout", budget_s=round(budget_s, 3))
            raise DeadlineExceeded(f"dispatch exceeded its {budget_s:.3f}s budget "
                                   "(watchdog abandoned the stuck dispatch)")
        if "exc" in result:
            raise result["exc"]
        return result["out"]

    def _dispatch(self, plan) -> None:
        """One planned batch through the resilience pipeline: deadline
        expiry → bounded dispatch → retry on a transient failure → breaker
        accounting. A failed batch fails only its own requests."""
        attempt = 0
        failed: set = set()
        while True:
            live = []
            for p in plan.items:
                if p.rid in failed:
                    continue
                if self._deadline_expired(p.rid):
                    failed.add(p.rid)
                    self._fail_status(p.rid, "deadline_exceeded",
                                      "deadline expired before dispatch")
                    continue
                live.append(p)
            if not live:
                return
            budgets = [self.dispatch_timeout_s] + [self._deadline_remaining(p.rid)
                                                   for p in live]
            budgets = [b for b in budgets if b is not None]
            budget = min(budgets) if budgets else None
            t0 = time.perf_counter()
            # padded_size keeps JAX's record schema: the port never pads;
            # a member whose deadline expired still runs in its slot
            occupancy = {"real": len(live), "padded": len(plan.items)}
            for p in live:
                self._update(p.rid, status="running", batch_size=len(plan.items),
                             padded_size=len(plan.items), batch_occupancy=dict(occupancy),
                             dispatch_attempts=attempt + 1)
            try:
                outs = self._watchdog_dispatch(plan, budget)
            except DeadlineExceeded as e:
                # the budget is burned: never retried; the breaker counts it
                self.breaker.record_failure()
                if self.incidents is not None:
                    self.incidents.trigger("deadline_exceeded",
                                           detail=f"dispatch watchdog: {e}",
                                           batch_size=len(live))
                for p in live:
                    self._fail_status(p.rid, "deadline_exceeded", str(e))
                return
            except Exception as e:  # noqa: BLE001 — classified below
                if is_transient(e) and attempt < self.retry.max_retries and not self._closed:
                    delay = self.retry.delay_s(attempt)
                    self._count("retries")
                    self._fault_event("retry", attempt=attempt + 1,
                                      backoff_s=round(delay, 4),
                                      error=f"{type(e).__name__}: {e}")
                    time.sleep(delay)
                    attempt += 1
                    continue
                self.breaker.record_failure()
                for p in live:
                    self._fail(p.rid, f"dispatch failed: {e}", t0)
                return
            self.breaker.record_success()
            dt = time.perf_counter() - t0
            tid0 = self._emit_dispatch_spans(live, t0, dt) if self._tracing else None
            self.ledger.record_execute("serve_dispatch", dt, dt, tid0)
            # fair-share cost attribution: the dispatch's seconds split per
            # slot; live members get one slot's share each, the slots of
            # expired members land in the padding line (attribution +
            # padding = dt). Each member ran the singleton program, so a
            # slot's static cost is that program's, whole
            p0 = plan.items[0]
            cost_slot = self.cost.price_dispatch(
                dt, real=len(live), padded=len(plan.items),
                singleton="serve_edit" + self.programs._suffix(p0.steps, p0.reuse, p0.student))
            # host copies after the timed window (they synchronize too)
            for p, (videos, src_err) in zip(plan.items, outs):
                if p.rid in failed:
                    continue
                self._results.put((p.rid, videos.cpu().numpy(), float(src_err), dt,
                                   len(self.ledger.compile_seconds),
                                   self.programs.cache_misses, cost_slot))
            return

    def _emit_dispatch_spans(self, live, t0: float, dt: float) -> Optional[str]:
        """One ``serve.batch`` span under the FIRST member's trace with a
        fresh ``batch_id`` and the member ids, and one ``serve.dispatch``
        child span per member carrying the same ``batch_id``. Returns the
        first member's trace id (the dispatch reservoir's exemplar)."""
        batch_id = make_span_id()
        members = [p.rid for p in live]
        with self._req_lock:
            recs = {p.rid: dict(self._requests.get(p.rid) or {}) for p in live}
        first_tid = None
        for p in live:
            rec = recs.get(p.rid) or {}
            tid = rec.get("trace_id")
            if not tid:
                continue
            wall0, submitted = rec.get("_wall_ns"), rec.get("submitted_s")
            wall = (wall0 + int((t0 - submitted) * 1e9)
                    if wall0 is not None and submitted else None)
            if first_tid is None:
                first_tid = tid
                self.tracer.emit("serve.batch", trace_id=tid, span_id=batch_id,
                                 parent_id=rec.get("span_id"), wall_ns=wall, duration_s=dt,
                                 batch_id=batch_id, batch_size=len(live), members=members)
            self.tracer.emit("serve.dispatch", trace_id=tid, span_id=make_span_id(),
                             parent_id=rec.get("span_id"), wall_ns=wall, duration_s=dt,
                             rid=p.rid, batch_id=batch_id, batch_size=len(live))
        return first_tid

    def _finish(self, rid: str, videos: np.ndarray, src_err: float, dispatch_s: float,
                compile_mark: int, miss_mark: int,
                cost_slot: Optional[Dict[str, Any]] = None) -> None:
        """A dispatched request's terminal record (on the writer thread).
        ``compile_mark`` / ``miss_mark`` are the compile and program-cache
        miss counts when its dispatch ended: its deltas stop there."""
        from videop2p_tpu_torch.utils.video_io import save_video_gif

        rec = self.poll(rid)
        req = rec["request"]
        if self.faults is not None and self.faults.wrong:
            # silent wrong-answer seam (wrong:PAT): a deterministic
            # perturbation, self-consistent across replays
            if self.faults.wrongs(rec.get("store_key") or rid):
                videos = np.ascontiguousarray(videos[..., ::-1])
        # stable answer identity: the bytes of the whole video tensor
        content_sha256 = hashlib.sha256(np.ascontiguousarray(videos).tobytes()).hexdigest()
        quality = None
        if rec.get("tenant") == PROBE_TENANT:
            # golden-quality canary metrics, for the probe tenant only
            from videop2p_tpu_torch.obs.quality import psnr, ssim

            quality = {"edit_psnr": round(float(psnr(videos[1], videos[0])), 4),
                       "edit_ssim": round(float(ssim(videos[1], videos[0])), 4)}
        tid = rec.get("trace_id") if self._tracing else None
        t_dec0 = time.perf_counter()
        req_dir = os.path.join(self.out_dir, rid)
        os.makedirs(req_dir, exist_ok=True)
        inversion_gif = os.path.join(req_dir, "inversion.gif")
        edit_gif = os.path.join(req_dir, f"{req.get('save_name', 'edit')}.gif")
        save_video_gif(videos[0], inversion_gif, fps=4)
        save_video_gif(videos[1], edit_gif, fps=4)
        if self.keep_videos:
            self._videos[rid] = videos
        total = time.perf_counter() - rec["submitted_s"]
        if tid:
            wall0 = rec.get("_wall_ns")
            self.tracer.emit(
                "serve.decode", trace_id=tid, span_id=make_span_id(),
                parent_id=rec.get("span_id"),
                wall_ns=(wall0 + int((t_dec0 - rec["submitted_s"]) * 1e9)
                         if wall0 is not None else None),
                duration_s=time.perf_counter() - t_dec0, rid=rid)
        self.ledger.record_execute("serve_request_e2e", total, total, tid)
        compile_events = compile_mark - rec.get("compile_events_before", 0)
        cache_misses = miss_mark - rec.get("cache_misses_before", 0)
        # the per-request cost vector: this slot's share of the dispatch,
        # its queue seconds, a cold request's own inversion, and for a store
        # hit the inversion it avoided
        slot = cost_slot or {}
        inv = self._resolve_costs.pop(rid, None) or {}
        cost = {
            "program": slot.get("program", "serve_edit"),
            "device_seconds": round(slot.get("device_seconds", 0.0)
                                    + inv.get("device_seconds", 0.0), 6),
            "flops": slot.get("flops", 0.0) + inv.get("flops", 0.0),
            "hbm_byte_seconds": (slot.get("hbm_byte_seconds", 0.0)
                                 + inv.get("hbm_byte_seconds", 0.0)),
            "queue_seconds": round(rec.get("queue_wait_s") or 0.0, 6),
            "padding_share": round(slot.get("padding_share", 0.0), 6),
            "saved_device_seconds": 0.0,
            "saved_flops": 0.0,
        }
        store_hit = bool(rec.get("store_hit"))
        if store_hit:
            saved = self.cost.savings()
            cost["saved_device_seconds"] = round(saved["saved_device_seconds"], 6)
            cost["saved_flops"] = saved["saved_flops"]
        programs = [(cost["program"],
                     {**cost, "device_seconds": round(slot.get("device_seconds", 0.0), 6),
                      "flops": slot.get("flops", 0.0),
                      "hbm_byte_seconds": slot.get("hbm_byte_seconds", 0.0)})]
        if inv:
            programs.append(("serve_invert", inv))
        self.cost.account_request(tenant=rec.get("tenant", "default"), cost=cost,
                                  store_hit=store_hit, programs=programs)
        self._terminalize(
            rid, "done", dispatch_s=round(dispatch_s, 4), total_s=round(total, 4),
            src_err=src_err, compile_events=compile_events,
            program_cache_misses=cache_misses, cost=cost,
            content_sha256=content_sha256, **(quality or {}),
            inversion_gif=inversion_gif, edit_gif=edit_gif)
        self.ledger.event("serve_request", id=rid, total_s=round(total, 4), src_err=src_err,
                          compile_events=compile_events, store_hit=store_hit)

    def _terminalize(self, rid: str, status: str, **fields) -> bool:
        """Move a record to a terminal status exactly once (the in-flight
        gauge decrements on the transition); False when already terminal."""
        with self._req_lock:
            rec = self._requests.get(rid)
            if rec is None or rec["status"] in TERMINAL_STATUSES:
                return False
            rec["status"] = status
            rec.update(fields)
            self._inflight -= 1
            tenant = rec.get("tenant", "default")
            tid = rec.get("trace_id") if self._tracing else None
            root_span = rec.get("span_id")
            parent = rec.get("_span_parent")
            wall0 = rec.get("_wall_ns")
            submitted = rec.get("submitted_s")
        self._tcount(tenant, {"done": "done", "error": "errors",
                              "deadline_exceeded": "deadline_exceeded",
                              "engine_closed": "engine_closed"}[status])
        if tid:
            # the request's ROOT span closes on every terminal transition
            self.tracer.emit("serve.request", trace_id=tid, span_id=root_span,
                             parent_id=parent, wall_ns=wall0,
                             duration_s=time.perf_counter() - submitted if submitted else 0.0,
                             status=status, rid=rid, tenant=tenant)
        return True

    def _fail_status(self, rid: str, status: str, message: str,
                     t0: Optional[float] = None) -> None:
        started = t0 if t0 is not None else time.perf_counter()
        if self._terminalize(rid, status, error=message,
                             total_s=round(time.perf_counter() - started, 4)):
            self.ledger.event("serve_request_error", id=rid, status=status, error=message)

    def _fail(self, rid: str, message: str, t0: float) -> None:
        self._fail_status(rid, "error", message, t0)

    def _device_memory(self) -> List[Dict[str, Any]]:
        """The card's allocator gauges (empty on the CPU)."""
        dev = self.programs.device
        if dev.type != "cuda":
            return []
        try:
            ms = torch.cuda.memory_stats(dev)
            return [{"device": str(dev),
                     "bytes_in_use": ms.get("allocated_bytes.all.current"),
                     "peak_bytes_in_use": ms.get("allocated_bytes.all.peak"),
                     "reserved_bytes": ms.get("reserved_bytes.all.current"),
                     "bytes_limit": torch.cuda.get_device_properties(dev).total_memory}]
        except Exception:  # noqa: BLE001 — metrics never break serving
            return []
