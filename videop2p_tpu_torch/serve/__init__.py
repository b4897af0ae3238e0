"""Persistent edit serving on one device, and the fleet over it (port of
``videop2p_tpu/serve/``).

  * :mod:`~videop2p_tpu_torch.serve.programs` — :class:`ProgramSet`: the
    models, the scheduler and the instrumented programs (VAE encode,
    capture-inversion, cached-source edit + decode), built once per
    :class:`ProgramSpec`; :class:`ProgramCache` keeps a few sets.
  * :mod:`~videop2p_tpu_torch.serve.store` — :class:`InversionStore`: a
    byte-budgeted device-resident LRU of inversion products, keyed by
    content, with disk write-through of trajectories shared with the CLIs
    (``--inv_store``).
  * :mod:`~videop2p_tpu_torch.serve.batching` — deterministic grouping of
    compatible concurrent requests into one dispatch (``scan``).
  * :mod:`~videop2p_tpu_torch.serve.sched` — the ``drain``, ``continuous``
    and ``fair`` scheduling policies.
  * :mod:`~videop2p_tpu_torch.serve.engine` — :class:`EditEngine`: the
    request lifecycle (admit → resolve → batch → dispatch → decode) on one
    worker thread, with the run ledger as live telemetry.
  * :mod:`~videop2p_tpu_torch.serve.faults` — fault injection, retry, the
    circuit breaker and the fast-fail exceptions.
  * :mod:`~videop2p_tpu_torch.serve.http` / :mod:`~videop2p_tpu_torch.
    serve.client` — the stdlib JSON API (``cli/serve.py`` is the entry
    point) and its urllib client.
  * :mod:`~videop2p_tpu_torch.serve.replica` / :mod:`~videop2p_tpu_torch.
    serve.router` — the fleet tier: a :class:`ReplicaSupervisor` running N
    engines (in this process over one shared warm :class:`ProgramSet`, or
    one ``cli/serve.py`` child each) over ONE shared disk inversion store,
    and a stdlib :class:`Router` that ranks replicas by ``/healthz`` and
    ``/metrics``, routes around open breakers, retries deterministically
    and aggregates the fleet's health (``cli/router.py`` is the entry
    point).
  * :mod:`~videop2p_tpu_torch.serve.collector` — the fleet telemetry
    plane's ingest half: :class:`FleetCollector` scrapes every replica's
    and the router's ``/healthz`` + ``/metrics`` into a bounded
    time-series store (``obs/tsdb.py``) and evaluates burn, trend and
    demand signals over it (``obs/signals.py``).
  * :mod:`~videop2p_tpu_torch.serve.prober` — the correctness plane's
    scheduler: :class:`FleetProber` runs the known-answer suite
    (``obs/probe.py``) in the ``probe`` tenant lane, audits canary answers
    across replicas and serves quarantine verdicts to the router.

Several GPUs: a data mesh's ``vmap`` dispatch in one process, a
model-parallel mesh served from rank 0 of a ``torchrun`` world
(:class:`LeaderProgramSet`, ``ProgramSet.follow``).
"""

from videop2p_tpu_torch.serve.batching import (
    Batch,
    compat_key,
    plan_batches,
    stack_items,
    unstack_outputs,
)
from videop2p_tpu_torch.serve.client import EngineClient, engine_available
from videop2p_tpu_torch.serve.collector import FleetCollector
from videop2p_tpu_torch.serve.engine import TERMINAL_STATUSES, EditEngine, EditRequest
from videop2p_tpu_torch.serve.faults import (
    CircuitBreaker,
    DeadlineExceeded,
    EngineUnavailable,
    FaultPlan,
    QueueFull,
    RetryPolicy,
    is_transient,
)
from videop2p_tpu_torch.serve.prober import FleetProber
from videop2p_tpu_torch.serve.programs import (
    LeaderProgramSet,
    ProgramCache,
    ProgramSet,
    ProgramSpec,
)
from videop2p_tpu_torch.serve.replica import (
    Replica,
    ReplicaSupervisor,
    free_port,
    listening_pid,
)
from videop2p_tpu_torch.serve.router import (
    ROUTER_HEALTH_FIELDS,
    Router,
    RouterServer,
    make_router_server,
)
from videop2p_tpu_torch.serve.sched import (
    SCHEDULER_POLICIES,
    ContinuousScheduler,
    DrainScheduler,
    FairScheduler,
    Scheduler,
    TenantConfig,
    make_scheduler,
    parse_tenants,
)
from videop2p_tpu_torch.serve.store import (
    InversionStore,
    load_persisted_inversion,
    save_persisted_inversion,
)

__all__ = [
    "Batch", "compat_key", "plan_batches", "stack_items",
    "unstack_outputs", "EngineClient", "engine_available", "TERMINAL_STATUSES",
    "EditEngine", "EditRequest", "CircuitBreaker", "DeadlineExceeded",
    "EngineUnavailable", "FaultPlan", "QueueFull", "RetryPolicy", "is_transient",
    "LeaderProgramSet", "ProgramCache", "ProgramSet", "ProgramSpec", "SCHEDULER_POLICIES",
    "ContinuousScheduler", "DrainScheduler", "FairScheduler", "Scheduler",
    "TenantConfig", "make_scheduler", "parse_tenants", "InversionStore",
    "load_persisted_inversion", "save_persisted_inversion", "Replica",
    "ReplicaSupervisor", "free_port", "listening_pid", "Router", "RouterServer",
    "make_router_server", "ROUTER_HEALTH_FIELDS", "FleetCollector", "FleetProber",
]
