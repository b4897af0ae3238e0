"""Closed-loop load generator for the edit-serving engine and fleet (port of
``tools/serve_loadgen.py``, with the same flags plus ``--device``).

Drives N requests at a fixed concurrency against a running engine — over
HTTP (``--url``, a ``cli/serve.py`` process OR a ``cli/router.py`` fleet;
the API is identical), fully in-process (``--inproc``, builds a
tiny/random-init engine; the smoke mode), or against a self-built
in-process FLEET (``--router N``: N replicas over one shared warm
``ProgramSet`` and one disk inversion store behind a real HTTP router) —
and writes an ``execute_timing``-compatible run ledger: per-phase
client-side latency reservoirs (``loadgen_request`` end-to-end,
``loadgen_submit``, plus one reservoir per tenant) flushed through the
same :class:`~videop2p_tpu_torch.obs.timing.LatencyReservoir` machinery
every other run record uses. The ledger's events are the JAX loadgen's, so
the port's ``obs_diff``, ``fleet_dash``, ``probe_report``,
``incident_report`` and ``trace_view`` (``python -m
videop2p_tpu_torch.tools.<name>``) read it, as JAX's tools do:

    python -m videop2p_tpu_torch.tools.serve_loadgen --url http://host:8000 \
        --requests 64 --concurrency 8 --image data/rabbit --ledger loadgen_a.jsonl
    python -m videop2p_tpu_torch.tools.obs_diff loadgen_a.jsonl loadgen_b.jsonl

Closed loop = each worker submits its next request only after the previous
one finished — the concurrency IS the offered load, so latency percentiles
are comparable across runs without open-loop arrival modeling.

Per-tenant workload mix: ``--tenants A:5,B:1`` tags requests with tenant
names on a deterministic smooth-weighted-round-robin cycle (no randomness —
the same flags replay the same per-request tenants), and the summary +
ledger grow per-tenant p50/p99 latency and shed/success rates. Pair with
``--scheduler fair`` to exercise the deficit-round-robin lanes.

Chaos modes: ``--faults <plan>`` (``--inproc``) injects a deterministic
fault plan into the single engine; ``--replica_faults IDX:PLAN``
(``--router N``) injects into ONE replica of the fleet, gated by
``--min_success_rate`` (exit 1 below it), with the engines' ``fault`` /
``breaker`` / ``serve_health`` / ``cost_attribution`` events and the
router's ``router_health`` summary copied into the loadgen ledger.

The fleet's three planes, each on its own flag:

  * ``--collector`` — telemetry: a :class:`~videop2p_tpu_torch.serve.
    collector.FleetCollector` scrapes every replica's and the router's
    ``/healthz`` + ``/metrics`` every ``--scrape_interval_s`` into a
    bounded time-series store and evaluates burn, trend and demand signals
    (``--window_scale`` shrinks the 300 s / 3600 s windows so short runs
    span them); the ``fleet_signals`` trail, the ``fleet_series`` snapshot
    and ``<out_dir>/fleet_series.npz`` land in the ledger.
  * ``--probes`` — correctness: a :class:`~videop2p_tpu_torch.serve.
    prober.FleetProber` runs the known-answer suite against every replica
    and the router in the ``probe`` tenant lane — its first round before the
    load starts, then every ``--probe_interval_s`` while it runs;
    ``probe`` / ``probe_audit`` events land in the ledger, and in
    ``--router`` mode the router routes the load around a quarantined
    (wrong-but-healthy) replica.
  * ``--incidents DIR`` — one shared incident manager over the whole
    in-process fleet (breaker-open, deadline, burn-alert, probe-failure,
    crash and SIGUSR1 bundles under DIR); its ``incident`` events land in
    the ledger. ``--slo`` evaluates the default objectives over the run's
    own summaries into ``slo_report`` events.

    python -m videop2p_tpu_torch.tools.serve_loadgen --router 2 --device cpu \
        --requests 8 --collector --probes --slo --incidents incidents \
        --replica_faults 1:wrong:* --window_scale 0.02 --ledger fleet.jsonl

In ``--router`` mode the summary also carries the router's final
``/healthz`` (``router_healthz``: every replica's status and probe
verdict). :func:`main`'s ``programs`` keyword serves in-process callers:
an already built (and possibly warm) ``ProgramSet`` the engines share —
its spec replaces the one the flags describe, so a caller can drive the
fleet at full width.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

class _HttpTarget:
    def __init__(self, url: str, timeout_s: float):
        from videop2p_tpu_torch.serve.client import EngineClient

        self.client = EngineClient(url)
        self.timeout_s = timeout_s

    def one(self, request: Dict[str, Any],
            traceparent: Optional[str] = None) -> Dict[str, Any]:
        t0 = time.perf_counter()
        rid = self.client.submit(request, traceparent=traceparent)
        submit_s = time.perf_counter() - t0
        rec = self.client.wait(rid, timeout_s=self.timeout_s)
        rec["_submit_s"] = submit_s
        rec["_e2e_s"] = time.perf_counter() - t0
        return rec


class _InprocTarget:
    def __init__(self, engine, timeout_s: float):
        self.engine = engine
        self.timeout_s = timeout_s

    def one(self, request: Dict[str, Any],
            traceparent: Optional[str] = None) -> Dict[str, Any]:
        from videop2p_tpu_torch.serve.engine import EditRequest

        t0 = time.perf_counter()
        rid = self.engine.submit(EditRequest.from_dict(request),
                                 traceparent=traceparent)
        submit_s = time.perf_counter() - t0
        rec = self.engine.result(rid, wait_s=self.timeout_s)
        rec["_submit_s"] = submit_s
        rec["_e2e_s"] = time.perf_counter() - t0
        return rec


def _is_shed(exc: Exception) -> bool:
    """Was this submit load-shed (429) or fast-failed unavailable (503)?
    Sheds are the backpressure layer working as designed — counted apart
    from genuine errors."""
    try:
        from videop2p_tpu_torch.serve.faults import EngineUnavailable, QueueFull

        if isinstance(exc, (QueueFull, EngineUnavailable)):
            return True
    except ImportError:
        pass
    msg = str(exc)
    return "HTTP 429" in msg or "HTTP 503" in msg


def tenant_cycle(weights: Dict[str, int], n: int) -> List[str]:
    """Deterministic smooth-weighted-round-robin tenant assignment for
    ``n`` requests: each step every tenant gains its weight in credit, the
    richest (ties by name) is picked and pays the total weight back. The
    mix converges to the weight ratio with maximal interleave — and the
    same weights always produce the same per-request tenants."""
    if not weights:
        return ["default"] * n
    names = sorted(weights)
    total = sum(max(int(weights[t]), 1) for t in names)
    credit = {t: 0 for t in names}
    out = []
    for _ in range(n):
        for t in names:
            credit[t] += max(int(weights[t]), 1)
        pick = max(names, key=lambda t: (credit[t], t))
        credit[pick] -= total
        out.append(pick)
    return out


def parse_tenant_weights(spec: Optional[str]) -> Dict[str, int]:
    """``"A:5,B:1"`` → ``{"A": 5, "B": 1}`` (the workload-mix side of the
    tenant syntax — weights only; engine-side QoS uses serve/sched.py's
    ``parse_tenants``)."""
    if not spec:
        return {}
    out = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        if not name:
            raise ValueError(f"bad tenant weight {part!r} — expected name:weight")
        out[name] = int(w) if w else 1
    return out


def run_loadgen(
    target,
    request: Dict[str, Any],
    *,
    requests: int,
    concurrency: int,
    ledger_path: Optional[str] = None,
    meta: Optional[Dict[str, Any]] = None,
    collect_extra=None,
    tenants: Optional[Dict[str, int]] = None,
    mutate_request=None,
    tracing: bool = False,
    slo: bool = False,
) -> Dict[str, Any]:
    """Run the closed loop; returns the summary record (also printed as one
    JSON line by :func:`main`). When ``ledger_path`` is given, the
    reservoirs flush there as ``execute_timing`` events. ``collect_extra``
    (chaos/fleet mode) is called after the loop and may return extra
    ledger events (dicts with an ``"event"`` key — the engines' ``fault``
    / ``breaker`` trail, their ``serve_health`` summaries and the router's
    ``router_health``) to write into the same ledger, making the run's
    reliability obs_diff-gateable. ``tenants`` (name → weight) tags each
    request on the deterministic :func:`tenant_cycle` and adds per-tenant
    latency/shed accounting. ``mutate_request(req, issue_index)`` is the
    per-request hook (``--distinct_seeds`` rides it).

    ``tracing`` mints a client-side root span per request and
    forwards its traceparent to the target — the engine/router/replica
    ledgers then share the loadgen's trace ids, and the `loadgen.request`
    spans land in THIS ledger so trace_view joins the full client→fleet
    tree. ``slo`` evaluates the default objectives over the run's own
    summaries into ``slo_report`` events (obs_diff's SLO_RULES gate
    them)."""
    from videop2p_tpu_torch.obs.timing import LatencyReservoir

    reservoirs = {
        "loadgen_request": LatencyReservoir(),
        "loadgen_submit": LatencyReservoir(),
        # the engine-reported admit→dispatch queue wait, threaded back
        # per tenant so fair-scheduler starvation is VISIBLE client-side
        # (a starved lane shows a fat queue-wait p99 with a normal
        # dispatch latency)
        "loadgen_queue_wait": LatencyReservoir(),
    }
    assignment = tenant_cycle(tenants or {}, requests) if tenants else None
    tenant_names = sorted(tenants) if tenants else []
    for t in tenant_names:
        reservoirs[f"loadgen_request_{t}"] = LatencyReservoir()
        reservoirs[f"loadgen_queue_wait_{t}"] = LatencyReservoir()
    spans: List[Dict[str, Any]] = []  # buffered; the ledger opens at the end
    lock = threading.Lock()
    counters = {"done": 0, "errors": 0, "deadline_exceeded": 0, "shed": 0,
                "store_hits": 0, "issued": 0}
    tcounters = {t: {"requests": 0, "done": 0, "errors": 0,
                     "deadline_exceeded": 0, "shed": 0}
                 for t in tenant_names}

    def worker():
        while True:
            with lock:
                if counters["issued"] >= requests:
                    return
                idx = counters["issued"]
                counters["issued"] += 1
            req = dict(request)
            tenant = None
            if assignment is not None:
                tenant = assignment[idx]
                req["tenant"] = tenant
                with lock:
                    tcounters[tenant]["requests"] += 1
            if mutate_request is not None:
                req = mutate_request(req, idx)
            tid = span_id = tp = None
            wall0 = 0
            if tracing:
                from videop2p_tpu_torch.obs.spans import (
                    format_traceparent,
                    make_span_id,
                    make_trace_id,
                )

                tid, span_id = make_trace_id(), make_span_id()
                tp = format_traceparent(tid, span_id)
                wall0 = time.time_ns()
            try:
                rec = target.one(req, tp)
            except Exception as e:  # noqa: BLE001 — a failed request is a counter, not a crash
                kind = "shed" if _is_shed(e) else "errors"
                with lock:
                    counters[kind] += 1
                    if tenant is not None:
                        tcounters[tenant][kind] += 1
                    if tracing:
                        spans.append({
                            "trace_id": tid, "span_id": span_id,
                            "parent_id": None, "name": "loadgen.request",
                            "wall_ns": wall0, "duration_s": 0.0,
                            "status": kind, "index": idx, "tenant": tenant,
                        })
                print(f"[loadgen] request failed: {e}", file=sys.stderr)
                continue
            with lock:
                status = rec.get("status")
                if status == "done":
                    counters["done"] += 1
                    if rec.get("store_hit"):
                        counters["store_hits"] += 1
                elif status == "deadline_exceeded":
                    counters["deadline_exceeded"] += 1
                else:
                    counters["errors"] += 1
                if tenant is not None:
                    key = {"done": "done",
                           "deadline_exceeded": "deadline_exceeded"}.get(
                               status, "errors")
                    tcounters[tenant][key] += 1
            reservoirs["loadgen_request"].add(rec["_e2e_s"], rec["_e2e_s"],
                                              tid)
            reservoirs["loadgen_submit"].add(rec["_submit_s"],
                                             rec["_submit_s"], tid)
            qw = rec.get("queue_wait_s")
            if isinstance(qw, (int, float)):
                reservoirs["loadgen_queue_wait"].add(float(qw), float(qw),
                                                     tid)
            if tenant is not None:
                reservoirs[f"loadgen_request_{tenant}"].add(
                    rec["_e2e_s"], rec["_e2e_s"], tid
                )
                if isinstance(qw, (int, float)):
                    reservoirs[f"loadgen_queue_wait_{tenant}"].add(
                        float(qw), float(qw), tid
                    )
            if tracing:
                with lock:
                    spans.append({
                        "trace_id": tid, "span_id": span_id,
                        "parent_id": None, "name": "loadgen.request",
                        "wall_ns": wall0,
                        "duration_s": round(rec["_e2e_s"], 6),
                        "status": rec.get("status") or "ok",
                        "index": idx, "tenant": tenant,
                    })

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(int(concurrency), 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0

    summaries = {name: res.summary() for name, res in reservoirs.items()
                 if res.summary()}
    # sheds are correct backpressure, not failures — the success rate is
    # over the requests the engine actually accepted
    accepted = max(requests - counters["shed"], 1)
    record = {
        "requests": requests,
        "concurrency": concurrency,
        "done": counters["done"],
        "errors": counters["errors"],
        "deadline_exceeded": counters["deadline_exceeded"],
        "shed": counters["shed"],
        "store_hits": counters["store_hits"],
        "success_rate": round(counters["done"] / accepted, 4),
        "wall_s": round(wall_s, 4),
        "throughput_rps": round(counters["done"] / wall_s, 4) if wall_s else None,
        "latency": summaries.get("loadgen_request"),
    }
    if tenant_names:
        per_tenant = {}
        for t in tenant_names:
            c = tcounters[t]
            lat = summaries.get(f"loadgen_request_{t}") or {}
            qw = summaries.get(f"loadgen_queue_wait_{t}") or {}
            attempted = max(c["requests"], 1)
            per_tenant[t] = {
                **c,
                "shed_rate": round(c["shed"] / attempted, 4),
                "success_rate": round(
                    c["done"] / max(c["requests"] - c["shed"], 1), 4),
                "p50_s": lat.get("blocked_p50_s"),
                "p99_s": lat.get("blocked_p99_s"),
                # the engine-side queue wait per lane: fair-scheduler
                # starvation shows up HERE even when dispatch is healthy
                "queue_wait_p50_s": qw.get("blocked_p50_s"),
                "queue_wait_p99_s": qw.get("blocked_p99_s"),
            }
        record["tenants"] = per_tenant
    extra_events = []
    if collect_extra is not None:
        try:
            extra_events = list(collect_extra(record) or [])
        except Exception as e:  # noqa: BLE001 — chaos bookkeeping must not fail the run
            print(f"[loadgen] collect_extra failed: {e}", file=sys.stderr)
    if ledger_path:
        from videop2p_tpu_torch.obs import RunLedger

        led = RunLedger(
            ledger_path,
            meta={"cli": "serve_loadgen", **(meta or {}),
                  "requests": requests, "concurrency": concurrency,
                  "tracing": bool(tracing)},
        )
        for name, res in reservoirs.items():
            for d, b, t in res.samples():
                led.record_execute(name, d, b, t)
        for s in spans:
            led.event("span", **s)
        for e in extra_events:
            ev = dict(e)
            led.event(ev.pop("event", "fault"), **ev)
        if slo:
            from videop2p_tpu_torch.obs.slo import emit_slo_reports

            # the run's own summaries shaped like an extracted record:
            # availability/deadline objectives over the loop counters,
            # the served-p99 objective over the e2e reservoir
            accepted_n = max(requests - counters["shed"], 1)
            pseudo = {
                "reliability": {"serve": {
                    "requests": float(requests),
                    "deadline_exceeded": float(
                        counters["deadline_exceeded"]),
                    "error_rate": round(
                        (counters["errors"] + counters["deadline_exceeded"])
                        / accepted_n, 6),
                }},
                "timing": {"serve_request_e2e":
                           summaries.get("loadgen_request") or {}},
            }
            emit_slo_reports(led, pseudo)
        led.event("loadgen_summary", **{k: v for k, v in record.items()
                                        if k not in ("latency", "tenants")})
        led.close()  # flushes execute_timing events
        record["ledger"] = ledger_path
    return record


def _parse_replica_faults(specs: List[str]) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for spec in specs or []:
        idx, sep, plan = str(spec).partition(":")
        if not sep or not plan:
            raise ValueError(
                f"bad --replica_faults {spec!r} — expected IDX:PLAN "
                "(e.g. 0:unavail@1-999)"
            )
        out[int(idx)] = plan
    return out


def request_from_args(args) -> Dict[str, Any]:
    """The edit request every load request (and the probes' canary) is made
    from: ``--image`` with the ``--prompt`` / ``--edit_prompt`` pair."""
    return {
        "image_path": args.image,
        "prompt": args.prompt,
        "prompts": [args.prompt, args.edit_prompt],
        "save_name": "loadgen",
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    target_group = ap.add_mutually_exclusive_group(required=True)
    target_group.add_argument("--url", type=str,
                              help="base URL of a running cli/serve.py engine "
                                   "or cli/router.py fleet")
    target_group.add_argument("--inproc", action="store_true",
                              help="build an in-process engine (tiny/"
                                   "random-init smoke mode)")
    target_group.add_argument("--router", type=int, default=None,
                              metavar="N",
                              help="build an in-process FLEET: N engine "
                                   "replicas sharing one disk inversion "
                                   "store behind a real HTTP router, and "
                                   "drive the router URL")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--concurrency", type=int, default=4,
                    help="closed-loop clients (one blocked thread each — "
                         "thousands fit one process)")
    ap.add_argument("--timeout_s", type=float, default=600.0)
    ap.add_argument("--image", type=str, default="data/rabbit")
    ap.add_argument("--prompt", type=str, default="a rabbit is jumping")
    ap.add_argument("--edit_prompt", type=str,
                    default="a origami rabbit is jumping")
    ap.add_argument("--distinct_seeds", action="store_true",
                    help="vary the request seed per issue index so every "
                         "request MISSES the inversion store (cold-path "
                         "load) instead of hitting after the first")
    ap.add_argument("--tenants", type=str, default=None,
                    help="per-tenant workload mix, 'A:5,B:1' weight syntax: "
                         "requests carry tenant names on a deterministic "
                         "weighted cycle; the summary/ledger grow per-tenant "
                         "p50/p99 + shed rates. Also passed as the engine's "
                         "QoS config in --inproc/--router modes")
    ap.add_argument("--ledger", type=str, default="loadgen_ledger.jsonl")
    ap.add_argument("--tracing", action="store_true",
                    help="request-scoped tracing: mint a client "
                         "root span per request, forward traceparent to "
                         "the target, and record loadgen.request spans in "
                         "the ledger; --inproc/--router engines (and the "
                         "router itself) trace server-side with the SAME "
                         "trace ids — join with python -m "
                         "videop2p_tpu_torch.tools.trace_view")
    ap.add_argument("--slo", action="store_true",
                    help="evaluate the default SLOs over this run's "
                         "summaries into slo_report ledger events "
                         "(obs_diff SLO_RULES gate the budget burn)")
    ap.add_argument("--collector", action="store_true",
                    help="fleet telemetry plane: run a "
                         "FleetCollector scrape loop against the target "
                         "(every replica + the router in --router mode) "
                         "for the duration of the run; its fleet_signals "
                         "evaluations and the fleet_series tsdb snapshot "
                         "(+ .npz sidecar in --out_dir) land in THIS "
                         "ledger — gate with obs_diff SIGNAL_RULES, "
                         "render with python -m "
                         "videop2p_tpu_torch.tools.fleet_dash")
    ap.add_argument("--incidents", type=str, default=None, metavar="DIR",
                    help="incident plane: ONE shared "
                         "IncidentManager across the whole in-process "
                         "fleet — every engine/router ledger tees into "
                         "its flight ring, breaker-open/deadline/burn-"
                         "alert/crash triggers write debounced capture "
                         "bundles under DIR, and the incident events "
                         "land in THIS ledger (obs_diff INCIDENT_RULES "
                         "gate any increase) — render bundles with "
                         "python -m videop2p_tpu_torch.tools."
                         "incident_report")
    ap.add_argument("--probes", action="store_true",
                    help="correctness plane: run a FleetProber "
                         "known-answer loop against the target (every "
                         "replica + the router in --router mode) for the "
                         "duration of the run — probe verdicts and "
                         "cross-replica answer-audit divergences land in "
                         "THIS ledger (gate with obs_diff PROBE_RULES, "
                         "render with python -m videop2p_tpu_torch."
                         "tools.probe_report); in --router "
                         "mode the router quarantines divergent replicas")
    ap.add_argument("--probe_interval_s", type=float, default=5.0,
                    help="prober round cadence (each round runs the full "
                         "suite — several real canary edits per target)")
    ap.add_argument("--scrape_interval_s", type=float, default=0.5,
                    help="collector scrape/evaluate cadence")
    ap.add_argument("--window_scale", type=float, default=1.0,
                    help="scale the signal windows (fast 300s / slow "
                         "3600s x this) — short smoke runs want ~0.01 so "
                         "a 30s run spans the slow window")
    ap.add_argument("--saturation_threshold", type=float, default=5.0,
                    help="queue-wait-p99 / dispatch-p50 ratio past which "
                         "the signals advise grow — tiny CPU smoke "
                         "engines legitimately run 10-50x under a closed "
                         "loop, so raise this (e.g. 100) when smoking")
    # in-process engine knobs (smoke + fleet modes)
    ap.add_argument("--tiny", action="store_true", default=None)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--video_len", type=int, default=2)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--scheduler", type=str, default="drain",
                    choices=["drain", "continuous", "fair"],
                    help="batching policy for the in-process engine(s) "
                         "(serve/sched.py)")
    ap.add_argument("--out_dir", type=str, default="loadgen_out")
    ap.add_argument("--inv_store", type=str, default=None,
                    help="fleet mode: the shared disk inversion-store root "
                         "(default <out_dir>/inv_store)")
    # chaos mode: deterministic fault injection
    ap.add_argument("--faults", type=str, default=None,
                    help="fault plan (serve/faults.py DSL: fail@K, "
                         "hang@K:S, unavail@A-B, corrupt:PAT) injected into "
                         "the --inproc engine; the engine's fault/breaker "
                         "events and serve_health summary land in the "
                         "loadgen ledger")
    ap.add_argument("--replica_faults", action="append", default=[],
                    metavar="IDX:PLAN",
                    help="fleet chaos (--router): inject a fault plan into "
                         "replica IDX only (repeatable) — the router must "
                         "shed to the healthy replicas; gate with "
                         "--min_success_rate")
    ap.add_argument("--min_success_rate", type=float, default=None,
                    help="exit 1 when done/(requests-shed) falls below "
                         "this; default 0.5 in chaos mode, else the legacy "
                         "errors!=0 rule")
    ap.add_argument("--deadline_s", type=float, default=None,
                    help="default per-request deadline for the in-process "
                         "engine(s)")
    ap.add_argument("--dispatch_timeout_s", type=float, default=None)
    ap.add_argument("--max_retries", type=int, default=2)
    ap.add_argument("--breaker_threshold", type=int, default=3)
    ap.add_argument("--breaker_open_s", type=float, default=1.0)
    ap.add_argument("--max_queue", type=int, default=64)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the in-process engine(s) serve on (cuda, or cpu for "
                         "a smoke run)")
    return ap


def main(argv=None, *, programs=None) -> int:
    """The command line (module docstring). ``programs``: a built
    ``ProgramSet`` the in-process engine(s) share instead of one built from
    the flags' spec."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.faults and not args.inproc:
        ap.error("--faults injects at the engine seams — use --inproc "
                 "(fleet chaos: --router N --replica_faults IDX:PLAN; a "
                 "remote engine takes VIDEOP2P_SERVE_FAULTS / "
                 "cli/serve.py --faults instead)")
    if args.replica_faults and not args.router:
        ap.error("--replica_faults needs --router N (per-replica fleet "
                 "chaos)")
    if args.collector and args.inproc:
        ap.error("--collector scrapes HTTP surfaces — use --router N or "
                 "--url (an --inproc engine has no /metrics endpoint)")
    if args.probes and args.inproc:
        ap.error("--probes exercises the real JSON API — use --router N "
                 "or --url (an --inproc engine has no HTTP surface to "
                 "probe)")

    request = request_from_args(args)
    tenant_weights = parse_tenant_weights(args.tenants)
    engine = None
    supervisor = None
    router_server = None
    collector = None
    collect_extra = None
    scrape_targets: List[Any] = []
    chaos = bool(args.faults or args.replica_faults)

    incident_mgr = None
    if args.incidents:
        # one manager for the whole run: fleet-wide debounce (a breaker
        # flapping on two replicas is ONE incident), crash hooks for the
        # loadgen's process, and every in-process engine ledger teeing into
        # the same flight ring
        from videop2p_tpu_torch.obs.incident import IncidentManager

        incident_mgr = IncidentManager(args.incidents, crash_hooks=True)
        print(f"[loadgen] incident plane armed: bundles under "
              f"{args.incidents}")

    def spec_from_flags():
        """The shared set's spec, else the flags' (``--tiny`` defaults on
        in the in-process modes)."""
        from videop2p_tpu_torch.serve import ProgramSpec

        if programs is not None:
            return programs.spec
        tiny = True if args.tiny is None else args.tiny
        return ProgramSpec(checkpoint=args.checkpoint, tiny=tiny, steps=args.steps,
                           video_len=args.video_len, width=args.width)

    def engine_kwargs():
        return dict(
            device=args.device,
            incidents=incident_mgr,
            max_batch=args.max_batch,
            max_queue=args.max_queue,
            default_deadline_s=args.deadline_s,
            dispatch_timeout_s=args.dispatch_timeout_s,
            max_retries=args.max_retries,
            breaker_threshold=args.breaker_threshold,
            breaker_open_s=args.breaker_open_s,
            scheduler=args.scheduler,
            tenants=args.tenants,
            tracing=args.tracing,
            slo=args.slo,
        )

    if args.url:
        target = _HttpTarget(args.url, args.timeout_s)
        meta = {"target": args.url}
        scrape_targets = [("engine", args.url)]

        def collect_extra(record, client=target.client):
            # client-side reliability summary (the remote engine's own
            # ledger holds the authoritative one); breaker trips and the
            # cost plane's capacity section read from the live /metrics
            # when the engine still answers
            trips = None
            capacity = None
            try:
                m = client.metrics()
                trips = m.get("breaker", {}).get("trips")
                capacity = m.get("capacity")
            except Exception:  # noqa: BLE001 — the engine may be gone
                pass
            health = {
                "event": "serve_health", "requests": record["requests"],
                "done": record["done"], "errors": record["errors"],
                "deadline_exceeded": record["deadline_exceeded"],
                "shed": record["shed"],
                "error_rate": round(
                    (record["errors"] + record["deadline_exceeded"])
                    / max(record["requests"] - record["shed"], 1), 4),
                "shed_rate": round(
                    record["shed"] / max(record["requests"], 1), 4),
            }
            if trips is not None:
                health["breaker_trips"] = trips
            events = [health]
            if isinstance(capacity, dict):
                # : the remote engine's capacity accounting lands
                # as an engine-scope chargeback row so COST_RULES gate
                # remote runs too (tenant rows stay on the engine ledger)
                events.append({"event": "cost_attribution",
                               "label": "serve", "scope": "engine",
                               "name": "serve", **capacity})
            return events
    elif args.router:
        from videop2p_tpu_torch.serve import ReplicaSupervisor, Router, RouterServer

        spec = spec_from_flags()
        supervisor = ReplicaSupervisor(
            spec, args.router, out_dir=args.out_dir,
            persist_dir=args.inv_store,
            programs=programs,
            warm_prompts=(args.prompt, args.edit_prompt),
            engine_kwargs=engine_kwargs(),
            faults=_parse_replica_faults(args.replica_faults),
        )
        print(f"[loadgen] starting {args.router}-replica fleet "
              f"(shared store: {supervisor.persist_dir})...")
        supervisor.start()
        router_ledger = None
        if args.tracing:
            os.makedirs(args.out_dir, exist_ok=True)
            router_ledger = os.path.join(args.out_dir,
                                         "router_ledger.jsonl")
        router = Router(supervisor.urls, probe_ttl_s=0.1,
                        ledger_path=router_ledger, tracing=args.tracing,
                        incidents=incident_mgr)
        router_server = RouterServer(router).start()
        target = _HttpTarget(router_server.url, args.timeout_s)
        scrape_targets = ([(r.name, r.url) for r in supervisor.replicas]
                          + [("router", router_server.url)])
        meta = {"target": f"router[{args.router}]", "tiny": spec.tiny,
                "steps": args.steps, "scheduler": args.scheduler,
                "replica_faults": list(args.replica_faults)}

        def collect_extra(record, supervisor=supervisor, router=router):
            # the fleet's reliability trail: every replica's fault/breaker
            # events + serve_health (labelled), plus the router's summary —
            # one ledger gates latency AND fleet reliability
            events = []
            for r in supervisor.replicas:
                events += [dict(e) for e in r.engine.fault_log]
                events.append({"event": "serve_health", "label": r.name,
                               **r.engine.health_record()})
                # per-replica chargeback rows, labelled so the cost
                # section keeps replicas distinct ("r0:tenant:A")
                events += [{"event": "cost_attribution", "label": r.name,
                            **row} for row in r.engine.cost_records()]
            record["router"] = router.health_record()
            # the fleet's final /healthz: every replica's status and the
            # probe verdict the router routes by
            record["router_healthz"] = router.healthz()
            events.append({"event": "router_health", **record["router"]})
            return events
    else:
        from videop2p_tpu_torch.serve import EditEngine, FaultPlan

        spec = spec_from_flags()
        faults = FaultPlan.parse(args.faults) if args.faults else None
        engine = EditEngine(spec, out_dir=args.out_dir, faults=faults,
                            programs=programs, **engine_kwargs())
        engine.warm((args.prompt, args.edit_prompt))
        target = _InprocTarget(engine, args.timeout_s)
        meta = {"target": "inproc", "tiny": spec.tiny, "steps": spec.steps,
                "scheduler": args.scheduler, "faults": args.faults}

        def collect_extra(record, engine=engine):
            # the engine's own fault/breaker trail + reliability summary —
            # written into the loadgen ledger so ONE file gates both the
            # latency (TIMING_RULES) and the reliability (FAULT_RULES) —
            # plus the cost plane's chargeback rows (COST_RULES)
            return [dict(e) for e in engine.fault_log] + [
                {"event": "serve_health", **engine.health_record()}
            ] + [{"event": "cost_attribution", "label": "serve", **row}
                 for row in engine.cost_records()]

    if args.collector:
        from videop2p_tpu_torch.serve.collector import FleetCollector

        collector = FleetCollector(
            scrape_targets,
            interval_s=args.scrape_interval_s,
            window_scale=args.window_scale,
            signal_kwargs=dict(
                saturation_threshold=args.saturation_threshold),
            incidents=incident_mgr,
        )
        collector.start()
        meta["collector"] = {"targets": [n for n, _ in scrape_targets],
                             "scrape_interval_s": args.scrape_interval_s,
                             "window_scale": args.window_scale,
                             "saturation_threshold":
                                 args.saturation_threshold}
        print(f"[loadgen] collector scraping {len(scrape_targets)} "
              f"target(s) every {args.scrape_interval_s}s "
              f"(window_scale {args.window_scale})")
        base_collect = collect_extra

        def collect_extra(record, base=base_collect, collector=collector):
            # stop the scrape loop, drain its buffered fleet_signals
            # evaluations + the fleet_series tsdb snapshot into THIS
            # ledger (one file gates latency, reliability AND signals),
            # and fold the signal roll-up into the summary record. Each
            # plane stops before the summaries under it are read, so the
            # fleet's records include the prober's last round
            collector.stop(final_evaluate=True)
            events = list(base(record) or []) if base is not None else []
            events += [{"event": "fleet_signals", **r}
                       for r in collector.history]
            os.makedirs(args.out_dir, exist_ok=True)
            snap = collector.snapshot(
                label="fleet",
                sidecar_path=os.path.join(args.out_dir,
                                          "fleet_series.npz"))
            events.append({"event": "fleet_series", **snap})
            record["signals"] = {**collector.signals.summary(),
                                 **collector.stats()}
            return events

    prober = None
    if args.probes:
        from videop2p_tpu_torch.serve.prober import FleetProber

        # share the collector's tsdb + signal engine when both planes are
        # on: probe_success/probe_latency series land next to the scraped
        # gauges and the fleet_signals evaluations carry the probe burn
        prober = FleetProber(
            scrape_targets, dict(request),
            interval_s=args.probe_interval_s,
            http_timeout_s=args.timeout_s,
            wait_s=args.timeout_s,
            tsdb=collector.tsdb if collector is not None else None,
            signals=collector.signals if collector is not None else None,
            incidents=incident_mgr,
        )
        if args.router:
            # close the loop: the router consumes the prober's verdicts
            # and routes around quarantined wrong-answer replicas
            router.set_probe_status_provider(prober.probe_status)
        # the first round runs before the load (as JAX's acceptance test
        # composes it), so its verdicts are in force while the load flows;
        # the loop's next round is due --probe_interval_s after it
        prober.run_once()
        prober.start()
        meta["probes"] = {"targets": [n for n, _ in scrape_targets],
                          "probe_interval_s": args.probe_interval_s}
        print(f"[loadgen] prober running the known-answer suite against "
              f"{len(scrape_targets)} target(s) every "
              f"{args.probe_interval_s}s")
        base_probe = collect_extra

        def collect_extra(record, base=base_probe, prober=prober):
            # stop the probing loop (one final round if none completed)
            # and drain its probe/probe_audit trail into THIS ledger — the
            # same file then gates correctness via PROBE_RULES
            prober.stop(final_round=True)
            events = list(base(record) or []) if base is not None else []
            events += [{"event": kind, **rec}
                       for kind, rec in prober.history]
            record["probes"] = prober.stats()
            return events

    if incident_mgr is not None:
        base_inc = collect_extra

        def collect_extra(record, base=base_inc, mgr=incident_mgr):
            # last wrapper: runs AFTER the collector drain, so a burn
            # alert fired by the final evaluate still lands here — the
            # incident events go into THIS ledger (INCIDENT_RULES teeth)
            # and the summary names every bundle
            events = list(base(record) or []) if base is not None else []
            events += mgr.records()
            record["incidents"] = mgr.summary()
            return events

    mutate_request = None
    if args.distinct_seeds:
        # closed-loop cold traffic: unique seed per request issue index
        def mutate_request(req, idx):
            return dict(req, seed=idx + 1)

    try:
        record = run_loadgen(
            target, request,
            requests=args.requests, concurrency=args.concurrency,
            ledger_path=args.ledger, meta=meta,
            collect_extra=collect_extra,
            tenants=tenant_weights or None,
            mutate_request=mutate_request,
            tracing=args.tracing,
            slo=args.slo,
        )
    finally:
        if prober is not None:
            prober.stop()  # no-op when drained
        if collector is not None:
            collector.stop(final_evaluate=False)  # no-op when drained
        if router_server is not None:
            router_server.close()
        if supervisor is not None:
            supervisor.stop()
        if engine is not None:
            engine.close()
        if incident_mgr is not None:
            incident_mgr.close()
    print(json.dumps(record, default=str))
    min_rate = args.min_success_rate
    if min_rate is None and chaos:
        min_rate = 0.5  # chaos default: doomed requests expected, most survive
    if min_rate is not None:
        ok = record["success_rate"] >= min_rate
        if not ok:
            print(f"[loadgen] success_rate {record['success_rate']} < "
                  f"required {min_rate}", file=sys.stderr)
        return 0 if ok else 1
    return 1 if record["errors"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
