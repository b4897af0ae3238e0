"""Pull-based fleet scrape loop: serving surfaces → the time-series store
(port of ``videop2p_tpu/serve/collector.py``).

The telemetry plane's ingest half: a
:class:`FleetCollector` polls every replica's and the router's
``/healthz`` + ``/metrics`` on a fixed interval and appends the scraped
gauges/counters into a :class:`~videop2p_tpu_torch.obs.tsdb.TimeSeriesStore`,
where :class:`~videop2p_tpu_torch.obs.signals.SignalEngine` derives the
windowed burn rates, trend slopes and per-tenant demand meters.

Design points:

  * **pull, short timeouts** — scrapes ride the router probe
    pattern: a dedicated fail-fast client per target
    (``probe_timeout_s``), so a replica that accepts connections but
    never answers costs one short timeout per scrape, never wedges the
    loop;
  * **gaps, not interpolation** — a failed scrape records ``up = 0``
    plus an explicit NaN gap in every series that target previously
    produced; window queries downstream skip the hole rather than
    inventing data across an outage;
  * **both formats** — ``fmt="json"`` reads ``/metrics`` directly;
    ``fmt="prometheus"`` reads ``/metrics?format=prometheus`` and maps
    it back through :func:`~videop2p_tpu_torch.obs.prom.parse_prometheus` —
    the round-trip test pins both paths land identical scalars;
  * **injected clocks** — :meth:`scrape_once` takes the timestamp, so
    deterministic tests drive a fake clock; only :meth:`run` touches the
    wall clock.

Stdlib and numpy only, apart from the port's own modules.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.signals import (
    FINISHED_STATUSES,
    S_BUSY_FRACTION,
    S_COST_PER_REQUEST,
    S_DISPATCH_P50,
    S_IN_FLIGHT,
    S_LATENCY_P50,
    S_LATENCY_P99,
    S_PADDING_WASTE,
    S_QUEUE_DEPTH,
    S_QUEUE_WAIT_P99,
    S_REQUESTS,
    S_SCRAPE_ERRORS,
    S_SCRAPES,
    S_STORE_HIT_RATE,
    S_TENANT,
    S_UP,
    SignalEngine,
)
from videop2p_tpu_torch.obs.tsdb import TimeSeriesStore
from videop2p_tpu_torch.serve.client import EngineClient

__all__ = ["FleetCollector", "ingest_engine_metrics", "ingest_prom_samples"]

# tenant counter fields metered per lane (cumulative; rates downstream);
# device_seconds is the measured fair-share attribution counter
_TENANT_COUNTER_FIELDS = ("submitted", "done", "errors", "shed", "rejected",
                          "device_seconds")

# prometheus exposition name → our ingest series (the reverse of the
# render mapping in obs/prom.py for exactly the gauges the collector keeps)
_PROM_MAP = {
    "videop2p_queue_depth": S_QUEUE_DEPTH,
    "videop2p_in_flight": S_IN_FLIGHT,
    "videop2p_request_latency_blocked_p50_s": S_LATENCY_P50,
    "videop2p_request_latency_blocked_p99_s": S_LATENCY_P99,
    "videop2p_store_hit_rate": S_STORE_HIT_RATE,
    # capacity gauges (the generic `capacity` section render)
    "videop2p_capacity_busy_fraction": S_BUSY_FRACTION,
    "videop2p_capacity_padding_waste": S_PADDING_WASTE,
    "videop2p_capacity_cost_per_request_s": S_COST_PER_REQUEST,
}

# the exposition renders ``programs`` as labeled series
# (``videop2p_program_<field>{program=}``), not key-mangled names —
# map the two percentile programs the signals consume back to series
_PROM_PROGRAM_MAP = {
    ("videop2p_program_blocked_p99_s", "serve_queue_wait"): S_QUEUE_WAIT_P99,
    ("videop2p_program_blocked_p50_s", "serve_dispatch"): S_DISPATCH_P50,
}


def _num(value: Any) -> Optional[float]:
    if isinstance(value, bool):
        return 1.0 if value else 0.0
    if isinstance(value, (int, float)):
        return float(value)
    return None


def ingest_engine_metrics(tsdb: TimeSeriesStore, name: str, t: float,
                          metrics: Dict[str, Any]) -> int:
    """One engine ``/metrics`` JSON record → the collector's series set
    (labels ``{"replica": name}``). Returns samples written."""
    labels = {"replica": name}
    wrote = 0
    for key, series in (("queue_depth", S_QUEUE_DEPTH),
                        ("in_flight", S_IN_FLIGHT)):
        v = _num(metrics.get(key))
        if v is not None:
            wrote += tsdb.add(series, t, v, labels)
    req_lat = metrics.get("request_latency")
    if isinstance(req_lat, dict):
        for key, series in (("blocked_p50_s", S_LATENCY_P50),
                            ("blocked_p99_s", S_LATENCY_P99)):
            v = _num(req_lat.get(key))
            if v is not None:
                wrote += tsdb.add(series, t, v, labels)
    programs = metrics.get("programs")
    if isinstance(programs, dict):
        qw = (programs.get("serve_queue_wait") or {})
        dp = (programs.get("serve_dispatch") or {})
        v = _num(qw.get("blocked_p99_s") if isinstance(qw, dict) else None)
        if v is not None:
            wrote += tsdb.add(S_QUEUE_WAIT_P99, t, v, labels)
        v = _num(dp.get("blocked_p50_s") if isinstance(dp, dict) else None)
        if v is not None:
            wrote += tsdb.add(S_DISPATCH_P50, t, v, labels)
    store = metrics.get("store")
    if isinstance(store, dict):
        v = _num(store.get("hit_rate"))
        if v is not None:
            wrote += tsdb.add(S_STORE_HIT_RATE, t, v, labels)
    capacity = metrics.get("capacity")
    if isinstance(capacity, dict):
        # the cost plane's utilization gauges — the prom path
        # lands the same three via _PROM_MAP (round-trip pinned)
        for key, series in (("busy_fraction", S_BUSY_FRACTION),
                            ("padding_waste", S_PADDING_WASTE),
                            ("cost_per_request_s", S_COST_PER_REQUEST)):
            v = _num(capacity.get(key))
            if v is not None:
                wrote += tsdb.add(series, t, v, labels)
    requests = metrics.get("requests")
    if isinstance(requests, dict):
        # zero-fill the terminal statuses: the engine's by-status record
        # only grows a key once some request REACHES that status, so a
        # counter would otherwise be born at its first nonzero value and
        # window `increase()` (first sample = baseline) would never see
        # the 0 -> 1 transition — a one-off error burst becomes invisible
        for status in sorted(set(requests) | set(FINISHED_STATUSES)):
            v = _num(requests.get(status, 0))
            if v is not None:
                wrote += tsdb.add(S_REQUESTS, t, v,
                                  {**labels, "status": str(status)})
    tenants = metrics.get("tenants")
    if isinstance(tenants, dict):
        for tenant in sorted(tenants):
            rec = tenants[tenant]
            if not isinstance(rec, dict):
                continue
            for fld in _TENANT_COUNTER_FIELDS:
                v = _num(rec.get(fld))
                if v is not None:
                    wrote += tsdb.add(S_TENANT, t, v,
                                      {**labels, "tenant": str(tenant),
                                       "field": fld})
    return wrote


def ingest_prom_samples(tsdb: TimeSeriesStore, name: str, t: float,
                        samples: Sequence[Dict[str, Any]]) -> int:
    """Parsed exposition samples → the same series set the JSON path
    writes (the round-trip test pins the equivalence)."""
    labels = {"replica": name}
    wrote = 0
    statuses_seen: set = set()
    for s in samples:
        metric = s.get("name")
        series = _PROM_MAP.get(metric)
        if series is not None:
            wrote += tsdb.add(series, t, s.get("value"), labels)
        elif metric in ("videop2p_program_blocked_p99_s",
                        "videop2p_program_blocked_p50_s"):
            program = (s.get("labels") or {}).get("program")
            series = _PROM_PROGRAM_MAP.get((metric, program))
            if series is not None:
                wrote += tsdb.add(series, t, s.get("value"), labels)
        elif metric == "videop2p_requests_total":
            status = (s.get("labels") or {}).get("status")
            if status is not None:
                statuses_seen.add(str(status))
                wrote += tsdb.add(S_REQUESTS, t, s.get("value"),
                                  {**labels, "status": str(status)})
        elif (metric or "").startswith("videop2p_tenant_"):
            fld = metric[len("videop2p_tenant_"):]
            tenant = (s.get("labels") or {}).get("tenant")
            if tenant is not None and fld in _TENANT_COUNTER_FIELDS:
                wrote += tsdb.add(S_TENANT, t, s.get("value"),
                                  {**labels, "tenant": str(tenant),
                                   "field": fld})
    if statuses_seen:
        # mirror the JSON path's terminal-status zero-fill (an absent
        # status is a 0-valued counter, not a missing series); an
        # exposition with NO requests_total at all (the router's) is a
        # target without the section, so nothing is fabricated for it
        for status in sorted(set(FINISHED_STATUSES) - statuses_seen):
            wrote += tsdb.add(S_REQUESTS, t, 0.0,
                              {**labels, "status": status})
    return wrote


class _Target:
    """One scrape target: a fail-fast probe client + the series this
    target has produced (so an outage records gaps in ALL of them)."""

    def __init__(self, name: str, url: str, probe_timeout_s: float):
        self.name = name
        self.url = url.rstrip("/")
        self.client = EngineClient(url, timeout_s=probe_timeout_s, retries=0)
        self.scrapes = 0
        self.errors = 0
        self.seen: set = set()   # (series_name, labels-items) produced


class FleetCollector:
    """Scrape a fleet into a tsdb and evaluate signals on a cadence."""

    def __init__(
        self,
        targets: Sequence[Tuple[str, str]],
        *,
        tsdb: Optional[TimeSeriesStore] = None,
        capacity: int = 512,
        interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        fmt: str = "json",
        ledger: Any = None,
        router_name: str = "router",
        window_scale: float = 1.0,
        signal_kwargs: Optional[Dict[str, Any]] = None,
        clock: Callable[[], float] = time.perf_counter,
        incidents: Any = None,
    ):
        if fmt not in ("json", "prometheus"):
            raise ValueError(f"fmt must be 'json' or 'prometheus', got {fmt!r}")
        self.targets = [_Target(n, u, probe_timeout_s) for n, u in targets]
        self.tsdb = tsdb if tsdb is not None else TimeSeriesStore(capacity)
        self.interval_s = float(interval_s)
        self.fmt = fmt
        self.ledger = ledger
        self.router_name = str(router_name)
        self.signals = SignalEngine(
            self.tsdb, window_scale=window_scale, router_name=router_name,
            **(signal_kwargs or {}),
        )
        self.clock = clock
        self.scrapes = 0
        self.scrape_errors = 0
        # host wall seconds the scrape passes took (what the plane costs)
        self.scrape_s = 0.0
        # every evaluation record, bounded — loadgen opens its ledger only
        # at end-of-run, so it drains this buffer into `fleet_signals`
        # events instead of passing a live ledger
        self.history: deque = deque(maxlen=4096)
        # per-program reservoir exemplars scraped from target /metrics
        # (`programs` summaries carry p99_trace_id/max_trace_id); pushed
        # into the SignalEngine before every evaluate so burn alerts can
        # NAME a trace, and served to the IncidentManager for bundles
        self._exemplars: Dict[str, Dict[str, Any]] = {}
        self.incidents = incidents
        if incidents is not None:
            # a shared manager: give it our tsdb (bundles snapshot the
            # scrape window) and our targets (bundles re-probe the fleet)
            if getattr(incidents, "tsdb", None) is None:
                incidents.tsdb = self.tsdb
            for tgt in self.targets:
                incidents.register_target(
                    f"scrape:{tgt.name}",
                    (lambda c: lambda: {"healthz": c.healthz(),
                                        "metrics": c.metrics()})(tgt.client))
            incidents.register_exemplars(lambda: dict(self._exemplars))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- one pass --------------------------------------------------------

    def _record_gaps(self, target: _Target, t: float) -> None:
        for series_name, items in sorted(target.seen):
            self.tsdb.gap(series_name, t, dict(items))

    def _track_seen(self, target: _Target) -> None:
        for name, items in self.tsdb.keys():
            if name in (S_UP, S_SCRAPES, S_SCRAPE_ERRORS):
                continue
            if dict(items).get("replica") == target.name:
                target.seen.add((name, items))

    def scrape_target(self, target: _Target, t: float) -> bool:
        """One target at time ``t``: healthz + metrics into the tsdb.
        False (and a recorded gap) when the target is unreachable."""
        target.scrapes += 1
        try:
            health = target.client.healthz()
        except Exception:  # noqa: BLE001 — down IS the datum
            target.errors += 1
            self.scrape_errors += 1
            self.tsdb.add(S_UP, t, 0.0, {"replica": target.name})
            self._record_gaps(target, t)
            self._meta(target, t)
            return False
        up = 1.0 if health.get("ok") else 0.0
        self.tsdb.add(S_UP, t, up, {"replica": target.name})
        try:
            if self.fmt == "prometheus":
                from videop2p_tpu_torch.obs.prom import parse_prometheus

                text = target.client.metrics_prometheus()
                ingest_prom_samples(self.tsdb, target.name, t,
                                    parse_prometheus(text)["samples"])
            else:
                metrics = target.client.metrics()
                ingest_engine_metrics(self.tsdb, target.name, t, metrics)
                self._cache_exemplars(metrics)
        except Exception:  # noqa: BLE001 — half-up: healthz ok, metrics not
            target.errors += 1
            self.scrape_errors += 1
            self._record_gaps(target, t)
            self._meta(target, t)
            return False
        self._track_seen(target)
        self._meta(target, t)
        return True

    def _meta(self, target: _Target, t: float) -> None:
        """The collector's own health as first-class series: signals
        compute scrape_error_rate from these like any other counter."""
        self.tsdb.add(S_SCRAPES, t, target.scrapes,
                      {"replica": target.name})
        self.tsdb.add(S_SCRAPE_ERRORS, t, target.errors,
                      {"replica": target.name})

    def scrape_once(self, now: Optional[float] = None) -> int:
        """Scrape every target once at time ``now``; returns how many
        answered. Timestamps within the pass get a tiny per-target skew
        so every series stays strictly monotonic even at one shared
        ``now``."""
        t = self.clock() if now is None else float(now)
        t0 = time.perf_counter()
        ok = 0
        for i, target in enumerate(self.targets):
            ok += bool(self.scrape_target(target, t + i * 1e-6))
        self.scrapes += 1
        self.scrape_s += time.perf_counter() - t0
        return ok

    def _cache_exemplars(self, metrics: Dict[str, Any]) -> None:
        """Keep the freshest per-program trace-id exemplars seen on any
        target's ``programs`` reservoir summaries (JSON scrape only — the
        Prometheus exposition carries no trace ids)."""
        try:
            programs = metrics.get("programs") or {}
            for program, summary in programs.items():
                p99 = summary.get("p99_trace_id")
                mx = summary.get("max_trace_id")
                if p99 is not None or mx is not None:
                    self._exemplars[str(program)] = {
                        "p99_trace_id": p99, "max_trace_id": mx}
        except Exception:  # noqa: BLE001 — exemplars are best-effort
            pass

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One signal pass (emits ``fleet_signals`` into the ledger).
        Burn alerts also fire the incident trigger when a manager is
        attached — the page and the evidence capture are one motion."""
        t = self.clock() if now is None else float(now)
        self.signals.set_exemplars(self._exemplars)
        rec = self.signals.evaluate(t, ledger=self.ledger)
        self.history.append(rec)
        if rec.get("burn_alert") and self.incidents is not None:
            self.incidents.trigger(
                "burn_alert",
                detail="; ".join(str(r) for r in (rec.get("reasons") or [])),
                scale_advice=rec.get("scale_advice"))
        return rec

    # ---- the loop --------------------------------------------------------

    def run(self, *, duration_s: Optional[float] = None,
            evaluate_every: int = 1) -> None:
        """Scrape/evaluate until :meth:`stop` (or ``duration_s``)."""
        deadline = (self.clock() + float(duration_s)
                    if duration_s is not None else None)
        passes = 0
        while not self._stop.is_set():
            self.scrape_once()
            passes += 1
            if evaluate_every and passes % evaluate_every == 0:
                self.evaluate()
            if deadline is not None and self.clock() >= deadline:
                break
            self._stop.wait(self.interval_s)

    def start(self, *, evaluate_every: int = 1) -> "FleetCollector":
        """The loop on a daemon thread (loadgen rides alongside)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, kwargs={"evaluate_every": evaluate_every},
            name="fleet-collector", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, *, final_evaluate: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if final_evaluate and self.scrapes:
            self.evaluate()

    def snapshot(self, *, label: str = "fleet",
                 sidecar_path: Optional[str] = None) -> Dict[str, Any]:
        """Persist the store (one ``fleet_series`` event + sidecar)."""
        return self.tsdb.snapshot(self.ledger, label=label,
                                  sidecar_path=sidecar_path)

    def stats(self) -> Dict[str, Any]:
        return {
            "targets": len(self.targets),
            "scrapes": self.scrapes,
            "scrape_errors": self.scrape_errors,
            "scrape_s": round(self.scrape_s, 6),
            "series": len(self.tsdb),
            "samples": self.tsdb.samples,
            "gaps": self.tsdb.gaps,
            "dropped": self.tsdb.dropped,
        }
