"""Derived fleet signals over the scraped time-series store (port of
``videop2p_tpu/obs/signals.py``).

``serve/collector.py`` lands raw gauges/counters in a
:class:`~videop2p_tpu_torch.obs.tsdb.TimeSeriesStore`; this module turns the
trailing buffers into the signals an autoscaler or an on-call
human actually acts on:

  * **multi-window multi-burn-rate SLO alerts** — the SRE page/ticket
    split: the availability error-rate is measured over a FAST
    (5-minute-equivalent) and a SLOW (1-hour-equivalent) trailing
    window, each divided by the SLO target into a burn rate, and the
    alert fires only when BOTH windows burn above threshold. The fast
    window alone is noisy (one bad scrape pages nobody), the slow window
    alone is sluggish (an outage takes an hour to page); requiring both
    gives fast detection that auto-resolves when the error stops. A
    ``window_scale`` knob shrinks both windows proportionally so tests
    (and CPU loadgen runs) exercise the real code path in seconds.
  * **trend slopes** — robust Theil–Sen (median of pairwise slopes, so
    one outlier scrape cannot fake a trend) over queue depth and
    in-flight, summed across replicas: the fleet's backlog growth rate.
  * **replica saturation** — the worst replica's queue-wait p99 over its
    dispatch p50: "how many dispatches deep is the queue" in time units;
    the classic rho > 1 saturation smell scaled to observed service time.
  * **per-tenant demand metering** — submitted/served/shed rates per
    tenant lane over the slow window plus device-seconds: the MEASURED
    fair-share attributed counter scraped from the cost plane when a target exposes it, else the estimate (served increase x
    the fleet dispatch p50) pre-cost-plane fleets always had.
  * **utilization & headroom economics** — replica
    busy-fraction/padding-waste/cost-per-request from the scraped
    ``capacity`` section become fleet utilization, idle fraction, a
    Theil–Sen utilization forecast one slow window out, and demand vs
    measured dispatch capacity (headroom in requests/s); scale advice
    gains economic reasons (shrink-is-cheap when idle, priced holds).
    Everything is None — and the advice identical to a fleet without
    one — when no target exposes the cost plane.
  * **EWMA anomaly flags** — exponentially-weighted mean/variance per
    watched headline (latency p99 up, store hit-rate down); a flag is a
    deviation beyond ``tolerance`` sigmas with an absolute floor.

Every evaluation emits one ``fleet_signals`` ledger event
(``FLEET_SIGNALS_FIELDS``) with machine-readable ``scale_advice`` in
{grow, hold, shrink} + human-readable ``reasons`` — obs/history.py's
``SIGNAL_RULES`` gate these records across runs like every other layer.

Stdlib and numpy only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from videop2p_tpu_torch.obs.tsdb import TimeSeriesStore

__all__ = [
    "FLEET_SIGNALS_FIELDS",
    "SignalEngine",
    "theil_sen_slope",
    "S_UP",
    "S_QUEUE_DEPTH",
    "S_IN_FLIGHT",
    "S_REQUESTS",
    "S_LATENCY_P50",
    "S_LATENCY_P99",
    "S_QUEUE_WAIT_P99",
    "S_DISPATCH_P50",
    "S_STORE_HIT_RATE",
    "S_SCRAPES",
    "S_SCRAPE_ERRORS",
    "S_TENANT",
    "S_BUSY_FRACTION",
    "S_PADDING_WASTE",
    "S_COST_PER_REQUEST",
    "S_PROBE_SUCCESS",
    "S_PROBE_LATENCY",
]

# ---- the series-name contract between collector and signals --------------
# (the collector writes these; the signal engine reads them — one place)

S_UP = "up"                         # 1/0 liveness, labels {replica}
S_QUEUE_DEPTH = "queue_depth"       # gauge, labels {replica}
S_IN_FLIGHT = "in_flight"           # gauge, labels {replica}
S_REQUESTS = "requests_total"       # cumulative, labels {replica, status}
S_LATENCY_P50 = "latency_p50_s"     # e2e blocked p50, labels {replica}
S_LATENCY_P99 = "latency_p99_s"     # e2e blocked p99, labels {replica}
S_QUEUE_WAIT_P99 = "queue_wait_p99_s"   # labels {replica}
S_DISPATCH_P50 = "dispatch_p50_s"       # labels {replica}
S_STORE_HIT_RATE = "store_hit_rate"     # labels {replica}
S_SCRAPES = "scrapes_total"             # cumulative, labels {replica}
S_SCRAPE_ERRORS = "scrape_errors_total"  # cumulative, labels {replica}
S_TENANT = "tenant_total"   # cumulative, labels {replica, tenant, field}
# cost/capacity gauges scraped from /metrics `capacity`
S_BUSY_FRACTION = "busy_fraction"           # 0..1 gauge, labels {replica}
S_PADDING_WASTE = "padding_waste"           # gauge, labels {replica}
S_COST_PER_REQUEST = "cost_per_request_s"   # gauge, labels {replica}
# correctness plane: the prober writes one 1/0 sample per
# known-answer probe run plus its wall latency, labels {target, probe}
S_PROBE_SUCCESS = "probe_success"           # 1/0, labels {target, probe}
S_PROBE_LATENCY = "probe_latency"           # seconds, labels {target, probe}

# request statuses that mean "the engine failed the request" vs finished
ERROR_STATUSES = ("error", "deadline_exceeded")
FINISHED_STATUSES = ("done", "error", "deadline_exceeded", "engine_closed")

# the `fleet_signals` ledger event schema (pinned by test_bench_guard)
FLEET_SIGNALS_FIELDS = (
    "label",
    "t",
    "window_scale",
    "fast_window_s",
    "slow_window_s",
    "error_rate_fast",
    "error_rate_slow",
    "burn_fast",
    "burn_slow",
    "burn_alert",
    "burn_alerts",
    "queue_slope",
    "inflight_slope",
    "saturation",
    "latency_p99_s",
    "store_hit_rate",
    "latency_anomaly",
    "store_hit_anomaly",
    "scrape_errors",
    "scrape_error_rate",
    "replicas_up",
    "replicas_total",
    "tenants",
    # reservoir trace-id exemplars: per program,
    # the scraped p99_trace_id/max_trace_id — an alert NAMES the traces
    # that burned the budget even outside an incident bundle. Always
    # present; {} when no target exposes exemplars (tracing off).
    "exemplars",
    # utilization/headroom economics: all None when no target
    # exposes the cost plane's `capacity` section — pre-cost fleets keep
    # the advice of a fleet without one.
    "utilization",
    "idle_fraction",
    "padding_waste",
    "cost_per_request_s",
    "demand_rps",
    "capacity_rps",
    "headroom_rps",
    "utilization_slope",
    "utilization_forecast",
    # correctness plane: known-answer probe health measured
    # from the prober's series + the audit's quarantine verdicts pushed
    # through :meth:`SignalEngine.set_probe_status`. success_rate is
    # None and quarantined [] when no prober runs — probe-off fleets
    # evaluate exactly as before.
    "probe_success_rate",
    "probe_failures",
    "probe_divergences",
    "quarantined",
    "scale_advice",
    "reasons",
)

# per-tenant demand sub-record schema (the "demand metering" columns)
FLEET_TENANT_FIELDS = (
    "submitted_rate", "served_rate", "shed_rate", "device_seconds",
)


def theil_sen_slope(points: Sequence[Tuple[float, float]],
                    max_points: int = 100) -> float:
    """Median of pairwise slopes — the robust trend estimator (up to 29%
    arbitrary outliers cannot move it). 0.0 with < 2 usable points."""
    pts = list(points)[-max_points:]
    if len(pts) < 2:
        return 0.0
    ts = np.asarray([t for t, _ in pts], np.float64)
    vs = np.asarray([v for _, v in pts], np.float64)
    dt = np.subtract.outer(ts, ts)
    dv = np.subtract.outer(vs, vs)
    mask = dt > 0
    if not mask.any():
        return 0.0
    return float(np.median(dv[mask] / dt[mask]))


class _Ewma:
    """Exponentially-weighted mean + variance with a deviation flag."""

    def __init__(self, alpha: float, tolerance: float, floor: float):
        self.alpha = float(alpha)
        self.tolerance = float(tolerance)
        self.floor = float(floor)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.count = 0

    def observe(self, x: float, direction: str = "increase") -> bool:
        """Flag-then-update: is ``x`` anomalous vs the state BEFORE it?"""
        anomalous = False
        if self.mean is not None and self.count >= 3:
            dev = x - self.mean
            band = self.tolerance * math.sqrt(self.var) + self.floor
            if direction == "increase":
                anomalous = dev > band
            else:
                anomalous = -dev > band
        if self.mean is None:
            self.mean = float(x)
        else:
            delta = float(x) - self.mean
            self.mean += self.alpha * delta
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.count += 1
        return anomalous


class SignalEngine:
    """Stateful evaluator: call :meth:`evaluate` on a cadence; each call
    reads the trailing windows out of the tsdb and emits one
    ``fleet_signals`` event. EWMA baselines and the cumulative burn-alert
    count live here (the tsdb stays a dumb buffer)."""

    def __init__(
        self,
        tsdb: TimeSeriesStore,
        *,
        label: str = "fleet",
        window_scale: float = 1.0,
        slo_error_rate: float = 0.01,
        burn_threshold: float = 1.0,
        saturation_threshold: float = 5.0,
        queue_slope_threshold: float = 0.05,
        ewma_alpha: float = 0.3,
        ewma_tolerance: float = 3.0,
        router_name: str = "router",
    ):
        self.tsdb = tsdb
        self.label = str(label)
        self.window_scale = float(window_scale)
        self.fast_window_s = 300.0 * self.window_scale
        self.slow_window_s = 3600.0 * self.window_scale
        self.slo_error_rate = float(slo_error_rate)
        self.burn_threshold = float(burn_threshold)
        self.saturation_threshold = float(saturation_threshold)
        self.queue_slope_threshold = float(queue_slope_threshold)
        self.router_name = str(router_name)
        self.burn_alerts = 0
        self.evaluations = 0
        self.advice_counts: Dict[str, int] = {"grow": 0, "hold": 0,
                                              "shrink": 0}
        self._lat_ewma = _Ewma(ewma_alpha, ewma_tolerance, floor=0.005)
        self._hit_ewma = _Ewma(ewma_alpha, ewma_tolerance, floor=0.05)
        # latest scraped per-program trace-id exemplars: the collector
        # pushes them from each target's
        # /metrics `programs` reservoirs; the tsdb stays scalar-only
        self._exemplars: Dict[str, Dict[str, Optional[str]]] = {}
        # correctness plane: the prober's pushed per-target
        # verdicts and audit divergences — names/hashes don't fit the
        # scalar tsdb, so they ride a side channel like the exemplars
        self._probe_status: Dict[str, str] = {}
        self._probe_divergences: List[Dict[str, Any]] = []

    def set_exemplars(
            self, exemplars: Dict[str, Dict[str, Optional[str]]]) -> None:
        """Replace the current per-program ``{p99_trace_id,
        max_trace_id}`` exemplar map (best-effort side channel — trace-id
        strings don't fit the scalar tsdb)."""
        self._exemplars = {
            str(k): {"p99_trace_id": (v or {}).get("p99_trace_id"),
                     "max_trace_id": (v or {}).get("max_trace_id")}
            for k, v in (exemplars or {}).items()
        }

    def set_probe_status(self, status: Dict[str, str],
                         divergences: Sequence[Dict[str, Any]] = ()) -> None:
        """The prober's push channel: per-target probe
        verdicts (``pass``/``fail``/``quarantine``) and the answer
        audit's divergence records, so a quarantine recommendation can
        NAME the divergent replica and both hashes."""
        self._probe_status = {str(k): str(v)
                              for k, v in (status or {}).items()}
        self._probe_divergences = [dict(d) for d in (divergences or ())]

    def _exemplar_hint(self) -> Optional[str]:
        """One offending trace id for the advice reasons — the dispatch
        program's p99 exemplar when present, else any program's."""
        items = sorted(self._exemplars.items(),
                       key=lambda kv: (0 if "dispatch" in kv[0] else 1,
                                       kv[0]))
        for program, ex in items:
            tid = ex.get("p99_trace_id") or ex.get("max_trace_id")
            if tid:
                return f"{program} p99_trace={tid}"
        return None

    # ---- pieces ----------------------------------------------------------

    def _replica_labels(self) -> List[Dict[str, str]]:
        return [ls for ls in self.tsdb.labelsets(S_UP)
                if ls.get("replica") != self.router_name]

    def _error_rate(self, now: float, window_s: float) -> Optional[float]:
        """Fleet error fraction over one window: failed finishes over all
        finishes, summed across replicas (router excluded — its per-status
        counts are the replicas' re-aggregated)."""
        errors = 0.0
        finished = 0.0
        seen = False
        for ls in self.tsdb.labelsets(S_REQUESTS):
            if ls.get("replica") == self.router_name:
                continue
            status = ls.get("status")
            if status not in FINISHED_STATUSES:
                continue
            inc = self.tsdb.increase(S_REQUESTS, now, window_s, ls)
            if inc is None:
                continue
            seen = True
            finished += inc
            if status in ERROR_STATUSES:
                errors += inc
        if not seen:
            return None
        if finished <= 0:
            return 0.0
        return errors / finished

    def _fleet_slope(self, name: str, now: float, window_s: float) -> float:
        return sum(
            theil_sen_slope(self.tsdb.window(name, now, window_s, ls))
            for ls in self.tsdb.labelsets(name)
            if ls.get("replica") != self.router_name
        )

    def _saturation(self, now: float) -> float:
        """max over replicas of queue-wait p99 / dispatch p50 (both from
        the scraped reservoir summaries; 0.0 until both exist)."""
        worst = 0.0
        for ls in self._replica_labels():
            rl = {"replica": ls.get("replica")}
            qw = self.tsdb.latest(S_QUEUE_WAIT_P99, rl)
            dp = self.tsdb.latest(S_DISPATCH_P50, rl)
            if qw is None or dp is None or dp[1] <= 0.0:
                continue
            worst = max(worst, qw[1] / dp[1])
        return worst

    def _tenant_demand(self, now: float,
                       dispatch_p50: Optional[float]) -> Dict[str, Any]:
        """Per-lane submitted/served/shed rates over the slow window plus
        device-seconds: the MEASURED fair-share counter when the series
        exists, else the pre-cost-plane estimate
        (served increase x dispatch p50)."""
        lanes: Dict[str, Dict[str, float]] = {}
        sums: Dict[str, Dict[str, float]] = {}
        for ls in self.tsdb.labelsets(S_TENANT):
            tenant = ls.get("tenant")
            fld = ls.get("field")
            if tenant is None or fld is None:
                continue
            inc = self.tsdb.increase(S_TENANT, now, self.slow_window_s, ls)
            rate = self.tsdb.rate(S_TENANT, now, self.slow_window_s, ls)
            if inc is None or rate is None:
                continue
            acc = sums.setdefault(tenant, {})
            acc[f"{fld}_inc"] = acc.get(f"{fld}_inc", 0.0) + inc
            acc[f"{fld}_rate"] = acc.get(f"{fld}_rate", 0.0) + rate
        for tenant, acc in sorted(sums.items()):
            served_inc = acc.get("done_inc", 0.0)
            if "device_seconds_inc" in acc:
                # measured plane: attributed device-seconds counter
                device_s = acc["device_seconds_inc"]
            else:
                device_s = served_inc * (dispatch_p50 or 0.0)
            lanes[tenant] = {
                "submitted_rate": round(acc.get("submitted_rate", 0.0), 6),
                "served_rate": round(acc.get("done_rate", 0.0), 6),
                "shed_rate": round(acc.get("shed_rate", 0.0)
                                   + acc.get("rejected_rate", 0.0), 6),
                "device_seconds": round(device_s, 6),
            }
        return lanes

    def _capacity_signals(self, now: float,
                          demand_rps: float) -> Dict[str, Any]:
        """Utilization/headroom economics from the scraped
        cost-plane gauges: fleet utilization is the mean replica
        busy-fraction, capacity is what the up replicas could absorb at
        the observed per-request device cost, and the forecast projects
        a Theil–Sen utilization trend one slow window out. Every value
        is None when no target exposes the ``capacity`` section, so
        pre-cost-plane fleets evaluate exactly as before."""
        busy_vals: List[float] = []
        waste_vals: List[float] = []
        cpr_vals: List[float] = []
        for ls in self._replica_labels():
            rl = {"replica": ls.get("replica")}
            b = self.tsdb.latest(S_BUSY_FRACTION, rl)
            if b is not None:
                busy_vals.append(b[1])
            w = self.tsdb.latest(S_PADDING_WASTE, rl)
            if w is not None:
                waste_vals.append(w[1])
            c = self.tsdb.latest(S_COST_PER_REQUEST, rl)
            if c is not None and c[1] > 0.0:
                cpr_vals.append(c[1])
        out: Dict[str, Any] = {
            "utilization": None, "idle_fraction": None,
            "padding_waste": None, "cost_per_request_s": None,
            "demand_rps": round(demand_rps, 6), "capacity_rps": None,
            "headroom_rps": None, "utilization_slope": None,
            "utilization_forecast": None,
        }
        if not busy_vals:
            return out
        utilization = sum(busy_vals) / len(busy_vals)
        out["utilization"] = round(utilization, 6)
        out["idle_fraction"] = round(max(0.0, 1.0 - utilization), 6)
        if waste_vals:
            out["padding_waste"] = round(
                sum(waste_vals) / len(waste_vals), 6)
        cpr = (sum(cpr_vals) / len(cpr_vals)) if cpr_vals else None
        if cpr is not None:
            out["cost_per_request_s"] = round(cpr, 6)
            capacity_rps = len(busy_vals) / cpr
            out["capacity_rps"] = round(capacity_rps, 6)
            out["headroom_rps"] = round(capacity_rps - demand_rps, 6)
        slope = (self._fleet_slope(S_BUSY_FRACTION, now, self.slow_window_s)
                 / max(len(busy_vals), 1))
        out["utilization_slope"] = round(slope, 8)
        out["utilization_forecast"] = round(
            min(1.0, max(0.0, utilization + slope * self.slow_window_s)), 6)
        return out

    def _scrape_stats(self, now: float) -> Tuple[float, float]:
        scrapes = errors = 0.0
        for ls in self.tsdb.labelsets(S_SCRAPES):
            latest = self.tsdb.latest(S_SCRAPES, ls)
            if latest is not None:
                scrapes += latest[1]
        for ls in self.tsdb.labelsets(S_SCRAPE_ERRORS):
            latest = self.tsdb.latest(S_SCRAPE_ERRORS, ls)
            if latest is not None:
                errors += latest[1]
        rate = errors / scrapes if scrapes > 0 else 0.0
        return errors, rate

    # ---- the evaluation --------------------------------------------------

    def evaluate(self, now: float, ledger: Any = None) -> Dict[str, Any]:
        """One signal pass at time ``now`` → the ``fleet_signals`` record
        (emitted into ``ledger`` when given)."""
        t = float(now)
        er_fast = self._error_rate(t, self.fast_window_s)
        er_slow = self._error_rate(t, self.slow_window_s)
        burn_fast = ((er_fast / self.slo_error_rate)
                     if er_fast is not None and self.slo_error_rate > 0
                     else 0.0)
        burn_slow = ((er_slow / self.slo_error_rate)
                     if er_slow is not None and self.slo_error_rate > 0
                     else 0.0)
        burn_alert = (burn_fast > self.burn_threshold
                      and burn_slow > self.burn_threshold)
        if burn_alert:
            self.burn_alerts += 1

        queue_slope = self._fleet_slope(S_QUEUE_DEPTH, t, self.slow_window_s)
        inflight_slope = self._fleet_slope(S_IN_FLIGHT, t, self.slow_window_s)
        saturation = self._saturation(t)

        # fleet headline gauges: worst replica latency p99, mean hit rate
        lat_vals = [self.tsdb.latest(S_LATENCY_P99, ls)
                    for ls in self._replica_labels()]
        lat_vals = [v[1] for v in lat_vals if v is not None]
        latency_p99 = max(lat_vals) if lat_vals else None
        hit_vals = [self.tsdb.latest(S_STORE_HIT_RATE, ls)
                    for ls in self._replica_labels()]
        hit_vals = [v[1] for v in hit_vals if v is not None]
        hit_rate = (sum(hit_vals) / len(hit_vals)) if hit_vals else None
        latency_anomaly = (self._lat_ewma.observe(latency_p99, "increase")
                           if latency_p99 is not None else False)
        store_hit_anomaly = (self._hit_ewma.observe(hit_rate, "decrease")
                             if hit_rate is not None else False)

        replica_ls = self._replica_labels()
        replicas_total = len(replica_ls)
        replicas_up = 0
        for ls in replica_ls:
            latest = self.tsdb.latest(S_UP, ls)
            # a latest of None means every sample was a gap — down
            if latest is not None and latest[1] >= 1.0:
                # gaps AFTER the last finite sample also mean down NOW
                ring = self.tsdb.series(S_UP, ls)
                if ring and not math.isnan(ring[-1][1]) and ring[-1][1] >= 1.0:
                    replicas_up += 1
        scrape_errors, scrape_error_rate = self._scrape_stats(t)

        dp_vals = [self.tsdb.latest(S_DISPATCH_P50, ls)
                   for ls in self._replica_labels()]
        dp_vals = [v[1] for v in dp_vals if v is not None]
        dispatch_p50 = (sum(dp_vals) / len(dp_vals)) if dp_vals else None
        tenants = self._tenant_demand(t, dispatch_p50)
        demand_rps = sum(lane.get("submitted_rate", 0.0)
                         for lane in tenants.values())
        economics = self._capacity_signals(t, demand_rps)

        # correctness plane: probe success over the slow
        # window across every (target, probe) series the prober wrote —
        # no prober means no series and None, the probe-off baseline
        probe_vals: List[float] = []
        for ls in self.tsdb.labelsets(S_PROBE_SUCCESS):
            probe_vals.extend(
                v for _, v in self.tsdb.window(
                    S_PROBE_SUCCESS, t, self.slow_window_s, ls)
                if not math.isnan(v))
        probe_success_rate = ((sum(probe_vals) / len(probe_vals))
                              if probe_vals else None)
        probe_failures = sum(1 for v in probe_vals if v < 1.0)
        quarantined = sorted(k for k, v in self._probe_status.items()
                             if v == "quarantine")

        # ---- scale advice ------------------------------------------------
        reasons: List[str] = []
        exemplar_hint = self._exemplar_hint()
        if burn_alert:
            reasons.append(
                f"slo-burn fast={burn_fast:.2f} slow={burn_slow:.2f} "
                f"(threshold {self.burn_threshold:g})"
                + (f"; exemplar {exemplar_hint}" if exemplar_hint else ""))
        if saturation > self.saturation_threshold:
            reasons.append(
                f"saturation {saturation:.2f} > "
                f"{self.saturation_threshold:g}"
                + (f"; exemplar {exemplar_hint}" if exemplar_hint else ""))
        if queue_slope > self.queue_slope_threshold:
            qmeans = [self.tsdb.mean(S_QUEUE_DEPTH, t, self.slow_window_s, ls)
                      for ls in self.tsdb.labelsets(S_QUEUE_DEPTH)]
            if any((q or 0.0) > 0.0 for q in qmeans):
                reasons.append(f"queue growing {queue_slope:.3f}/s")
        if replicas_total and replicas_up < replicas_total:
            reasons.append(
                f"replicas down {replicas_total - replicas_up}/"
                f"{replicas_total}")
        # probe-failure burn + the quarantine recommendation:
        # a wrong-but-healthy replica is lost capacity the liveness
        # signals cannot see — name it, with both hashes
        if probe_failures:
            reasons.append(
                f"probe failures {probe_failures}"
                + (f" (success_rate {probe_success_rate:.2f})"
                   if probe_success_rate is not None else ""))
        for name in quarantined:
            d = next((d for d in self._probe_divergences
                      if d.get("divergent") == name), None)
            reasons.append(
                f"quarantine {name}: answer diverges from fleet"
                + (f" ({str(d.get('hash_b', ''))[:12]} != "
                   f"{str(d.get('hash_a', ''))[:12]} vs "
                   f"{d.get('replica_a')})" if d else ""))
        if reasons:
            advice = "grow"
        else:
            idle = bool(replica_ls)
            for ls in replica_ls:
                rl = {"replica": ls.get("replica")}
                q = self.tsdb.window(S_QUEUE_DEPTH, t, self.slow_window_s, rl)
                f = self.tsdb.window(S_IN_FLIGHT, t, self.slow_window_s, rl)
                if len(q) < 2 or len(f) < 2:
                    idle = False
                    break
                if max(v for _, v in q) > 0 or max(v for _, v in f) > 0:
                    idle = False
                    break
            if idle:
                advice = "shrink"
                reasons.append("fleet idle over the slow window")
            else:
                advice = "hold"
        # economic reasons: when the cost plane is scraped,
        # every piece of advice is PRICED — shrink cites the idle
        # fraction it reclaims, grow cites the utilization forecast, and
        # hold carries the utilization/cost annotation the showback and
        # the loadgen acceptance read. Absent cost plane: no change.
        util = economics.get("utilization")
        if util is not None:
            idle_f = economics.get("idle_fraction") or 0.0
            cpr = economics.get("cost_per_request_s")
            cpr_part = (f", cost_per_request {cpr:.4f}s"
                        if cpr is not None else "")
            if advice == "shrink":
                reasons.append(
                    f"shrink-is-cheap: idle_fraction {idle_f:.2f}"
                    + cpr_part)
            elif advice == "grow":
                fc = economics.get("utilization_forecast")
                reasons.append(
                    f"economics: utilization {util:.2f}"
                    + (f", forecast {fc:.2f}" if fc is not None else "")
                    + cpr_part)
            else:
                head = economics.get("headroom_rps")
                reasons.append(
                    f"economics: utilization {util:.2f}, "
                    f"idle_fraction {idle_f:.2f}" + cpr_part
                    + (f", headroom {head:.2f} rps"
                       if head is not None else ""))
        self.evaluations += 1
        self.advice_counts[advice] = self.advice_counts.get(advice, 0) + 1

        rec: Dict[str, Any] = {
            "label": self.label,
            "t": round(t, 6),
            "window_scale": self.window_scale,
            "fast_window_s": round(self.fast_window_s, 6),
            "slow_window_s": round(self.slow_window_s, 6),
            "error_rate_fast": (round(er_fast, 6)
                                if er_fast is not None else None),
            "error_rate_slow": (round(er_slow, 6)
                                if er_slow is not None else None),
            "burn_fast": round(burn_fast, 4),
            "burn_slow": round(burn_slow, 4),
            "burn_alert": burn_alert,
            "burn_alerts": self.burn_alerts,
            "queue_slope": round(queue_slope, 6),
            "inflight_slope": round(inflight_slope, 6),
            "saturation": round(saturation, 4),
            "latency_p99_s": (round(latency_p99, 6)
                              if latency_p99 is not None else None),
            "store_hit_rate": (round(hit_rate, 4)
                               if hit_rate is not None else None),
            "latency_anomaly": latency_anomaly,
            "store_hit_anomaly": store_hit_anomaly,
            "scrape_errors": scrape_errors,
            "scrape_error_rate": round(scrape_error_rate, 6),
            "replicas_up": replicas_up,
            "replicas_total": replicas_total,
            "tenants": tenants,
            "exemplars": {k: dict(v) for k, v in
                          sorted(self._exemplars.items())},
            "utilization": economics["utilization"],
            "idle_fraction": economics["idle_fraction"],
            "padding_waste": economics["padding_waste"],
            "cost_per_request_s": economics["cost_per_request_s"],
            "demand_rps": economics["demand_rps"],
            "capacity_rps": economics["capacity_rps"],
            "headroom_rps": economics["headroom_rps"],
            "utilization_slope": economics["utilization_slope"],
            "utilization_forecast": economics["utilization_forecast"],
            "probe_success_rate": (round(probe_success_rate, 4)
                                   if probe_success_rate is not None
                                   else None),
            "probe_failures": probe_failures,
            "probe_divergences": len(self._probe_divergences),
            "quarantined": quarantined,
            "scale_advice": advice,
            "reasons": reasons,
        }
        if ledger is not None:
            ledger.event("fleet_signals", **rec)
        return rec

    def summary(self) -> Dict[str, Any]:
        """The end-of-run roll-up the loadgen records: how often each
        advice fired and how many evaluations burned."""
        return {
            "evaluations": self.evaluations,
            "burn_alerts": self.burn_alerts,
            "advice": dict(self.advice_counts),
        }
