"""RunHistory: a cross-run regression engine over run-ledger JSONL files
(port of ``videop2p_tpu/obs/history.py``, stdlib only apart from the ledger
reader).

  * :func:`split_runs` / :func:`extract_run` — a ledger file (which appends
    across invocations, so one file can hold many runs) becomes a list of
    flat per-run records: per-program analysis metrics, per-phase wall
    time, per-program compile and dispatch seconds, and the sections the
    later planes add (quality, timing, reliability, streams, SLOs, spans,
    signals, incidents, costs, probes);
  * :class:`RunHistory` — scans a directory of ledgers, orders runs in
    time, and keys metric series by ``(program_label, hlo_fingerprint)``;
  * :class:`RegressionRule` / :func:`evaluate_rules` — declarative
    thresholds evaluated into machine-readable verdicts, grouped in the
    rule packs below (``DEFAULT_RULES`` holds them all).

Either package's ledgers read here: the event names and fields are the
JAX package's. The port's ``program_analysis`` events (``obs/introspect.py``:
each instrumented program's first call, analysed as it runs) carry JAX's
fields, so the ``program`` rules key them by ``(label, hlo_fingerprint)``
as they do XLA's; ``COMM_RULES`` is in ``DEFAULT_RULES`` as in JAX, and
finds nothing until multi-GPU runs write collective records.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.ledger import read_ledger
from videop2p_tpu_torch.obs.spans import SPAN_SEGMENTS
from videop2p_tpu_torch.obs.timing import percentile

__all__ = [
    "PROGRAM_METRICS",
    "RegressionRule",
    "DEFAULT_RULES",
    "QUALITY_RULES",
    "COMM_RULES",
    "TIMING_RULES",
    "FAULT_RULES",
    "SEAM_RULES",
    "SLO_RULES",
    "SEGMENT_RULES",
    "SIGNAL_RULES",
    "INCIDENT_RULES",
    "COST_RULES",
    "PROBE_RULES",
    "split_runs",
    "extract_run",
    "evaluate_rules",
    "RunHistory",
]


# the numeric metric keys of a program_analysis record (obs/introspect.py,
# the JAX package's names; the program rules reference them)
PROGRAM_METRICS = (
    "flops",
    "transcendentals",
    "bytes_accessed",
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "alias_bytes",
    "generated_code_bytes",
    "peak_hbm_bytes",
    "hlo_instructions",
)


@dataclasses.dataclass(frozen=True)
class RegressionRule:
    """One declarative threshold: flag when ``metric`` grows more than
    ``threshold_pct`` percent over baseline (all tracked metrics — flops,
    bytes, seconds — regress by growing).

    ``kind`` selects the record section the metric lives in: ``"program"``
    (program_analysis metrics), ``"compile"`` (per-program compile
    seconds), ``"phase"`` (phase wall-clock), ``"dispatch"`` (program_call
    dispatch seconds), ``"quality"`` (edit-quality metrics from the
    ``quality`` ledger event — PSNR/SSIM), ``"comm"`` (collective
    counts/bytes from ``comm_analysis`` events), ``"device_memory"``
    (per-device peak HBM from ``memory`` snapshots), ``"divergence"``
    (cross-replica divergence scalars), ``"reliability"`` (serving-health
    summaries from ``serve_health`` events — error/shed rates, breaker
    trips), ``"stream"`` (streaming-job summaries from ``stream_health``
    events — seam PSNRs, window failures), ``"slo"`` (per-objective
    compliance/budget-burn from ``slo_report`` events, obs/slo.py), or
    ``"segment"`` (per-critical-path-segment latency percentiles
    aggregated from ``span`` events — queue/resolve/dispatch/decode), or
    ``"cost"`` (cost & capacity attribution from ``cost_attribution``
    events, obs/cost.py — cost-per-request, busy/idle fraction, padding
    waste), or ``"probe"`` (active-probing correctness from ``probe`` /
    ``probe_audit`` events, obs/probe.py — known-answer success rates,
    cross-replica answer-audit divergences, probe latency tails).
    ``min_abs`` suppresses verdicts
    whose absolute delta is noise-sized (a 0.001 s phase doubling is not a
    regression). ``programs`` (labels for program/compile/dispatch kinds,
    phase names for phases) restricts the rule; None applies it everywhere.

    ``direction``: ``"increase"`` (the default — flops/bytes/seconds
    regress by GROWING), ``"decrease"`` for metrics that regress by
    DROPPING (reconstruction / background-preservation PSNR, SSIM), or
    ``"nonzero"`` for invariants that must be EXACTLY zero with no noise
    floor (replica divergence) — any nonzero new value regresses, even
    against an identical baseline.
    """

    metric: str
    kind: str = "program"
    threshold_pct: float = 10.0
    min_abs: float = 0.0
    programs: Optional[Tuple[str, ...]] = None
    direction: str = "increase"

    @property
    def name(self) -> str:
        if self.direction == "nonzero":
            return f"{self.kind}:{self.metric}!=0"
        sign = "-" if self.direction == "decrease" else "+"
        return f"{self.kind}:{self.metric}{sign}{self.threshold_pct:g}%"


# edit-quality gates: a reconstruction or background-
# preservation drop regresses a run exactly like a perf metric growing.
# PSNR thresholds are percentage-of-dB with an absolute 0.5 dB noise
# floor; inf→inf (bit-exact reconstruction both runs) is a clean pass and
# inf→finite (the exactness guarantee was LOST) always regresses.
QUALITY_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("recon_psnr", kind="quality", direction="decrease",
                   threshold_pct=5.0, min_abs=0.5),
    RegressionRule("background_psnr", kind="quality", direction="decrease",
                   threshold_pct=5.0, min_abs=0.5),
    RegressionRule("recon_ssim", kind="quality", direction="decrease",
                   threshold_pct=2.0, min_abs=0.005),
)

# distributed gates: collective traffic growing means XLA is
# moving more bytes between chips for the same program; per-device peak
# HBM guards each chip's residency; replica divergence is an exactness
# invariant — it must be 0.0, with NO noise floor (a single diverged
# replica silently corrupts every edit it touches).
COMM_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("collective_bytes", kind="comm", threshold_pct=15.0),
    RegressionRule("collective_count", kind="comm", threshold_pct=25.0),
    RegressionRule("peak_bytes_in_use", kind="device_memory",
                   threshold_pct=10.0, min_abs=1 << 20),
    RegressionRule("value", kind="divergence", direction="nonzero"),
)

# time-domain gates: per-program execute-latency distributions
# (execute_timing events, obs/timing.py reservoirs) and mined device
# traces (trace_analysis events, obs/trace.py). Latency regresses by
# growing — p50 is the serving headline, p99 the SLO tail; small
# absolute floors keep micro-dispatch jitter out. Trace device-total
# growing means the chip did more work for the same phase; the
# compute/collective overlap fraction regresses by DROPPING (a ppermute
# chain that was hidden under compute becoming exposed).
TIMING_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("blocked_p50_s", kind="timing", threshold_pct=25.0,
                   min_abs=0.001),
    RegressionRule("blocked_p99_s", kind="timing", threshold_pct=25.0,
                   min_abs=0.002),
    RegressionRule("device_total_s", kind="trace", threshold_pct=20.0,
                   min_abs=0.05),
    RegressionRule("overlap_fraction", kind="trace", direction="decrease",
                   threshold_pct=10.0, min_abs=0.02),
)

# reliability gates: the serving resilience layer's health
# summary (`serve_health` ledger events — engine close / chaos loadgen)
# regresses like perf: the error rate climbing, load-shedding appearing,
# the circuit breaker tripping or deadlines expiring where the baseline
# had none. threshold_pct=0 + a 0.5 absolute floor makes the count rules
# "any new incident regresses" while identical runs still self-compare
# clean (a 0-delta is never > 0); rates get small absolute noise floors.
FAULT_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("error_rate", kind="reliability", threshold_pct=10.0,
                   min_abs=0.01),
    RegressionRule("shed_rate", kind="reliability", threshold_pct=10.0,
                   min_abs=0.01),
    RegressionRule("breaker_trips", kind="reliability", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("deadline_exceeded", kind="reliability",
                   threshold_pct=0.0, min_abs=0.5),
)

# streaming-seam gates: the long-video tier's window
# boundaries are a quality surface of their own — the `stream_health`
# summary (stream/driver.py) lands the worst cross-boundary
# adjacent-frame PSNR per job, and a seam getting visibly worse regresses
# exactly like a reconstruction drop (percentage-of-dB with a 0.5 dB
# noise floor; inf→inf — a static clip, or a single-window job with no
# seams — passes clean). Window failures, passthrough degradations and
# detected manifest corruption are any-new-incident rules like the
# reliability counters; `src_err_max` is an exactness invariant — every
# edited window's source stream must replay bit-exact through the store,
# so ANY nonzero value regresses even against itself.
SEAM_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("seam_min_psnr", kind="stream", direction="decrease",
                   threshold_pct=5.0, min_abs=0.5),
    RegressionRule("seam_mean_psnr", kind="stream", direction="decrease",
                   threshold_pct=5.0, min_abs=0.5),
    RegressionRule("windows_failed", kind="stream", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("windows_passthrough", kind="stream", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("manifest_corrupt", kind="stream", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("src_err_max", kind="stream", direction="nonzero"),
)

# SLO gates: obs/slo.py evaluates declarative objectives
# (availability, served p99, deadline-miss rate, seam PSNR) into
# `slo_report` events with a uniform `budget_burn` — the fraction of the
# objective's error budget consumed (1.0 = budget exactly spent). Burn
# GROWING by a quarter of the budget regresses; an objective FLIPPING
# from compliant to non-compliant regresses regardless of magnitude
# (compliant is 1.0/0.0, so the 0.5 floor means exactly "it flipped").
# Self-compare stays clean: a 0-delta is never above the threshold.
SLO_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("budget_burn", kind="slo", threshold_pct=25.0,
                   min_abs=0.25),
    RegressionRule("compliant", kind="slo", direction="decrease",
                   threshold_pct=0.0, min_abs=0.5),
)

# critical-path gates: per-segment latency percentiles
# aggregated from request `span` events (queue vs resolve vs dispatch vs
# decode, obs/spans.py SPAN_SEGMENTS). A segment's tail growing names
# WHICH stage of the pipeline regressed, where the e2e TIMING_RULES only
# say that something did. Floors mirror the timing rules' — CPU-test
# micro-latencies stay out.
SEGMENT_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("p50_s", kind="segment", threshold_pct=25.0,
                   min_abs=0.001),
    RegressionRule("p99_s", kind="segment", threshold_pct=25.0,
                   min_abs=0.002),
)

# fleet-signal gates: the telemetry plane's `fleet_signals`
# evaluations (obs/signals.py over the scraped tsdb). burn_alerts is the
# cumulative both-windows-burning count — ANY new alert regresses
# (threshold 0 + the 0.5 floor, the any-new-incident pattern), while a
# zero-alert self-compare stays clean. scrape_error_rate climbing means
# the telemetry plane itself degraded (dead replicas, wedged probes);
# saturation is the queue-wait-p99 over dispatch-p50 ratio — noisy by
# nature, so it gets the widest percentage band plus a 0.5 floor. The
# per-tenant demand meters are schema-gated by test pins, not rules: a
# demand SHIFT between runs is workload, not regression.
SIGNAL_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("burn_alerts", kind="signal", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("scrape_error_rate", kind="signal", threshold_pct=10.0,
                   min_abs=0.01),
    RegressionRule("saturation", kind="signal", threshold_pct=20.0,
                   min_abs=0.5),
)

# incident gates: ANY increase in captured incidents —
# overall or per trigger kind — regresses the run. The healthy baseline
# is zero bundles, so threshold_pct=0 with a 0.5 floor means one new
# incident is one verdict; a zero-incident self-compare stays clean.
# Suppressed (debounced) captures gate too: a run that went from "one
# bundle" to "one bundle plus forty suppressed repeats" got worse even
# though the bundle count held.
INCIDENT_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("count", kind="incident", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("suppressed", kind="incident", threshold_pct=0.0,
                   min_abs=0.5),
)

# cost & capacity gates: the serving engine's end-of-run
# `cost_attribution` rows (obs/cost.py) — one engine-scope capacity
# roll-up plus per-tenant/per-program chargeback aggregates. The cost of
# a served request growing 15% regresses like a latency tail;
# utilization (busy_fraction) regresses by DROPPING — the same fleet
# doing the same work while sitting idler is capacity leaking away;
# padding waste and idle fraction regress by growing, each with an
# absolute floor so CPU-test micro-runs (sub-millisecond busy windows)
# don't flag on jitter. Labels follow the serve_health pattern
# ("serve", "serve:tenant:<name>", "serve:program:<label>"), so every
# rule gates per-tenant and per-program rows wherever the metric lands.
COST_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("cost_per_request_s", kind="cost", threshold_pct=15.0,
                   min_abs=0.001),
    RegressionRule("busy_fraction", kind="cost", direction="decrease",
                   threshold_pct=20.0, min_abs=0.02),
    RegressionRule("padding_waste", kind="cost", threshold_pct=20.0,
                   min_abs=0.02),
    RegressionRule("idle_fraction", kind="cost", threshold_pct=20.0,
                   min_abs=0.05),
)

# correctness-plane gates: active-probing verdicts from
# `probe` / `probe_audit` events (obs/probe.py, serve/prober.py). The
# known-answer success rate regresses by DROPPING with a zero band plus
# a 1% floor — probes are deterministic canaries, not sampled traffic,
# so any failed probe is signal. Answer-audit divergences follow the
# incident pattern (any-increase: threshold_pct=0 with a 0.5 floor) —
# the healthy baseline is ZERO replicas disagreeing about the canary's
# bytes, and the overall "probe" label is seeded so a probes-off
# baseline still gates a chaos run's first divergence. Probe latency
# p99 gets a wide band + absolute floor: canaries ride the reserved
# low-priority tenant, so their tails are noisy by design and only a
# gross slowdown (the probe path itself wedging) should flag.
PROBE_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("success_rate", kind="probe", direction="decrease",
                   threshold_pct=0.0, min_abs=0.01),
    RegressionRule("divergences", kind="probe", threshold_pct=0.0,
                   min_abs=0.5),
    RegressionRule("latency_p99_s", kind="probe", threshold_pct=50.0,
                   min_abs=0.5),
)

DEFAULT_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("flops", threshold_pct=10.0),
    RegressionRule("bytes_accessed", threshold_pct=15.0, min_abs=1 << 20),
    RegressionRule("temp_bytes", threshold_pct=10.0, min_abs=1 << 20),
    RegressionRule("peak_hbm_bytes", threshold_pct=10.0, min_abs=1 << 20),
    RegressionRule("hlo_instructions", threshold_pct=25.0, min_abs=16),
    RegressionRule("seconds", kind="compile", threshold_pct=50.0, min_abs=1.0),
    RegressionRule("seconds", kind="phase", threshold_pct=25.0, min_abs=0.5),
) + (QUALITY_RULES + COMM_RULES + TIMING_RULES + FAULT_RULES + SEAM_RULES
     + SLO_RULES + SEGMENT_RULES + SIGNAL_RULES + INCIDENT_RULES
     + COST_RULES + PROBE_RULES)


def split_runs(events: Iterable[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
    """Split one ledger event stream on ``run_start`` boundaries (ledger
    files open append-mode, so repeat invocations stack runs in one file).
    Events before the first run_start (a truncated head) form their own
    run so nothing is silently dropped."""
    runs: List[List[Dict[str, Any]]] = []
    for e in events:
        if not isinstance(e, dict):
            continue
        if e.get("event") == "run_start" or not runs:
            runs.append([])
        runs[-1].append(e)
    return runs


def extract_run(events: Sequence[Dict[str, Any]],
                source: Optional[str] = None) -> Dict[str, Any]:
    """One run's events → a flat record the rules evaluate against.

    ``programs`` keeps the LAST program_analysis per label (a re-analysis
    after a shape change supersedes the first); compile/dispatch/phase
    seconds accumulate over the run. Tolerates partial events (a torn
    final line parsed into a half-record) by treating missing fields as
    absent, never raising.
    """
    start = next((e for e in events if e.get("event") == "run_start"), {})
    rec: Dict[str, Any] = {
        "run_id": start.get("run_id"),
        "wall_time": start.get("wall_time"),
        "git_sha": start.get("git_sha"),
        "backend": start.get("backend"),
        "source": source,
        "programs": {},
        "compiles": {},
        "phases": {},
        "dispatch": {},
        "quality": {},
        # distributed sections — empty for older ledgers,
        # which every consumer tolerates (no shared labels → no verdicts)
        "comm": {},
        "device_memory": {},
        "divergence": {},
        # time-domain sections — likewise empty in older ledgers
        "timing": {},
        "trace": {},
        # reliability section — likewise empty in older ledgers
        "reliability": {},
        # streaming section — likewise empty in older ledgers
        "stream": {},
        # tracing sections — likewise empty in older ledgers or
        # with tracing off: per-critical-path-segment latency
        # percentiles from span events, per-objective SLO reports
        "segments": {},
        "slo": {},
        # fleet-telemetry section — likewise empty in older ledgers
        # or with the collector off: the last fleet_signals evaluation
        # per label (plus per-tenant demand lanes and the fleet_series
        # store summary), gated by SIGNAL_RULES
        "signals": {},
        # incident section: capture counts per trigger kind
        # from `incident` ledger events, gated by INCIDENT_RULES (any
        # increase regresses). The overall "incident" label is SEEDED at
        # zero — rules only compare labels both runs share, so a healthy
        # baseline (zero bundles) must still hold the label for a chaos
        # run's first bundle to regress against it.
        "incidents": {"incident": {"count": 0.0, "suppressed": 0.0,
                                   "events": 0.0}},
        # cost & capacity section — empty for older
        # ledgers (no seeded labels: unlike incidents, a run with no
        # cost_attribution events has no cost SURFACE to regress, so an
        # old baseline simply shares no labels and extracts clean)
        "cost": {},
        # correctness-plane section: known-answer probe
        # verdicts per target from `probe` events plus answer-audit
        # divergences from `probe_audit` events, gated by PROBE_RULES.
        # The overall "probe" label is SEEDED perfect (like incidents'
        # zero) so a probes-off healthy baseline still holds the label
        # a chaos run's first divergence regresses against.
        "probes": {"probe": {"success_rate": 1.0, "failures": 0.0,
                             "divergences": 0.0}},
    }
    seg_samples: Dict[str, List[float]] = {}
    probe_samples: Dict[str, Tuple[List[float], List[float]]] = {}
    for e in events:
        kind = e.get("event")
        if kind == "program_analysis":
            label = e.get("program") or "(unattributed)"
            rec["programs"][label] = {
                k: e[k] for k in (*PROGRAM_METRICS, "hlo_fingerprint")
                if k in e
            }
        elif kind == "compile":
            label = e.get("program") or "(unattributed)"
            c = rec["compiles"].setdefault(label, {"seconds": 0.0, "events": 0})
            try:
                c["seconds"] += float(e.get("seconds", 0.0))
            except (TypeError, ValueError):
                continue
            c["events"] += 1
        elif kind == "phase":
            name = e.get("name") or "?"
            p = rec["phases"].setdefault(name, {"seconds": 0.0, "calls": 0})
            try:
                p["seconds"] += float(e.get("seconds", 0.0))
            except (TypeError, ValueError):
                continue
            p["calls"] += 1
        elif kind == "program_call":
            label = e.get("program") or "(unattributed)"
            try:
                rec["dispatch"][label] = rec["dispatch"].get(label, 0.0) + float(
                    e.get("dispatch_s", 0.0)
                )
            except (TypeError, ValueError):
                continue
        elif kind == "quality":
            # numeric metric fields only; a later quality event supersedes
            # (re-measured after a fix within the same run)
            for k, v in e.items():
                if k in ("event", "t", "program", "sidecar"):
                    continue
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    rec["quality"][k] = float(v)
        elif kind == "comm_analysis":
            label = e.get("program") or "(unattributed)"
            rec["comm"][label] = {
                k: v for k, v in e.items()
                if k not in ("event", "t", "program")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "memory":
            # per-device peak residency: keep the worst snapshot per device
            for d in e.get("devices") or ():
                if not isinstance(d, dict):
                    continue
                peak = d.get("peak_bytes_in_use")
                if peak is None:
                    continue
                label = f"device{d.get('device')}"
                try:
                    peak = float(peak)
                except (TypeError, ValueError):
                    continue
                rec["device_memory"][label] = max(
                    rec["device_memory"].get(label, 0.0), peak
                )
        elif kind == "divergence":
            label = e.get("label") or "(unattributed)"
            try:
                val = float(e.get("value", 0.0))
            except (TypeError, ValueError):
                continue
            rec["divergence"][label] = max(
                rec["divergence"].get(label, 0.0), val
            )
        elif kind == "execute_timing":
            # latest flush supersedes (reservoirs accumulate; the last
            # summary covers every dispatch recorded so far)
            label = e.get("program") or "(unattributed)"
            rec["timing"][label] = {
                k: v for k, v in e.items()
                if k not in ("event", "t", "program")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "trace_analysis":
            label = e.get("name") or "(unattributed)"
            rec["trace"][label] = {
                k: v for k, v in e.items()
                if k not in ("event", "t", "name", "trace_dir", "sidecar",
                             "families", "top_ops")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "serve_health":
            # one summary per engine/loadgen session; a later summary in
            # the same run supersedes (reopened engine over one ledger)
            label = e.get("label") or "serve"
            rec["reliability"][label] = {
                k: float(v) for k, v in e.items()
                if k not in ("event", "t", "label")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
            # per-tenant QoS sub-records flatten into their own
            # reliability labels so FAULT_RULES gate each tenant's
            # error/shed rates exactly like the fleet's
            tenants = e.get("tenants")
            if isinstance(tenants, dict):
                for tname, tvals in tenants.items():
                    if not isinstance(tvals, dict):
                        continue
                    rec["reliability"][f"{label}:tenant:{tname}"] = {
                        k: float(v) for k, v in tvals.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool)
                    }
        elif kind == "stream_health":
            # one summary per streaming job; multiple jobs in
            # one run land under their own labels so SEAM_RULES gate each
            label = e.get("label") or "stream"
            rec["stream"][label] = {
                k: float(v) for k, v in e.items()
                if k not in ("event", "t", "label")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "router_health":
            # the fleet router's summary joins the reliability
            # section under its own label — shared labels across two
            # router runs get the same declarative gates
            label = e.get("label") or "router"
            rec["reliability"][label] = {
                k: float(v) for k, v in e.items()
                if k not in ("event", "t", "label")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "device_telemetry":
            # the in-scan probe's worst divergence joins the same gate
            label = e.get("program") or "(unattributed)"
            try:
                val = float(e.get("divergence_max", 0.0))
            except (TypeError, ValueError):
                continue
            rec["divergence"][label] = max(
                rec["divergence"].get(label, 0.0), val
            )
        elif kind == "span":
            # critical-path accumulation: spans whose name maps
            # to a pipeline segment contribute their duration; finalized
            # into per-segment percentiles after the scan
            seg = SPAN_SEGMENTS.get(e.get("name"))
            if seg is not None:
                try:
                    seg_samples.setdefault(seg, []).append(
                        float(e.get("duration_s", 0.0))
                    )
                except (TypeError, ValueError):
                    pass
        elif kind == "fleet_signals":
            # the telemetry plane's periodic evaluation: the
            # LAST evaluation per label supersedes (cumulative counters
            # like burn_alerts make it the run's roll-up). Bools land as
            # 1.0/0.0; scale_advice becomes one-hots so a flip is a
            # visible numeric delta; tenant demand lanes flatten like
            # serve_health's tenants.
            label = e.get("label") or "fleet"
            vals = {}
            for k, v in e.items():
                if k in ("event", "t", "label", "tenants", "reasons",
                         "scale_advice"):
                    continue
                if isinstance(v, bool):
                    vals[k] = 1.0 if v else 0.0
                elif isinstance(v, (int, float)):
                    vals[k] = float(v)
            advice = e.get("scale_advice")
            if isinstance(advice, str):
                for a in ("grow", "hold", "shrink"):
                    vals[f"advice_{a}"] = 1.0 if advice == a else 0.0
            rec["signals"][label] = vals
            tenants = e.get("tenants")
            if isinstance(tenants, dict):
                for tname, tvals in tenants.items():
                    if not isinstance(tvals, dict):
                        continue
                    rec["signals"][f"{label}:tenant:{tname}"] = {
                        k: float(v) for k, v in tvals.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool)
                    }
        elif kind == "fleet_series":
            # the tsdb snapshot summary joins the signals section under
            # a ":series" sub-label (store health: gaps/drops/extent)
            label = e.get("label") or "fleet"
            rec["signals"][f"{label}:series"] = {
                k: float(v) for k, v in e.items()
                if k not in ("event", "t", "label", "sidecar")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "slo_report":
            # one objective per event (obs/slo.py); a later evaluation in
            # the same run supersedes. `compliant` lands as 1.0/0.0 so the
            # decrease rule sees the flip.
            name = e.get("name") or "(unnamed)"
            vals: Dict[str, float] = {}
            for k, v in e.items():
                if k in ("event", "t", "name", "section", "label",
                         "field", "mode"):
                    continue
                if isinstance(v, bool):
                    vals[k] = 1.0 if v else 0.0
                elif isinstance(v, (int, float)):
                    vals[k] = float(v)
            rec["slo"][name] = vals
        elif kind == "cost_attribution":
            # the cost plane's end-of-run chargeback rows (,
            # obs/cost.py): the engine-scope capacity roll-up lands
            # under the event label ("serve"); tenant/program rows
            # flatten like serve_health's tenants so COST_RULES gate
            # each lane. A later row for the same label supersedes
            # (reopened engine over one ledger).
            base_label = e.get("label") or "serve"
            scope = e.get("scope") or "engine"
            name = e.get("name")
            if scope == "engine" or name is None:
                label = base_label
            else:
                label = f"{base_label}:{scope}:{name}"
            rec["cost"][label] = {
                k: float(v) for k, v in e.items()
                if k not in ("event", "t", "label", "scope", "name")
                and isinstance(v, (int, float)) and not isinstance(v, bool)
            }
        elif kind == "probe":
            # one known-answer probe verdict (, obs/probe.py):
            # accumulate pass/fail + latency overall and per target;
            # finalized into success rates / p99 after the scan
            labels = ["probe"]
            if e.get("target"):
                labels.append(f"probe:{e['target']}")
            for label in labels:
                oks, lats = probe_samples.setdefault(label, ([], []))
                oks.append(1.0 if e.get("ok") else 0.0)
                try:
                    lats.append(float(e.get("latency_s") or 0.0))
                except (TypeError, ValueError):
                    pass
        elif kind == "probe_audit":
            # one answer-audit divergence (the wrong-but-healthy
            # signature): counts accumulate overall and per divergent
            # target so PROBE_RULES' any-increase gate names the replica
            for label in ("probe", f"probe:{e.get('divergent') or '?'}"):
                m = rec["probes"].setdefault(
                    label, {"success_rate": 1.0, "failures": 0.0,
                            "divergences": 0.0})
                m["divergences"] = m.get("divergences", 0.0) + 1.0
        elif kind == "incident":
            # capture counts accumulate over the run, overall AND per
            # trigger kind — INCIDENT_RULES then flags any label that
            # grew, so "more breaker bundles" and "first-ever crash"
            # each get their own verdict line
            trig = e.get("trigger") or "(unknown)"
            for label in ("incident", f"incident:{trig}"):
                m = rec["incidents"].setdefault(
                    label, {"count": 0.0, "suppressed": 0.0, "events": 0.0})
                m["count"] += 1.0
                try:
                    m["suppressed"] += float(e.get("suppressed") or 0.0)
                    m["events"] += float(e.get("events") or 0.0)
                except (TypeError, ValueError):
                    pass
    for seg, durations in sorted(seg_samples.items()):
        rec["segments"][seg] = {
            "count": float(len(durations)),
            "p50_s": round(percentile(durations, 50), 6),
            "p99_s": round(percentile(durations, 99), 6),
            "max_s": round(max(durations), 6),
            "total_s": round(sum(durations), 6),
        }
    for label, (oks, lats) in sorted(probe_samples.items()):
        m = rec["probes"].setdefault(
            label, {"success_rate": 1.0, "failures": 0.0,
                    "divergences": 0.0})
        m["count"] = float(len(oks))
        m["success_rate"] = round(sum(oks) / len(oks), 6) if oks else 1.0
        m["failures"] = float(len(oks) - int(sum(oks)))
        if lats:
            # latency lands only when real samples exist — a seeded-only
            # baseline must not offer a 0.0 the p99 rule inflates against
            m["latency_p99_s"] = round(percentile(lats, 99), 6)
    return rec


def _rule_values(record: Dict[str, Any], rule: RegressionRule) -> Dict[str, float]:
    """{label: value} for one rule's metric over one extracted run."""
    out: Dict[str, float] = {}
    if rule.kind == "program":
        for label, m in record.get("programs", {}).items():
            if rule.metric in m:
                out[label] = float(m[rule.metric])
    elif rule.kind == "compile":
        for label, c in record.get("compiles", {}).items():
            out[label] = float(c.get("seconds", 0.0))
    elif rule.kind == "phase":
        for name, p in record.get("phases", {}).items():
            out[name] = float(p.get("seconds", 0.0))
    elif rule.kind == "dispatch":
        out = {k: float(v) for k, v in record.get("dispatch", {}).items()}
    elif rule.kind == "quality":
        q = record.get("quality", {})
        if rule.metric in q:
            out["edit_quality"] = float(q[rule.metric])
    elif rule.kind == "comm":
        for label, m in record.get("comm", {}).items():
            if rule.metric in m:
                out[label] = float(m[rule.metric])
    elif rule.kind == "device_memory":
        if rule.metric == "peak_bytes_in_use":
            out = {k: float(v)
                   for k, v in record.get("device_memory", {}).items()}
    elif rule.kind == "divergence":
        out = {k: float(v) for k, v in record.get("divergence", {}).items()}
    elif rule.kind in ("timing", "trace", "reliability", "stream", "slo",
                       "segment", "signal", "incident", "cost", "probe"):
        section = {"segment": "segments", "signal": "signals",
                   "incident": "incidents",
                   "probe": "probes"}.get(rule.kind, rule.kind)
        for label, m in record.get(section, {}).items():
            if rule.metric in m:
                out[label] = float(m[rule.metric])
    if rule.programs is not None:
        out = {k: v for k, v in out.items() if k in rule.programs}
    return out


def evaluate_rules(
    base: Dict[str, Any],
    new: Dict[str, Any],
    rules: Sequence[RegressionRule] = DEFAULT_RULES,
) -> Dict[str, Any]:
    """Evaluate every rule over two extracted runs.

    Returns ``{"verdicts": [...], "regressions": [...], "pass": bool}``.
    Each verdict: rule name, kind, program, metric, base/new values, the
    percent delta, ``regressed``, and (for program-kind rules) whether the
    HLO fingerprint changed — a fingerprint change turns a would-be
    regression into context ("XLA built a different program"), but the
    verdict still flags it: an intentional program change should land with
    an updated baseline, not a silent pass.
    """
    verdicts: List[Dict[str, Any]] = []
    base_progs = base.get("programs", {})
    new_progs = new.get("programs", {})
    for rule in rules:
        bvals = _rule_values(base, rule)
        nvals = _rule_values(new, rule)
        for label in sorted(set(bvals) & set(nvals)):
            b, n = bvals[label], nvals[label]
            delta = n - b
            if rule.direction == "nonzero":
                # an exactness invariant: any nonzero (or NaN) new value
                # regresses, baseline regardless — self-comparison of a
                # diverged run must still fail
                regressed = not (n == 0.0)
                verdicts.append({
                    "rule": rule.name,
                    "kind": rule.kind,
                    "program": label,
                    "metric": rule.metric,
                    "base": b,
                    "new": n,
                    "delta_pct": 0.0 if not regressed else None,
                    "regressed": regressed,
                })
                continue
            if rule.direction == "decrease":
                # quality metrics regress by DROPPING; inf baselines (an
                # exact reconstruction) pass only against inf, and losing
                # the exactness pedestal is always a regression
                if math.isinf(b) and math.isinf(n):
                    delta_pct = 0.0
                elif math.isinf(b):
                    delta_pct = 100.0
                elif math.isinf(n):
                    delta_pct = 0.0 if n > 0 else float("inf")
                else:
                    delta_pct = (b - n) / abs(b) * 100.0 if b else (
                        0.0 if n >= b else float("inf"))
                big_enough = abs(delta) >= rule.min_abs or math.isinf(delta)
            else:
                delta_pct = (n / b - 1.0) * 100.0 if b else (
                    0.0 if not n else float("inf"))
                big_enough = abs(delta) >= rule.min_abs
            regressed = delta_pct > rule.threshold_pct and big_enough
            v: Dict[str, Any] = {
                "rule": rule.name,
                "kind": rule.kind,
                "program": label,
                "metric": rule.metric,
                "base": b,
                "new": n,
                "delta_pct": round(delta_pct, 2) if delta_pct != float("inf") else None,
                "regressed": regressed,
            }
            if rule.kind == "program":
                fp_b = base_progs.get(label, {}).get("hlo_fingerprint")
                fp_n = new_progs.get(label, {}).get("hlo_fingerprint")
                if fp_b and fp_n:
                    v["fingerprint_changed"] = fp_b != fp_n
            verdicts.append(v)
    regressions = [v for v in verdicts if v["regressed"]]
    return {"verdicts": verdicts, "regressions": regressions,
            "pass": not regressions}


class RunHistory:
    """Chronologically-ordered extracted runs from a directory of ledgers.

    Ordering: ``run_start.wall_time`` (ISO-8601, lexicographically
    sortable) with file mtime as the tiebreak/fallback for torn heads that
    lost their run_start line.
    """

    def __init__(self, runs: List[Dict[str, Any]]):
        self.runs = runs

    @classmethod
    def scan(cls, directory: str, pattern: str = "*.jsonl") -> "RunHistory":
        keyed = []
        for path in sorted(glob.glob(os.path.join(directory, pattern))):
            # rotated segments (<stem>.N.jsonl, RunLedger(max_bytes=...))
            # are read through their base ledger's chain — scanning them
            # directly would double-count every run
            root = path[:-len(".jsonl")] if path.endswith(".jsonl") else path
            base, dot, idx = root.rpartition(".")
            if dot and idx.isdigit() and os.path.exists(base + ".jsonl"):
                continue
            try:
                events = read_ledger(path)
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            for i, run_events in enumerate(split_runs(events)):
                rec = extract_run(run_events, source=path)
                keyed.append(((rec.get("wall_time") or "", mtime, i), rec))
        keyed.sort(key=lambda kv: kv[0])
        return cls([rec for _, rec in keyed])

    @classmethod
    def from_ledger(cls, path: str) -> "RunHistory":
        return cls([
            extract_run(run_events, source=path)
            for run_events in split_runs(read_ledger(path))
        ])

    def __len__(self) -> int:
        return len(self.runs)

    def latest(self) -> Optional[Dict[str, Any]]:
        return self.runs[-1] if self.runs else None

    def series(self, metric: str, kind: str = "program",
               ) -> Dict[Tuple[str, Optional[str]], List[Tuple[Optional[str], float]]]:
        """Metric series keyed by ``(label, hlo_fingerprint)`` — program-kind
        series split when XLA rebuilt the program differently (non-program
        kinds key on ``(label, None)``). Values are ``(run_id, value)`` in
        run order."""
        rule = RegressionRule(metric, kind=kind)
        out: Dict[Tuple[str, Optional[str]], List[Tuple[Optional[str], float]]] = {}
        for rec in self.runs:
            vals = _rule_values(rec, rule)
            for label, v in vals.items():
                fp = (rec.get("programs", {}).get(label, {}).get("hlo_fingerprint")
                      if kind == "program" else None)
                out.setdefault((label, fp), []).append((rec.get("run_id"), v))
        return out

    def baseline_for(self, new: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The most recent prior run that shares ≥1 program label with
        ``new`` (so a ledger from an unrelated tool doesn't become the
        baseline); falls back to the most recent prior run."""
        labels = set(new.get("programs", {})) | set(new.get("phases", {}))
        prior = [r for r in self.runs
                 if r is not new and r.get("run_id") != new.get("run_id")]
        for rec in reversed(prior):
            shared = labels & (set(rec.get("programs", {}))
                               | set(rec.get("phases", {})))
            if shared:
                return rec
        return prior[-1] if prior else None
