"""Observability of the port (``videop2p_tpu/obs/`` but for multi-device
accounting): the run ledger and its flight-recorder tee, the analysis of
each program's first call (``introspect.py``) and the mined device traces
(``trace.py``), execute-latency reservoirs, the pipelines'
per-step telemetry and attention records, the edit-quality metrics, run
history and its rule packs, the HTML edit report, request spans, the cost
and capacity model, Prometheus rendering, and the fleet's three planes —
telemetry (the time-series store and the signals over it), correctness
(the known-answer probes and the answer audit) and incidents (the SLO
reports and the capture bundles)."""

from videop2p_tpu_torch.obs.attention import (
    ATTN_HEAT_RES,
    ATTN_SUMMARY_FIELDS,
    attn_step_record,
    load_obs_sidecar,
    save_obs_sidecar,
    summarize_attn_record,
)
from videop2p_tpu_torch.obs.cost import CostModel
from videop2p_tpu_torch.obs.flight import FLIGHT_DEFAULT_CAPACITY, FlightRecorder
from videop2p_tpu_torch.obs.history import (
    DEFAULT_RULES,
    SLO_RULES,
    RegressionRule,
    RunHistory,
    evaluate_rules,
    extract_run,
    split_runs,
)
from videop2p_tpu_torch.obs.incident import INCIDENT_FIELDS, INCIDENT_TRIGGERS, IncidentManager
from videop2p_tpu_torch.obs.introspect import PROGRAM_METRICS, ProgramAnalysis, analyze_call
from videop2p_tpu_torch.obs.ledger import (
    RunLedger,
    analysis_enabled,
    current_ledger,
    instrumented_program,
    program_label,
    read_ledger,
)
from videop2p_tpu_torch.obs.probe import (
    PROBE_AUDIT_FIELDS,
    PROBE_EVENT_FIELDS,
    PROBE_KINDS,
    PROBE_TENANT,
    AnswerAudit,
    ProbeSuite,
)
from videop2p_tpu_torch.obs.prom import parse_prometheus, render_prometheus, samples_by_name
from videop2p_tpu_torch.obs.signals import FLEET_SIGNALS_FIELDS, SignalEngine, theil_sen_slope
from videop2p_tpu_torch.obs.slo import (
    DEFAULT_SLOS,
    SLO_REPORT_FIELDS,
    SLOSpec,
    emit_slo_reports,
    evaluate_slos,
    record_from_summaries,
)
from videop2p_tpu_torch.obs.spans import Tracer, parse_traceparent
from videop2p_tpu_torch.obs.quality import QUALITY_SUMMARY_FIELDS, edit_quality_record
from videop2p_tpu_torch.obs.telemetry import (
    decode_null_text_stats,
    decode_step_stats,
    latent_stats,
    summarize_step_stats,
)
from videop2p_tpu_torch.obs.timing import LatencyReservoir, measure_overhead_p50
from videop2p_tpu_torch.obs.trace import (
    TRACE_ANALYSIS_FIELDS,
    analyze_events,
    analyze_trace_dir,
    trace_window,
)
from videop2p_tpu_torch.obs.tsdb import FLEET_SERIES_FIELDS, TimeSeriesStore, load_series_sidecar

__all__ = ["CostModel", "RunLedger", "current_ledger", "instrumented_program",
           "program_label", "read_ledger", "parse_prometheus", "render_prometheus",
           "samples_by_name", "Tracer", "parse_traceparent", "LatencyReservoir",
           "save_obs_sidecar", "load_obs_sidecar", "FLIGHT_DEFAULT_CAPACITY",
           "FlightRecorder", "RegressionRule", "SLO_RULES", "INCIDENT_FIELDS",
           "INCIDENT_TRIGGERS", "IncidentManager", "PROBE_AUDIT_FIELDS",
           "PROBE_EVENT_FIELDS", "PROBE_KINDS", "PROBE_TENANT", "AnswerAudit", "ProbeSuite",
           "FLEET_SIGNALS_FIELDS", "SignalEngine", "theil_sen_slope", "DEFAULT_SLOS",
           "SLO_REPORT_FIELDS", "SLOSpec", "emit_slo_reports", "evaluate_slos",
           "record_from_summaries", "FLEET_SERIES_FIELDS", "TimeSeriesStore",
           "load_series_sidecar", "ATTN_HEAT_RES", "ATTN_SUMMARY_FIELDS", "attn_step_record",
           "summarize_attn_record", "DEFAULT_RULES", "RunHistory", "evaluate_rules",
           "extract_run", "split_runs", "QUALITY_SUMMARY_FIELDS", "edit_quality_record",
           "decode_null_text_stats", "decode_step_stats", "latent_stats",
           "summarize_step_stats", "measure_overhead_p50", "PROGRAM_METRICS",
           "ProgramAnalysis", "analyze_call", "analysis_enabled", "TRACE_ANALYSIS_FIELDS",
           "analyze_events", "analyze_trace_dir", "trace_window"]
