"""Observability of the port (the part of ``videop2p_tpu/obs/`` the serving
fleet reads): the run ledger and its flight-recorder tee, execute-latency
reservoirs, request spans, the cost and capacity model, Prometheus
rendering, the edit-quality metrics, and the fleet's three planes —
telemetry (the time-series store and the signals over it), correctness
(the known-answer probes and the answer audit) and incidents (the SLO
reports and the capture bundles)."""

from videop2p_tpu_torch.obs.attention import load_obs_sidecar, save_obs_sidecar
from videop2p_tpu_torch.obs.cost import CostModel
from videop2p_tpu_torch.obs.flight import FLIGHT_DEFAULT_CAPACITY, FlightRecorder
from videop2p_tpu_torch.obs.history import SLO_RULES, RegressionRule
from videop2p_tpu_torch.obs.incident import INCIDENT_FIELDS, INCIDENT_TRIGGERS, IncidentManager
from videop2p_tpu_torch.obs.ledger import (
    RunLedger,
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
from videop2p_tpu_torch.obs.timing import LatencyReservoir
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
           "load_series_sidecar"]
