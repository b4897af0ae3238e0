"""Observability of the port (the part of ``videop2p_tpu/obs/`` the serving
engine reads): the run ledger, execute-latency reservoirs, request spans,
the cost and capacity model, Prometheus rendering, the probe tenant and the
edit-quality metrics."""

from videop2p_tpu_torch.obs.cost import CostModel
from videop2p_tpu_torch.obs.ledger import (
    RunLedger,
    current_ledger,
    instrumented_program,
    program_label,
    read_ledger,
)
from videop2p_tpu_torch.obs.prom import parse_prometheus, render_prometheus
from videop2p_tpu_torch.obs.spans import Tracer, parse_traceparent
from videop2p_tpu_torch.obs.timing import LatencyReservoir

__all__ = ["CostModel", "RunLedger", "current_ledger", "instrumented_program",
           "program_label", "read_ledger", "parse_prometheus", "render_prometheus",
           "Tracer", "parse_traceparent", "LatencyReservoir"]
