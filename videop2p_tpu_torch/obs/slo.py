"""Declarative SLOs with error-budget burn over run records (port of
``videop2p_tpu/obs/slo.py``).

An :class:`SLOSpec` names one objective — *which* metric, *where* in a run
record (the sections of JAX's ``videop2p_tpu/obs/history.py:extract_run``),
and the target it must stay on the right side of. :func:`evaluate_slos`
turns a record into per-objective result dicts with a uniform **budget
burn**: the fraction of the objective's error budget the run consumed —
``burn <= 1.0`` is compliant, ``burn == 2.0`` means the budget was blown
twice over. One ``slo_report`` ledger event per objective
(:func:`emit_slo_reports`) is what ``obs/history.py`` extracts into the
``slo`` section and ``SLO_RULES`` gate in ``tools/obs_diff.py``.

Burn math by mode:

  * ``rate_max`` / ``value_max`` — smaller is better, ``target`` is the
    ceiling: ``burn = actual / target`` (0.5 % errors against a 1 %
    availability budget → burn 0.5).
  * ``value_min`` — bigger is better, ``target`` is the floor:
    ``burn = target / actual`` (seam PSNR 30 dB against a 15 dB floor →
    burn 0.5; an inf PSNR — no seams — burns nothing).

Objectives whose metric is absent from the record are SKIPPED, not
failed: a run with no serving section has no availability objective, and
a missing report is a missing label, never a fake pass/fail. Stdlib only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

# SLO_RULES live in history.py with the rule packs; re-exported here so
# SLO consumers import everything SLO-shaped from one place.
from videop2p_tpu_torch.obs.history import SLO_RULES

__all__ = [
    "SLO_REPORT_FIELDS",
    "SLO_RULES",
    "SLOSpec",
    "DEFAULT_SLOS",
    "evaluate_slos",
    "emit_slo_reports",
    "record_from_summaries",
]

# Schema pin: every `slo_report` ledger event carries exactly these keys
# (plus the ledger's own event/t).
SLO_REPORT_FIELDS = (
    "name",         # objective name — the label obs_diff compares under
    "section",      # extracted-record section the metric came from
    "label",        # label within the section
    "field",        # metric field name
    "target",       # the ceiling (rate/value_max) or floor (value_min)
    "mode",         # rate_max | value_max | value_min
    "actual",       # the observed value (rate after denom division)
    "compliant",    # burn <= 1.0
    "budget_burn",  # fraction of the error budget consumed
)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over an extracted run record.

    ``section``/``label``/``field`` address the metric
    (``record[section][label][field]``); ``denom_field`` turns a raw
    count into a rate by dividing by a sibling field (deadline misses ÷
    requests). ``target`` + ``mode`` define the budget as documented in
    the module docstring.
    """

    name: str
    section: str
    label: str
    field: str
    target: float
    mode: str = "value_max"
    denom_field: Optional[str] = None


# The fleet's default objectives (docs/OBSERVABILITY.md Layer 5): tuned
# for the production shapes, deliberately loose for CPU-test scale — the
# gate with teeth is SLO_RULES' burn DELTA between runs, not these
# absolute targets.
DEFAULT_SLOS: tuple = (
    # availability: at most 1% of requests may fail
    SLOSpec("availability", "reliability", "serve", "error_rate",
            0.01, mode="rate_max"),
    # deadline-miss rate: at most 1% of requests may blow their deadline
    SLOSpec("deadline_miss_rate", "reliability", "serve",
            "deadline_exceeded", 0.01, mode="rate_max",
            denom_field="requests"),
    # served tail latency: e2e p99 (queueing included) under 30 s
    SLOSpec("served_p99_latency", "timing", "serve_request_e2e",
            "blocked_p99_s", 30.0, mode="value_max"),
    # streaming seam quality: the worst window boundary stays above 15 dB
    SLOSpec("seam_min_psnr", "stream", "stream", "seam_min_psnr",
            15.0, mode="value_min"),
)


def _burn(spec: SLOSpec, actual: float) -> float:
    if spec.mode == "value_min":
        if actual > 0:
            return spec.target / actual  # inf actual → burn 0.0
        return float("inf") if spec.target > 0 else 0.0
    # rate_max / value_max
    if spec.target > 0:
        return actual / spec.target
    return 0.0 if actual <= 0 else float("inf")


def evaluate_slos(record: Dict[str, Any],
                  specs: Sequence[SLOSpec] = DEFAULT_SLOS,
                  ) -> List[Dict[str, Any]]:
    """Per-objective result dicts (``SLO_REPORT_FIELDS``) for every spec
    whose metric exists in ``record``; absent metrics skip their spec."""
    out: List[Dict[str, Any]] = []
    for spec in specs:
        section = record.get(spec.section) or {}
        vals = section.get(spec.label)
        if not isinstance(vals, dict) or spec.field not in vals:
            continue
        try:
            actual = float(vals[spec.field])
        except (TypeError, ValueError):
            continue
        if spec.denom_field is not None:
            try:
                denom = float(vals.get(spec.denom_field) or 0.0)
            except (TypeError, ValueError):
                denom = 0.0
            actual = actual / denom if denom > 0 else 0.0
        burn = _burn(spec, actual)
        out.append({
            "name": spec.name,
            "section": spec.section,
            "label": spec.label,
            "field": spec.field,
            "target": spec.target,
            "mode": spec.mode,
            "actual": (round(actual, 6)
                       if actual == actual and abs(actual) != float("inf")
                       else actual),
            "compliant": burn <= 1.0,
            "budget_burn": (round(burn, 4)
                            if abs(burn) != float("inf") else burn),
        })
    return out


def emit_slo_reports(ledger, record: Dict[str, Any],
                     specs: Sequence[SLOSpec] = DEFAULT_SLOS,
                     ) -> List[Dict[str, Any]]:
    """Evaluate and write one ``slo_report`` ledger event per objective;
    returns the objectives (for callers that also want them live)."""
    objectives = evaluate_slos(record, specs)
    for obj in objectives:
        ledger.event("slo_report", **obj)
    return objectives


def record_from_summaries(*, health: Optional[Dict[str, Any]] = None,
                          timing: Optional[Dict[str, Any]] = None,
                          stream: Optional[Dict[str, Any]] = None,
                          label: str = "serve") -> Dict[str, Any]:
    """A minimal extracted-record shape from LIVE summaries — what a
    closing engine (``health_record()`` + ``execute_timing_summary()``)
    feeds :func:`evaluate_slos` without re-reading its own ledger."""
    rec: Dict[str, Any] = {"reliability": {}, "timing": {}, "stream": {}}
    if health:
        rec["reliability"][label] = {
            k: float(v) for k, v in health.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
    if timing:
        rec["timing"] = dict(timing)
    if stream:
        rec["stream"] = dict(stream)
    return rec
