"""Declarative regression rules over run records (the part of
``videop2p_tpu/obs/history.py`` that ``obs/slo.py`` needs).

:class:`RegressionRule` is one threshold on one metric of one record
section, and :data:`SLO_RULES` is the pack that gates ``slo_report``
events across runs. The rest of the JAX module — ``split_runs`` /
``extract_run``, :class:`RunHistory`, ``evaluate_rules`` and the other
rule packs that ``tools/obs_diff.py`` applies — is run-history analysis
and comes with the rest of ``obs/`` (ROADMAP Queue 1 item 14, step 3).
Until then JAX's ``tools/obs_diff.py`` reads the port's ledgers: their
event schemas are JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["RegressionRule", "SLO_RULES"]


@dataclasses.dataclass(frozen=True)
class RegressionRule:
    """One declarative threshold: flag when ``metric`` grows more than
    ``threshold_pct`` percent over baseline.

    ``kind`` selects the record section the metric lives in (``"slo"``:
    per-objective compliance / budget burn from ``slo_report`` events).
    ``min_abs`` suppresses verdicts whose absolute delta is noise-sized.
    ``programs`` restricts the rule to some labels; None applies it
    everywhere. ``direction``: ``"increase"`` (the default — the metric
    regresses by GROWING), ``"decrease"`` (it regresses by DROPPING), or
    ``"nonzero"`` (an invariant that must be exactly zero).
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


# SLO gates: a budget burn growing by a quarter (0.25 absolute floor), and
# an objective flipping from compliant to non-compliant regardless of
# magnitude (compliant is 1.0/0.0, so the 0.5 floor means exactly "it
# flipped"). A self-compare stays clean: a 0-delta is never above the
# threshold.
SLO_RULES: Tuple[RegressionRule, ...] = (
    RegressionRule("budget_burn", kind="slo", threshold_pct=25.0,
                   min_abs=0.25),
    RegressionRule("compliant", kind="slo", direction="decrease",
                   threshold_pct=0.0, min_abs=0.5),
)
