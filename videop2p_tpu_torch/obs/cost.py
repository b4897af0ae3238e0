"""Cost & capacity plane (port of ``videop2p_tpu/obs/cost.py``, stdlib
only).

Video-P2P serving amortizes one expensive DDIM inversion across many cheap
edits; this module makes that economy measurable. A :class:`CostModel`
attributes every dispatch's MEASURED seconds to its batch members by fair
share:

  * **per-request cost vector** (``REQUEST_COST_FIELDS``) — each terminal
    ``done`` record gains ``cost``: device-seconds (the dispatch's blocked
    seconds split per padded slot), attributed flops and HBM-byte-seconds,
    queue-seconds, and the dispatch's padding share. Store hits are also
    credited ``saved_device_seconds`` / ``saved_flops``: the avoided
    inversion, priced as the measured mean of this engine's fresh
    capture-inversions.
  * **conservation** — ``sum(member device_seconds) + padding_seconds ==
    busy_seconds`` (the sum of successful dispatch durations) by
    construction, and ``idle_seconds = uptime - busy_seconds``. Padding and
    idle are explicit line items, never folded into request cost.
  * **capacity accounting** (``CAPACITY_FIELDS``) — busy/idle fraction,
    padding waste, slot occupancy and cost-per-request ride ``/metrics``.
  * **chargeback** — :meth:`CostModel.attribution_records` yields one
    ``cost_attribution`` row per tenant and per program
    (``COST_ATTRIBUTION_FIELDS``); the engine emits them at close.

STATIC program costs join the vector as in the JAX package: the model is a
``RunLedger`` analysis observer (:meth:`CostModel.observe_program`), fed the
``program_analysis`` record of each program's first call
(``obs/introspect.py``: executed flops and the peak device bytes), so a
slot's ``flops`` and ``hbm_byte_seconds`` and a store hit's ``saved_flops``
are priced from them (0.0 until the program's analysis lands, and when the
analysis is off). Only successful dispatches accrue busy seconds: a failed
attempt's time is a fault-plane fact (retry and breaker events), not
billable work.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "CostModel",
    "STATIC_COST_KEYS",
    "COST_ATTRIBUTION_FIELDS",
    "REQUEST_COST_FIELDS",
    "CAPACITY_FIELDS",
]

# the per-request cost vector every terminal `done` record carries under
# "cost"
REQUEST_COST_FIELDS = (
    "program",
    "device_seconds",
    "flops",
    "hbm_byte_seconds",
    "queue_seconds",
    "padding_share",
    "saved_device_seconds",
    "saved_flops",
)

# one `cost_attribution` ledger event per tenant / per program at engine
# close
COST_ATTRIBUTION_FIELDS = (
    "scope",
    "name",
    "requests",
    "store_hits",
    "device_seconds",
    "flops",
    "hbm_byte_seconds",
    "queue_seconds",
    "saved_device_seconds",
    "saved_flops",
    "cost_per_request_s",
)

# the engine-level capacity record (`/metrics` "capacity" + the
# engine-scope cost_attribution row): the conservation invariant made
# machine-readable — attributed + padding == busy, idle = uptime - busy
CAPACITY_FIELDS = (
    "uptime_s",
    "busy_seconds",
    "attributed_seconds",
    "padding_seconds",
    "idle_seconds",
    "busy_fraction",
    "idle_fraction",
    "padding_waste",
    "occupancy",
    "dispatches",
    "real_slots",
    "padded_slots",
    "requests_costed",
    "cost_per_request_s",
    "conservation_residual_s",
)

# the static program_analysis metrics the model keeps per program label
STATIC_COST_KEYS = ("flops", "argument_bytes", "temp_bytes",
                    "peak_hbm_bytes", "bytes_accessed")

_AGG_KEYS = ("requests", "store_hits", "device_seconds", "flops",
             "hbm_byte_seconds", "queue_seconds", "saved_device_seconds",
             "saved_flops")


def _round(v: float, nd: int = 6) -> float:
    try:
        return round(float(v), nd)
    except (TypeError, ValueError):
        return 0.0


class CostModel:
    """Join static program costs with measured dispatch seconds and keep
    the running attribution/capacity books. Thread-safe: the engine's
    worker prices dispatches while ``/metrics`` reads capacity."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # program label -> static metrics (the last analysis supersedes, as
        # in obs/history.py's programs section)
        self._static: Dict[str, Dict[str, float]] = {}
        # measured fresh capture-inversion seconds (the price a store
        # hit avoids): count + sum -> mean
        self._inv_count = 0
        self._inv_seconds = 0.0
        # capacity accumulators (successful dispatches only)
        self._busy_s = 0.0
        self._attributed_s = 0.0
        self._padding_s = 0.0
        self._dispatches = 0
        self._real_slots = 0
        self._padded_slots = 0
        self._flops_attributed = 0.0
        # per-tenant / per-program aggregates of terminal cost vectors
        self._tenants: Dict[str, Dict[str, float]] = {}
        self._programs: Dict[str, Dict[str, float]] = {}

    # ---- static side (program_analysis observer) -------------------------

    def observe_program(self, program: str, record: Dict[str, Any]) -> None:
        """One ``program_analysis`` record (a RunLedger analysis observer):
        keep its numeric static costs under the label; never raises."""
        try:
            vals = {}
            for k in STATIC_COST_KEYS:
                v = record.get(k)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    vals[k] = float(v)
            if vals:
                with self._lock:
                    self._static[str(program)] = vals
        except Exception:  # noqa: BLE001 — observability never takes the run down
            pass

    def static_cost(self, program: str) -> Optional[Dict[str, float]]:
        with self._lock:
            rec = self._static.get(program)
            return dict(rec) if rec else None

    # ---- measured side ---------------------------------------------------

    def note_fresh_inversion(self, seconds: float) -> None:
        """One fresh encode+capture-inversion's measured resolve seconds —
        the price the store lets every later hit on this clip avoid."""
        with self._lock:
            self._inv_count += 1
            self._inv_seconds += max(float(seconds), 0.0)

    def price_dispatch(self, dispatch_s: float, *, real: int, padded: int,
                       program: str = "",
                       singleton: str = "") -> Dict[str, Any]:
        """Attribute one successful dispatch by fair share and return the
        PER-SLOT cost vector each live member receives.

        ``dispatch_s`` splits evenly over the ``padded`` slots: ``real``
        slots are attributed to their requests, the rest is padding waste
        — so attribution + padding sums back to the dispatch exactly.
        Static facts scale the same way: the batched program's flops /
        peak device bytes (looked up under ``program``) are per dispatch, so
        a slot gets ``1/padded`` of them; when only the ``singleton``
        program is known its statics already ARE one slot's. The vector
        names the ``singleton`` program (else ``program``).
        """
        real = max(int(real), 0)
        padded = max(int(padded), 1)
        dt = max(float(dispatch_s), 0.0)
        share_s = dt / padded
        static = self.static_cost(program)
        per_slot_div = float(padded)
        if static is None and singleton and singleton != program:
            static = self.static_cost(singleton)
            per_slot_div = 1.0
        flops_slot = static.get("flops", 0.0) / per_slot_div if static else 0.0
        hbm_slot_s = (static.get("peak_hbm_bytes", 0.0) * dt / per_slot_div
                      if static else 0.0)
        with self._lock:
            self._busy_s += dt
            self._attributed_s += share_s * real
            self._padding_s += share_s * (padded - real)
            self._dispatches += 1
            self._real_slots += real
            self._padded_slots += padded
            self._flops_attributed += flops_slot * real
        return {
            "program": singleton or program,
            "device_seconds": share_s,
            "flops": flops_slot,
            "hbm_byte_seconds": hbm_slot_s,
            "padding_share": (padded - real) / padded,
        }

    def savings(self) -> Dict[str, float]:
        """What one store hit avoided, priced from this same model: the
        measured mean fresh-inversion seconds when any ran in-process;
        otherwise the static ``serve_invert`` flop count priced at the
        observed dispatch throughput (flops attributed per busy second).
        ``saved_flops`` is the static inversion flop count once its
        analysis landed (0.0 before)."""
        inv_static = self.static_cost("serve_invert") or {}
        saved_flops = inv_static.get("flops", 0.0)
        with self._lock:
            if self._inv_count:
                saved_s = self._inv_seconds / self._inv_count
            elif saved_flops > 0.0 and self._flops_attributed > 0.0:
                saved_s = saved_flops * (self._busy_s / self._flops_attributed)
            else:
                saved_s = 0.0
        return {"saved_device_seconds": saved_s, "saved_flops": saved_flops}

    # ---- terminal accounting ---------------------------------------------

    @staticmethod
    def _fold(agg: Dict[str, float], cost: Dict[str, Any]) -> None:
        for k in ("device_seconds", "flops", "hbm_byte_seconds",
                  "queue_seconds", "saved_device_seconds", "saved_flops"):
            v = cost.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                agg[k] += float(v)

    def account_request(self, *, tenant: str, cost: Dict[str, Any],
                        store_hit: bool = False,
                        programs: Optional[Sequence[
                            Tuple[str, Dict[str, Any]]]] = None) -> None:
        """Fold one terminal request's cost vector into the per-tenant and
        per-program chargeback aggregates. ``programs`` optionally splits
        the vector across program labels (e.g. the dispatch slot under
        the edit program and a cold request's fresh inversion under
        ``serve_invert``) — the tenant lane always gets the whole vector,
        the parts must sum to it, and each part counts one request toward
        its label."""
        if programs is None:
            programs = [(str(cost.get("program") or "serve_edit"), cost)]
        with self._lock:
            agg = self._tenants.setdefault(
                str(tenant or "default"), {k: 0.0 for k in _AGG_KEYS})
            agg["requests"] += 1.0
            agg["store_hits"] += 1.0 if store_hit else 0.0
            self._fold(agg, cost)
            for program, part in programs:
                pagg = self._programs.setdefault(
                    str(program), {k: 0.0 for k in _AGG_KEYS})
                pagg["requests"] += 1.0
                pagg["store_hits"] += 1.0 if store_hit else 0.0
                self._fold(pagg, part)

    def tenant_costs(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant cumulative aggregates (``/metrics`` tenants rows:
        the measured device-seconds counters)."""
        with self._lock:
            return {t: dict(a) for t, a in self._tenants.items()}

    # ---- roll-ups --------------------------------------------------------

    def capacity(self, uptime_s: float,
                 requests_costed: Optional[float] = None) -> Dict[str, Any]:
        """The engine-level capacity record (``CAPACITY_FIELDS``)."""
        with self._lock:
            busy = self._busy_s
            attributed = self._attributed_s
            padding = self._padding_s
            dispatches = self._dispatches
            real_slots = self._real_slots
            padded_slots = self._padded_slots
            if requests_costed is None:
                requests_costed = sum(a["requests"]
                                      for a in self._tenants.values())
        uptime = max(float(uptime_s), 0.0)
        idle = max(uptime - busy, 0.0)
        return {
            "uptime_s": _round(uptime),
            "busy_seconds": _round(busy),
            "attributed_seconds": _round(attributed),
            "padding_seconds": _round(padding),
            "idle_seconds": _round(idle),
            "busy_fraction": _round(busy / uptime if uptime else 0.0),
            "idle_fraction": _round(idle / uptime if uptime else 0.0),
            "padding_waste": _round(padding / busy if busy else 0.0),
            "occupancy": _round(real_slots / padded_slots
                                if padded_slots else 1.0),
            "dispatches": dispatches,
            "real_slots": real_slots,
            "padded_slots": padded_slots,
            "requests_costed": _round(requests_costed, 1),
            "cost_per_request_s": _round(attributed / requests_costed
                                         if requests_costed else 0.0),
            "conservation_residual_s": _round(
                busy - (attributed + padding), 9),
        }

    def attribution_records(self, uptime_s: float) -> List[Dict[str, Any]]:
        """The end-of-run ``cost_attribution`` rows: one engine-scope
        capacity roll-up, then one row per tenant and per program
        (``COST_ATTRIBUTION_FIELDS``), deterministically ordered."""
        rows: List[Dict[str, Any]] = [
            {"scope": "engine", "name": "serve",
             **self.capacity(uptime_s)},
        ]
        with self._lock:
            tables = (("tenant", {t: dict(a)
                                  for t, a in self._tenants.items()}),
                      ("program", {p: dict(a)
                                   for p, a in self._programs.items()}))
        for scope, table in tables:
            for name in sorted(table):
                agg = table[name]
                n = agg.get("requests", 0.0)
                rows.append({
                    "scope": scope,
                    "name": name,
                    "requests": _round(n, 1),
                    "store_hits": _round(agg.get("store_hits", 0.0), 1),
                    "device_seconds": _round(agg.get("device_seconds", 0.0)),
                    "flops": _round(agg.get("flops", 0.0), 1),
                    "hbm_byte_seconds": _round(
                        agg.get("hbm_byte_seconds", 0.0), 1),
                    "queue_seconds": _round(agg.get("queue_seconds", 0.0)),
                    "saved_device_seconds": _round(
                        agg.get("saved_device_seconds", 0.0)),
                    "saved_flops": _round(agg.get("saved_flops", 0.0), 1),
                    "cost_per_request_s": _round(
                        agg.get("device_seconds", 0.0) / n if n else 0.0),
                })
        return rows
