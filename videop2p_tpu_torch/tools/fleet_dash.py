"""Render a fleet-collector ledger as a self-contained HTML dashboard
(port of ``tools/fleet_dash.py``: the same flags, exit codes and page).

Usage:  python -m videop2p_tpu_torch.tools.fleet_dash <collector_ledger.jsonl>
            [--out dash.html] [--title TITLE]

The telemetry plane's human face: reads the ``fleet_signals``
evaluations and the ``fleet_series`` tsdb snapshot a
:class:`videop2p_tpu_torch.serve.collector.FleetCollector` run left
behind (``python -m videop2p_tpu_torch.tools.serve_loadgen --collector``
wires one up) and renders:

  * **burn gauges** — the last evaluation's fast/slow-window burn rates
    as bars against the alert threshold, plus the burn history;
  * **scale-advice timeline** — one colored cell per evaluation
    (grow/hold/shrink) so a degraded window is visible at a glance;
  * **per-series sparklines** — every series in the ``fleet_series``
    ``.npz`` sidecar (queue depth, in-flight, latency percentiles,
    per-status request counters, per-tenant meters, scrape health) with
    gap markers preserved — a dead replica's outage shows as a hole,
    never an interpolated line;
  * **per-tenant demand table** — submitted/served/shed rates and
    device-seconds per lane from the last evaluation;
  * **cost panel** — engine utilization/padding-waste and the
    per-tenant attributed device-seconds from the run's
    ``cost_attribution`` chargeback rows (full showback:
    ``python -m videop2p_tpu_torch.tools.cost_report``);
  * **correctness panel** — per-target known-answer probe
    verdicts and every cross-replica answer-audit divergence with its
    content-hash pair (full report:
    ``python -m videop2p_tpu_torch.tools.probe_report``).

Everything is inline (CSS + SVG, no external assets) — the output ships
in a bug report. Tolerates signal-only ledgers (no snapshot event → no
sparkline section) and older ledgers (renders an empty-state page).

Imports nothing of JAX or ``videop2p_tpu`` (tests/test_torch_tools.py
runs it under an import hook that refuses both).
"""

from __future__ import annotations

import html
import math
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.ledger import read_ledger
from videop2p_tpu_torch.obs.report import (
    _CSS,
    _fmt,
    _last_run,
    _svg_spark,
    _table,
)
from videop2p_tpu_torch.obs.tsdb import load_series_sidecar

_ADVICE_COLOR = {"grow": "#b22222", "hold": "#999999", "shrink": "#2a7ab8"}


def _burn_gauge(label: str, burn: float, threshold: float,
                w: int = 320, h: int = 22) -> str:
    """One horizontal burn bar: fill is burn relative to 3x threshold,
    red past the threshold tick."""
    burn = max(float(burn or 0.0), 0.0)
    thr = max(float(threshold), 1e-9)
    cap = 3.0 * thr
    frac = min(burn / cap, 1.0)
    tick = min(thr / cap, 1.0)
    color = "#b22222" if burn > thr else "#2a7a2a"
    return (
        f'<div class=row><svg width="{w}" height="{h}">'
        f'<rect x="0" y="3" width="{w - 70}" height="{h - 6}" '
        f'fill="#eee" stroke="#ccc"/>'
        f'<rect x="0" y="3" width="{frac * (w - 70):.1f}" height="{h - 6}" '
        f'fill="{color}"/>'
        f'<line x1="{tick * (w - 70):.1f}" y1="0" '
        f'x2="{tick * (w - 70):.1f}" y2="{h}" stroke="#333" '
        f'stroke-dasharray="2,2"/>'
        f'<text x="{w - 64}" y="{h - 7}" font-size="11">{burn:.2f}x</text>'
        f'</svg><span class=meta> {html.escape(label)} '
        f'(alert past {threshold:g})</span></div>'
    )


def _advice_timeline(sigs: Sequence[Dict[str, Any]], w_cell: int = 14,
                     h: int = 26,
                     incidents: Sequence[Dict[str, Any]] = ()) -> str:
    if not sigs:
        return ""
    cells = []
    for i, e in enumerate(sigs):
        advice = str(e.get("scale_advice", "?"))
        color = _ADVICE_COLOR.get(advice, "#e0c040")
        title = (f"eval {i}: {advice}"
                 + (f" — {'; '.join(map(str, e.get('reasons') or []))}"
                    if e.get("reasons") else ""))
        cells.append(
            f'<rect x="{i * w_cell}" y="2" width="{w_cell - 2}" '
            f'height="{h - 4}" fill="{color}">'
            f"<title>{html.escape(title)}</title></rect>")
    # incident markers: a red diamond over the evaluation the
    # capture landed in (matched by ledger `t`), tooltip carrying trigger
    # kind + bundle path — the dashboard names the evidence directory
    for inc in incidents:
        it = inc.get("t")
        idx = len(sigs) - 1
        if isinstance(it, (int, float)):
            idx = next((i for i, e in enumerate(sigs)
                        if isinstance(e.get("t"), (int, float))
                        and e["t"] >= it), len(sigs) - 1)
        cx = idx * w_cell + (w_cell - 2) / 2
        title = (f"incident {inc.get('trigger', '?')}: "
                 f"{inc.get('detail', '')} — bundle "
                 f"{inc.get('bundle', '?')}")
        cells.append(
            f'<path d="M {cx:.1f} 0 l 5 6 l -5 6 l -5 -6 z" '
            f'fill="#b22222" stroke="#fff" stroke-width="1">'
            f"<title>{html.escape(title)}</title></path>")
    w = len(sigs) * w_cell
    legend = " ".join(
        f'<span style="color:{c}">■</span> {a}'
        for a, c in _ADVICE_COLOR.items())
    if incidents:
        legend += (' <span style="color:#b22222">◆</span> '
                   f"incident ({len(incidents)})")
    return (f'<div class=row><svg width="{w}" height="{h}">'
            + "".join(cells) + f"</svg><span class=meta> {legend}</span></div>")


def _series_sparklines(series: Dict[str, List[Tuple[float, float]]]) -> str:
    """One sparkline per stored series, NaN gaps preserved as breaks
    (``_svg_spark`` drops non-finite points, leaving a visible hole)."""
    out: List[str] = []
    for key in sorted(series):
        pts = series[key]
        vals = [v for _, v in pts]
        finite = [v for v in vals if not math.isnan(v)]
        gaps = len(vals) - len(finite)
        label = (f"{key} — {len(vals)} pts"
                 + (f", {gaps} gaps" if gaps else "")
                 + (f", last {finite[-1]:.4g}" if finite else ""))
        out.append("<div class=row>" + _svg_spark(vals, label=label)
                   + "</div>")
    return "".join(out)


def render_dash(events: Sequence[Dict[str, Any]],
                series: Optional[Dict[str, List[Tuple[float, float]]]] = None,
                *, title: str = "Fleet dashboard") -> str:
    """One self-contained HTML page from a collector run's events (+ the
    decoded ``fleet_series`` sidecar when available)."""
    events = [e for e in events if isinstance(e, dict)]
    start = next((e for e in events if e.get("event") == "run_start"), {})
    sigs = [e for e in events if e.get("event") == "fleet_signals"]
    incidents = [e for e in events if e.get("event") == "incident"]
    costs = [e for e in events if e.get("event") == "cost_attribution"]
    probes = [e for e in events if e.get("event") == "probe"]
    audits = [e for e in events if e.get("event") == "probe_audit"]
    snap = next((e for e in reversed(events)
                 if e.get("event") == "fleet_series"), None)
    body: List[str] = [
        f"<h1>{html.escape(title)}</h1>",
        f"<p class=meta>run <code>"
        f"{html.escape(str(start.get('run_id', '?')))}</code> · "
        f"{len(sigs)} signal evaluation(s) · generated by "
        f"tools/fleet_dash.py (stdlib+numpy, all assets inline)</p>",
    ]
    if not sigs and snap is None:
        body.append("<p class=meta>(no fleet_signals / fleet_series events "
                    "— run the collector: tools/serve_loadgen.py "
                    "--collector)</p>")
    if sigs:
        last = sigs[-1]
        threshold = 1.0
        body.append("<h2>Burn gauges</h2>")
        body.append("<p class=meta>error-rate burn per trailing window "
                    f"(window_scale {_fmt(last.get('window_scale'))}: fast "
                    f"{_fmt(last.get('fast_window_s'))}s / slow "
                    f"{_fmt(last.get('slow_window_s'))}s); the page-worthy "
                    "alert needs BOTH windows past the tick.</p>")
        body.append(_burn_gauge("fast window",
                                last.get("burn_fast") or 0.0, threshold))
        body.append(_burn_gauge("slow window",
                                last.get("burn_slow") or 0.0, threshold))
        body.append("<div class=row>" + _svg_spark(
            [e.get("burn_fast") for e in sigs],
            label=f"fast-burn history, alerts fired "
                  f"{_fmt(last.get('burn_alerts'))}") + "</div>")
        body.append("<h2>Scale advice</h2>")
        body.append(_advice_timeline(sigs, incidents=incidents))
        body.append(
            f"<p class=meta>last advice: "
            f"<b>{html.escape(str(last.get('scale_advice', '?')))}</b>"
            + ("; reasons: " + "; ".join(
                html.escape(str(r)) for r in last.get("reasons") or [])
               if last.get("reasons") else "") + "</p>")
        rows = [[k, _fmt(last.get(k))] for k in (
            "error_rate_fast", "error_rate_slow", "queue_slope",
            "inflight_slope", "saturation", "latency_p99_s",
            "store_hit_rate", "replicas_up", "replicas_total",
            "scrape_errors", "scrape_error_rate", "latency_anomaly",
            "store_hit_anomaly", "utilization", "idle_fraction",
            "padding_waste", "cost_per_request_s", "demand_rps",
            "capacity_rps", "headroom_rps",
            "utilization_forecast") if last.get(k) is not None]
        if rows:
            body.append("<h2>Latest signals</h2>"
                        + _table(rows, ["signal", "value"]))
        tenants = last.get("tenants")
        if isinstance(tenants, dict) and tenants:
            trows = [[t, _fmt(v.get("submitted_rate")),
                      _fmt(v.get("served_rate")), _fmt(v.get("shed_rate")),
                      _fmt(v.get("device_seconds"))]
                     for t, v in sorted(tenants.items())
                     if isinstance(v, dict)]
            body.append("<h2>Per-tenant demand</h2>"
                        "<p class=meta>submitted/served/shed rates over "
                        "the slow window; device-seconds measured from the "
                        "scraped cost plane when present, else estimated "
                        "from the dispatch p50.</p>"
                        + _table(trows, ["tenant", "submit/s", "served/s",
                                         "shed/s", "device_s"]))
    # cost panel: the chargeback rows loadgen lands as
    # cost_attribution extra events — utilization per engine, attributed
    # device-seconds per tenant lane; absent for pre-cost-plane ledgers
    if costs:
        eng_rows = [[str(e.get("label", "serve")),
                     _fmt(e.get("busy_fraction")),
                     _fmt(e.get("idle_fraction")),
                     _fmt(e.get("padding_waste")),
                     _fmt(e.get("occupancy")),
                     _fmt(e.get("cost_per_request_s"))]
                    for e in costs if e.get("scope") == "engine"]
        ten_rows = [[str(e.get("name", "?")), _fmt(e.get("requests")),
                     _fmt(e.get("device_seconds")), _fmt(e.get("flops")),
                     _fmt(e.get("saved_device_seconds"))]
                    for e in costs if e.get("scope") == "tenant"]
        body.append("<h2>Cost &amp; capacity</h2>"
                    "<p class=meta>fair-share attribution "
                    "(cost_attribution events — obs/cost.py); full "
                    "showback: tools/cost_report.py &lt;ledger&gt;.</p>")
        if eng_rows:
            body.append(_table(eng_rows, ["engine", "busy_frac",
                                          "idle_frac", "padding_waste",
                                          "occupancy", "cost/req (s)"]))
        if ten_rows:
            body.append(_table(ten_rows, ["tenant", "requests", "device_s",
                                          "flops", "saved_device_s"]))
    # correctness panel: the prober's known-answer verdicts —
    # per-target pass/fail counts plus every answer-audit divergence with
    # its hash pair; full report: tools/probe_report.py
    if probes or audits:
        divergent = {str(a.get("divergent")) for a in audits}
        tallies: Dict[str, List[int]] = {}
        for e in probes:
            t = tallies.setdefault(str(e.get("target", "?")), [0, 0])
            t[0] += 1
            t[1] += 0 if e.get("ok") else 1
        prows = [[tname, _fmt(n), _fmt(bad),
                  ("DIVERGENT — quarantine" if tname in divergent
                   else ("failing" if bad else "ok"))]
                 for tname, (n, bad) in sorted(tallies.items())]
        pmarks = [("bad" if r[3] != "ok" else "") for r in prows]
        body.append("<h2>Correctness probes</h2>"
                    "<p class=meta>known-answer canaries + cross-replica "
                    "answer audit (probe/probe_audit events); full "
                    "report: tools/probe_report.py &lt;ledger&gt;.</p>")
        if prows:
            body.append(_table(prows, ["target", "probes", "failed",
                                       "verdict"], pmarks))
        if audits:
            arows = [[str(a.get("divergent", "?")),
                      str(a.get("hash_b", ""))[:16],
                      str(a.get("replica_a", "?")),
                      str(a.get("hash_a", ""))[:16]]
                     for a in audits]
            body.append(_table(arows, ["divergent", "its hash",
                                       "reference", "ref hash"],
                               ["bad"] * len(arows)))
    if incidents:
        irows = [[_fmt(e.get("t", "")), str(e.get("trigger", "?")),
                  str(e.get("detail", ""))[:120],
                  str(e.get("bundle", "?")), _fmt(e.get("suppressed", 0))]
                 for e in incidents]
        body.append("<h2>Incidents</h2>"
                    "<p class=meta>capture bundles this run — render one "
                    "with tools/incident_report.py &lt;bundle&gt;.</p>"
                    + _table(irows, ["t (s)", "trigger", "detail",
                                     "bundle", "suppressed"],
                             ["bad"] * len(irows)))
    if snap is not None:
        body.append("<h2>Series</h2>")
        body.append(
            f"<p class=meta>tsdb snapshot: {_fmt(snap.get('series'))} "
            f"series / {_fmt(snap.get('samples'))} samples, "
            f"{_fmt(snap.get('gaps'))} gap(s), "
            f"{_fmt(snap.get('dropped'))} dropped, span "
            f"[{_fmt(snap.get('t_first'))}, {_fmt(snap.get('t_last'))}]s"
            "</p>")
        if series:
            body.append(_series_sparklines(series))
        elif snap.get("sidecar"):
            body.append(f"<p class=meta>(sidecar "
                        f"{html.escape(str(snap['sidecar']))} not found — "
                        "sparklines omitted)</p>")
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
            "</head><body>" + "".join(b for b in body if b)
            + "</body></html>")


def _find_series(events: Sequence[Dict[str, Any]], ledger_path: str,
                 ) -> Optional[Dict[str, List[Tuple[float, float]]]]:
    snap = next((e for e in reversed(events)
                 if isinstance(e, dict) and e.get("event") == "fleet_series"
                 and e.get("sidecar")), None)
    if snap is None:
        return None
    sc = str(snap["sidecar"])
    for cand in (sc, os.path.join(os.path.dirname(os.path.abspath(
            ledger_path)), os.path.basename(sc))):
        if os.path.isfile(cand):
            try:
                return load_series_sidecar(cand)
            except Exception:  # noqa: BLE001 — a torn sidecar skips sparklines
                return None
    return None


def write_dash(ledger_path: str, out_path: Optional[str] = None,
               *, title: str = "Fleet dashboard") -> str:
    """Render the LAST run of a collector ledger into a self-contained
    HTML file next to it."""
    events = _last_run(read_ledger(ledger_path))
    series = _find_series(events, ledger_path)
    out_path = out_path or os.path.splitext(ledger_path)[0] + "_fleet.html"
    text = render_dash(events, series, title=title)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def main(argv: List[str]) -> int:
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(__doc__.strip())
        return 0
    args = list(argv[1:])
    out = None
    title = "Fleet dashboard"
    rest: List[str] = []
    i = 0
    while i < len(args):
        if args[i] == "--out" and i + 1 < len(args):
            out = args[i + 1]
            i += 2
        elif args[i] == "--title" and i + 1 < len(args):
            title = args[i + 1]
            i += 2
        else:
            rest.append(args[i])
            i += 1
    if len(rest) != 1:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    try:
        path = write_dash(rest[0], out, title=title)
    except OSError as e:
        print(f"fleet_dash: cannot read {rest[0]}: {e}", file=sys.stderr)
        return 2
    print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
