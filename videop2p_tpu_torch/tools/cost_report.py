"""Render a run ledger's cost plane as a self-contained HTML showback
(port of ``tools/cost_report.py``: the same flags, exit codes and page).

Usage:  python -m videop2p_tpu_torch.tools.cost_report <ledger.jsonl>
            [--out report.html] [--title TITLE]

The cost & capacity plane's human face: reads the ``cost_attribution``
chargeback rows an :class:`~videop2p_tpu_torch.serve.engine.EditEngine`
(or a loadgen run) left behind — fair-share attribution from
:mod:`videop2p_tpu_torch.obs.cost` — plus the ``program_analysis`` static
costs, and renders:

  * **capacity & waste breakdown** — the engine-scope row's conservation
    accounting: attributed vs padding vs idle device-seconds as explicit
    bars over uptime (attributed + padding = busy; nothing silent),
    batch occupancy and the fleet cost-per-request;
  * **per-tenant chargeback** — requests, attributed device-seconds,
    flops, share-%% of the attributed total, and cache savings (the
    ``saved_device_seconds`` a store hit avoided re-burning);
  * **per-program achieved vs static** — attributed flops per request
    against the XLA static cost model's flops for that program label,
    and the achieved flops/s (an MFU-style "did the measured spend match
    what the compiler priced" column).

Everything is inline (CSS only, no external assets) — the output ships
in a bug report. Tolerates pre-cost-plane ledgers (renders an
empty-state page; exit 0) and exits 2 on missing/unreadable input.

Imports nothing of JAX or ``videop2p_tpu`` (tests/test_torch_tools.py
runs it under an import hook that refuses both).
"""

from __future__ import annotations

import html
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from videop2p_tpu_torch.obs.ledger import read_ledger
from videop2p_tpu_torch.obs.report import (
    _CSS,
    _fmt,
    _last_run,
    _table,
)


def _bar(label: str, frac: float, detail: str, w: int = 420,
         h: int = 20, color: str = "#2a7ab8") -> str:
    """One horizontal share bar (fraction of uptime)."""
    frac = min(max(float(frac or 0.0), 0.0), 1.0)
    return (
        f'<div class=row><svg width="{w}" height="{h}">'
        f'<rect x="0" y="3" width="{w - 120}" height="{h - 6}" '
        f'fill="#eee" stroke="#ccc"/>'
        f'<rect x="0" y="3" width="{frac * (w - 120):.1f}" '
        f'height="{h - 6}" fill="{color}"/>'
        f'<text x="{w - 114}" y="{h - 6}" font-size="11">'
        f"{frac * 100.0:.1f}%</text></svg>"
        f"<span class=meta> {html.escape(label)} — "
        f"{html.escape(detail)}</span></div>"
    )


def render_report(events: Sequence[Dict[str, Any]], *,
                  title: str = "Cost & capacity showback") -> str:
    """One self-contained HTML page from a run's events (pure — tests
    feed synthetic records)."""
    events = [e for e in events if isinstance(e, dict)]
    start = next((e for e in events if e.get("event") == "run_start"), {})
    costs = [e for e in events if e.get("event") == "cost_attribution"]
    engines = [e for e in costs if e.get("scope") == "engine"]
    tenants = [e for e in costs if e.get("scope") == "tenant"]
    programs = [e for e in costs if e.get("scope") == "program"]
    # static flops per program label (LAST analysis wins, like the model)
    static: Dict[str, float] = {}
    for e in events:
        if e.get("event") == "program_analysis" and e.get("program"):
            v = e.get("flops")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                static[str(e["program"])] = float(v)

    body: List[str] = [
        f"<h1>{html.escape(title)}</h1>",
        f"<p class=meta>run <code>"
        f"{html.escape(str(start.get('run_id', '?')))}</code> · "
        f"{len(costs)} cost_attribution row(s) · generated by "
        f"tools/cost_report.py (stdlib+numpy, all assets inline)</p>",
    ]
    if not costs:
        body.append("<p class=meta>(no cost_attribution events — "
                    "pre-cost-plane ledger, or the engine never closed; "
                    "run tools/serve_loadgen.py or an EditEngine "
                    "session)</p>")

    for eng in engines:
        uptime = float(eng.get("uptime_s") or 0.0)
        body.append(f"<h2>Capacity — "
                    f"{html.escape(str(eng.get('label', 'serve')))}</h2>")
        body.append(
            "<p class=meta>conservation: attributed "
            f"{_fmt(eng.get('attributed_seconds'))}s + padding "
            f"{_fmt(eng.get('padding_seconds'))}s = busy "
            f"{_fmt(eng.get('busy_seconds'))}s (residual "
            f"{_fmt(eng.get('conservation_residual_s'))}s); idle "
            f"{_fmt(eng.get('idle_seconds'))}s of "
            f"{_fmt(eng.get('uptime_s'))}s uptime is explicit, never "
            "silently attributed.</p>")
        if uptime > 0:
            body.append(_bar(
                "attributed",
                float(eng.get("attributed_seconds") or 0.0) / uptime,
                "device-seconds charged to requests", color="#2a7a2a"))
            body.append(_bar(
                "padding waste",
                float(eng.get("padding_seconds") or 0.0) / uptime,
                "burned on batch pad slots", color="#e0a040"))
            body.append(_bar(
                "idle", float(eng.get("idle_seconds") or 0.0) / uptime,
                "no dispatch in flight", color="#999999"))
        rows = [[k, _fmt(eng.get(k))] for k in (
            "dispatches", "requests_costed", "busy_fraction",
            "idle_fraction", "padding_waste", "occupancy",
            "real_slots", "padded_slots", "cost_per_request_s")
            if eng.get(k) is not None]
        if rows:
            body.append(_table(rows, ["capacity", "value"]))

    if tenants:
        total = sum(float(t.get("device_seconds") or 0.0) for t in tenants)
        trows = []
        for t in sorted(tenants, key=lambda r: -float(
                r.get("device_seconds") or 0.0)):
            ds = float(t.get("device_seconds") or 0.0)
            share = (100.0 * ds / total) if total > 0 else 0.0
            trows.append([
                str(t.get("name", "?")), _fmt(t.get("requests")),
                _fmt(t.get("store_hits")), f"{ds:.6g}",
                f"{share:.1f}%", _fmt(t.get("flops")),
                _fmt(t.get("queue_seconds")),
                _fmt(t.get("saved_device_seconds")),
                _fmt(t.get("saved_flops")),
                _fmt(t.get("cost_per_request_s")),
            ])
        body.append(
            "<h2>Per-tenant chargeback</h2>"
            "<p class=meta>fair-share attributed device-seconds per lane "
            "(share-% of the attributed total); cache savings are the "
            "device-seconds/flops a store hit avoided re-burning — "
            "amortized inversions show up HERE, not as free.</p>"
            + _table(trows, ["tenant", "requests", "store_hits",
                             "device_s", "share", "flops", "queue_s",
                             "saved_device_s", "saved_flops",
                             "cost/req (s)"]))

    if programs:
        prows = []
        for p in sorted(programs, key=lambda r: str(r.get("name", ""))):
            name = str(p.get("name", "?"))
            reqs = float(p.get("requests") or 0.0)
            ds = float(p.get("device_seconds") or 0.0)
            fl = float(p.get("flops") or 0.0)
            achieved = (fl / ds) if ds > 0 else None
            fl_per_req = (fl / reqs) if reqs > 0 else None
            st = static.get(name)
            ratio = (fl_per_req / st if st and fl_per_req is not None
                     else None)
            prows.append([
                name, _fmt(p.get("requests")), f"{ds:.6g}",
                _fmt(fl_per_req), _fmt(st),
                ("-" if ratio is None else f"{ratio:.2f}x"),
                _fmt(achieved),
                _fmt(p.get("cost_per_request_s")),
            ])
        body.append(
            "<h2>Per-program achieved vs static</h2>"
            "<p class=meta>attributed flops per request against the XLA "
            "static cost model for the label (1.00x = the measured "
            "spend matches what the compiler priced; batched labels "
            "divide by padded slots), plus the achieved flops/s over "
            "attributed device-seconds (MFU-style).</p>"
            + _table(prows, ["program", "requests", "device_s",
                             "flops/req", "static_flops", "vs static",
                             "achieved flops/s", "cost/req (s)"]))

    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
            "</head><body>" + "".join(b for b in body if b)
            + "</body></html>")


def write_report(ledger_path: str, out_path: Optional[str] = None,
                 *, title: str = "Cost & capacity showback") -> str:
    """Render the LAST run of a ledger into a self-contained HTML file
    next to it."""
    events = _last_run(read_ledger(ledger_path))
    out_path = out_path or os.path.splitext(ledger_path)[0] + "_cost.html"
    text = render_report(events, title=title)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def main(argv: List[str]) -> int:
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(__doc__.strip())
        return 0
    args = list(argv[1:])
    out = None
    title = "Cost & capacity showback"
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
        path = write_report(rest[0], out, title=title)
    except OSError as e:
        print(f"cost_report: cannot read {rest[0]}: {e}", file=sys.stderr)
        return 2
    print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
