"""Render a prober ledger as a self-contained HTML correctness report
(port of ``tools/probe_report.py``: the same flags, exit codes and page).

Usage:  python -m videop2p_tpu_torch.tools.probe_report <prober_ledger.jsonl>
            [--out report.html] [--title TITLE]

The correctness plane's human face: reads the ``probe`` and
``probe_audit`` events a :class:`videop2p_tpu_torch.serve.prober.FleetProber`
run left behind (``python -m videop2p_tpu_torch.tools.serve_loadgen
--probes`` wires one up) and renders:

  * **pass/fail timeline** — one colored cell per probe verdict in
    ledger order (green pass / red fail), grouped per target, tooltips
    carrying the probe kind and failure detail;
  * **divergence table** — every cross-replica answer-audit divergence
    with the offending pair of replica names and their content hashes —
    the wrong-but-healthy signature (the bytes, not the health checks,
    disagree);
  * **per-probe latency sparklines** — canary round-trip latency per
    (target, probe kind) pair, the reserved probe tenant's view of the
    serving path;
  * **per-target scoreboard** — probes run / failed / success rate per
    target, quarantine-worthy targets flagged.

Everything is inline (CSS + SVG, no external assets) — the output ships
in a bug report. Tolerates probe-free ledgers (renders an empty-state
page pointing at ``--probes``).

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
    _svg_spark,
    _table,
)


def _verdict_timeline(records: Sequence[Dict[str, Any]], w_cell: int = 14,
                      h: int = 26) -> str:
    """One green/red cell per probe verdict in ledger order, tooltip
    naming the probe kind (+ failure detail)."""
    if not records:
        return ""
    cells = []
    for i, e in enumerate(records):
        ok = bool(e.get("ok"))
        color = "#2a7a2a" if ok else "#b22222"
        title = (f"{e.get('probe', '?')}: {'pass' if ok else 'FAIL'}"
                 + (f" — {e.get('detail', '')}" if not ok else ""))
        cells.append(
            f'<rect x="{i * w_cell}" y="2" width="{w_cell - 2}" '
            f'height="{h - 4}" fill="{color}">'
            f"<title>{html.escape(title)}</title></rect>")
    w = len(records) * w_cell
    return (f'<div class=row><svg width="{w}" height="{h}">'
            + "".join(cells)
            + '</svg><span class=meta> <span style="color:#2a7a2a">■</span> '
              'pass <span style="color:#b22222">■</span> fail</span></div>')


def render_probe_report(events: Sequence[Dict[str, Any]], *,
                        title: str = "Correctness report") -> str:
    """One self-contained HTML page from a prober run's events."""
    events = [e for e in events if isinstance(e, dict)]
    start = next((e for e in events if e.get("event") == "run_start"), {})
    probes = [e for e in events if e.get("event") == "probe"]
    audits = [e for e in events if e.get("event") == "probe_audit"]
    body: List[str] = [
        f"<h1>{html.escape(title)}</h1>",
        f"<p class=meta>run <code>"
        f"{html.escape(str(start.get('run_id', '?')))}</code> · "
        f"{len(probes)} probe verdict(s), {len(audits)} answer-audit "
        f"divergence(s) · generated by tools/probe_report.py "
        f"(stdlib+numpy, all assets inline)</p>",
    ]
    if not probes and not audits:
        body.append("<p class=meta>(no probe / probe_audit events — run "
                    "the prober: tools/serve_loadgen.py --probes)</p>")
    by_target: Dict[str, List[Dict[str, Any]]] = {}
    for e in probes:
        by_target.setdefault(str(e.get("target", "?")), []).append(e)
    if by_target:
        divergent = {str(a.get("divergent")) for a in audits}
        rows = []
        for tname in sorted(by_target):
            recs = by_target[tname]
            fails = sum(1 for e in recs if not e.get("ok"))
            note = ("DIVERGENT — quarantine" if tname in divergent
                    else ("failing" if fails else "ok"))
            rows.append([tname, _fmt(len(recs)), _fmt(fails),
                         _fmt(round(1.0 - fails / len(recs), 4)), note])
        marks = [("bad" if r[4] != "ok" else "") for r in rows]
        body.append("<h2>Scoreboard</h2>"
                    "<p class=meta>known-answer probes per target — a "
                    "divergent target passes its OWN checks; only the "
                    "cross-replica hash audit names it.</p>"
                    + _table(rows, ["target", "probes", "failed",
                                    "success_rate", "verdict"], marks))
        body.append("<h2>Pass/fail timeline</h2>")
        for tname in sorted(by_target):
            body.append(f"<p class=meta>{html.escape(tname)}</p>"
                        + _verdict_timeline(by_target[tname]))
    if audits:
        arows = [[str(a.get("fingerprint", "?"))[:16],
                  str(a.get("divergent", "?")),
                  str(a.get("hash_b", ""))[:16],
                  str(a.get("replica_a", "?")),
                  str(a.get("hash_a", ""))[:16],
                  _fmt(a.get("targets")), _fmt(a.get("hashes"))]
                 for a in audits]
        body.append("<h2>Answer-audit divergences</h2>"
                    "<p class=meta>same ProgramSpec fingerprint, same "
                    "canary, different bytes — each row is one "
                    "wrong-but-healthy replica and the reference it "
                    "disagrees with (hashes truncated to 16 hex "
                    "chars).</p>"
                    + _table(arows, ["fingerprint", "divergent", "its hash",
                                     "reference", "ref hash", "targets",
                                     "hashes"], ["bad"] * len(arows)))
    lat_keys = sorted({(str(e.get("target", "?")), str(e.get("probe", "?")))
                       for e in probes})
    if lat_keys:
        body.append("<h2>Probe latency</h2>"
                    "<p class=meta>canary round-trip seconds per (target, "
                    "probe) — the reserved low-priority probe tenant's "
                    "view of the serving path.</p>")
        for tname, pname in lat_keys:
            vals = [float(e.get("latency_s") or 0.0) for e in probes
                    if str(e.get("target")) == tname
                    and str(e.get("probe")) == pname]
            body.append("<div class=row>" + _svg_spark(
                vals, label=f"{tname} · {pname} — "
                            f"last {vals[-1]:.3f}s") + "</div>")
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
            "</head><body>" + "".join(b for b in body if b)
            + "</body></html>")


def write_probe_report(ledger_path: str, out_path: Optional[str] = None,
                       *, title: str = "Correctness report") -> str:
    """Render the LAST run of a prober ledger into a self-contained HTML
    file next to it."""
    events = _last_run(read_ledger(ledger_path))
    out_path = out_path or os.path.splitext(ledger_path)[0] + "_probes.html"
    text = render_probe_report(events, title=title)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def main(argv: List[str]) -> int:
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(__doc__.strip())
        return 0
    args = list(argv[1:])
    out = None
    title = "Correctness report"
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
        path = write_probe_report(rest[0], out, title=title)
    except OSError as e:
        print(f"probe_report: cannot read {rest[0]}: {e}", file=sys.stderr)
        return 2
    print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
