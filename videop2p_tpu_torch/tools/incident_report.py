"""Render an incident bundle as a self-contained HTML post-mortem (port of
``tools/incident_report.py``: the same flags, exit codes and page).

Usage:  python -m videop2p_tpu_torch.tools.incident_report <bundle_dir>
            [--out report.html] [--title TITLE] [--events N]

The incident plane's human face: reads the atomic bundle an
:class:`videop2p_tpu_torch.obs.incident.IncidentManager` trigger wrote —
``manifest.json`` + the ``flight.jsonl`` ring dump + the ``series.npz``
tsdb snapshot + ``targets.json`` probe snapshots (+ ``crash.txt`` for
crash triggers) — and renders:

  * **the trigger** — kind, detail, wall/monotonic anchors, debounce
    accounting (suppressed repeats), ProgramSpec fingerprints, git sha,
    and the measured flight-recorder overhead (recorded, not asserted);
  * **timeline** — the flight ring's final events wall-ordered by the
    ledger's monotonic ``t``, with faults / breaker transitions / burn
    alerts / incidents highlighted so the minutes before the trigger
    read as a story;
  * **exemplar traces** — the reservoir ``p99_trace_id``/``max_trace_id``
    exemplars from the manifest joined against the ring's ``span``
    events into parent/child trees (a local re-join — the bundle is
    self-contained, no live ledger needed);
  * **series** — every tsdb series in the snapshot as a sparkline with
    the trigger instant marked;
  * **targets** — each registered target's ``/healthz``+``/metrics``
    snapshot at capture time (a dead target renders its error: the
    outage IS the evidence).

Everything is inline (CSS + SVG, no external assets) — the output ships
in a bug report. Tolerates partial bundles (no series → no sparklines,
no spans → no trace section).

Imports nothing of JAX or ``videop2p_tpu`` (tests/test_torch_tools.py
runs it under an import hook that refuses both).
"""

from __future__ import annotations

import html
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from videop2p_tpu_torch.obs.report import (
    _CSS,
    _fmt,
    _table,
)
from videop2p_tpu_torch.obs.spans import SPAN_SEGMENTS
from videop2p_tpu_torch.obs.tsdb import load_series_sidecar

# timeline rows that get the red highlight: the event kinds that usually
# ARE the story of an incident
_HOT_EVENTS = ("fault", "breaker", "incident", "stream_window_retry",
               "crash")


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Bundle JSONL → event dicts, skipping torn/blank lines."""
    events: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        pass
    return events


def _short(e: Dict[str, Any], limit: int = 140) -> str:
    """One event's payload as a compact k=v string for the timeline."""
    parts = []
    for k, v in e.items():
        if k in ("event", "t"):
            continue
        s = str(v)
        if len(s) > 48:
            s = s[:45] + "..."
        parts.append(f"{k}={s}")
    text = " ".join(parts)
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _is_hot(e: Dict[str, Any]) -> bool:
    kind = str(e.get("event", ""))
    if any(kind.startswith(h) for h in _HOT_EVENTS):
        return True
    if kind == "fleet_signals" and e.get("burn_alert"):
        return True
    return bool(kind == "span" and e.get("status")
                not in ("ok", "cached", None))


def _timeline(events: Sequence[Dict[str, Any]], *, last_n: int) -> str:
    """The ring's final ``last_n`` events as a wall-ordered table; hot
    rows (faults, breaker flips, burn alerts, failed spans) highlighted."""
    tail = list(events)[-max(int(last_n), 1):]
    rows, classes = [], []
    for e in tail:
        rows.append([_fmt(e.get("t", "")), str(e.get("event", "?")),
                     _short(e)])
        classes.append("bad" if _is_hot(e) else "")
    note = (f"<p class=meta>last {len(tail)} of {len(events)} ring "
            "event(s); highlighted rows are faults / breaker transitions "
            "/ burn alerts / failed spans.</p>")
    return note + _table(rows, ["t (s)", "event", "detail"], classes)


# ---- exemplar trace join (local — the bundle must stand alone) ----------


def _trace_tree(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Parent/child join over one trace's spans: roots are spans whose
    ``parent_id`` is absent from the id set (an orphan — its parent
    scrolled off the ring — still renders, flagged)."""
    ids = {s.get("span_id") for s in spans}
    children: Dict[Any, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    for s in sorted(spans, key=lambda s: (s.get("wall_ns") or 0)):
        pid = s.get("parent_id")
        if pid and pid in ids:
            children.setdefault(pid, []).append(s)
        else:
            s = dict(s)
            s["_orphan"] = bool(pid)
            roots.append(s)
    for s in roots:
        s.setdefault("_orphan", False)
    return [_attach(r, children) for r in roots]


def _attach(span: Dict[str, Any],
            children: Dict[Any, List[Dict[str, Any]]]) -> Dict[str, Any]:
    node = dict(span)
    node["_children"] = [_attach(c, children)
                         for c in children.get(span.get("span_id"), [])]
    return node


def _render_node(node: Dict[str, Any]) -> str:
    name = str(node.get("name", "?"))
    seg = SPAN_SEGMENTS.get(name)
    status = str(node.get("status", ""))
    bad = status not in ("ok", "cached", "")
    label = (f"<code>{html.escape(name)}</code>"
             + (f" <span class=meta>[{html.escape(seg)}]</span>" if seg else "")
             + f" {_fmt(node.get('duration_s'))}s"
             + (f" <span class=regressed>{html.escape(status)}</span>"
                if bad else f" <span class=meta>{html.escape(status)}</span>")
             + (" <span class=meta>(orphan — parent scrolled off the "
                "ring)</span>" if node.get("_orphan") else ""))
    kids = "".join(f"<li>{_render_node(c)}</li>"
                   for c in node.get("_children", []))
    return label + (f"<ul>{kids}</ul>" if kids else "")


def _exemplar_section(manifest: Dict[str, Any],
                      events: Sequence[Dict[str, Any]]) -> str:
    exemplars = manifest.get("exemplars") or {}
    if not exemplars:
        return ""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for e in events:
        if e.get("event") == "span" and e.get("trace_id"):
            by_trace.setdefault(str(e["trace_id"]), []).append(e)
    out: List[str] = ["<h2>Exemplar traces</h2>",
                      "<p class=meta>the reservoir's p99/max trace-id "
                      "exemplars per program, joined against the ring's "
                      "span events (a trace with no spans left in the "
                      "ring lists id-only).</p>"]
    rows = []
    seen: List[str] = []
    for program, ex in sorted(exemplars.items()):
        for which in ("p99_trace_id", "max_trace_id"):
            tid = (ex or {}).get(which)
            rows.append([program, which.replace("_trace_id", ""),
                         tid or "-",
                         len(by_trace.get(str(tid), [])) if tid else 0])
            if tid and str(tid) not in seen:
                seen.append(str(tid))
    out.append(_table(rows, ["program", "exemplar", "trace_id",
                             "spans in ring"]))
    for tid in seen:
        spans = by_trace.get(tid)
        if not spans:
            continue
        out.append(f"<h3><code>{html.escape(tid)}</code> — "
                   f"{len(spans)} span(s)</h3>")
        out.append("<ul>" + "".join(
            f"<li>{_render_node(n)}</li>"
            for n in _trace_tree(spans)) + "</ul>")
    return "".join(out)


# ---- series sparklines with the trigger instant marked ------------------


def _spark_marked(pts: List[Tuple[float, float]], *, mark_t: Optional[float],
                  label: str, w: int = 260, h: int = 42) -> str:
    """Time-axis sparkline (non-finite points dropped, leaving holes)
    with a vertical tick at the trigger instant when it falls inside the
    series' span."""
    finite = [(t, v) for t, v in pts if math.isfinite(v)]
    if not finite:
        return f"<span class=meta>(no finite points) {html.escape(label)}</span>"
    t_lo, t_hi = pts[0][0], pts[-1][0]
    t_span = (t_hi - t_lo) or 1.0
    vals = [v for _, v in finite]
    lo, hi = min(vals), max(vals)
    v_span = (hi - lo) or 1.0
    coords = []
    for t, v in finite:
        x = 2 + (t - t_lo) / t_span * (w - 4)
        y = h - 3 - (v - lo) / v_span * (h - 6)
        coords.append(f"{x:.1f},{y:.1f}")
    mark = ""
    if mark_t is not None and t_lo <= mark_t <= t_hi:
        x = 2 + (mark_t - t_lo) / t_span * (w - 4)
        mark = (f'<line x1="{x:.1f}" y1="0" x2="{x:.1f}" y2="{h}" '
                f'stroke="#b22222" stroke-dasharray="3,2">'
                "<title>trigger instant</title></line>")
    return (f'<svg width="{w}" height="{h}">'
            f'<polyline fill="none" stroke="#7a4df0" stroke-width="1.5" '
            f'points="{" ".join(coords)}"/>{mark}</svg>'
            f"<span class=meta> {html.escape(label)}</span>")


def _series_section(manifest: Dict[str, Any], bundle: str) -> str:
    path = os.path.join(bundle, "series.npz")
    if not os.path.isfile(path):
        return ""
    try:
        series = load_series_sidecar(path)
    except Exception:  # noqa: BLE001 — a torn sidecar skips sparklines
        return "<h2>Series</h2><p class=meta>(series.npz unreadable)</p>"
    mark_t = manifest.get("monotonic_s")
    mark_t = float(mark_t) if isinstance(mark_t, (int, float)) else None
    out = ["<h2>Series</h2>",
           "<p class=meta>the tsdb snapshot captured with the bundle; "
           "the dashed red tick is the trigger instant (shown when the "
           "series and the trigger share a clock — the in-process "
           "collector's case).</p>"]
    for key in sorted(series):
        pts = series[key]
        vals = [v for _, v in pts]
        gaps = sum(1 for v in vals if not math.isfinite(v))
        label = (f"{key} — {len(vals)} pts"
                 + (f", {gaps} gaps" if gaps else ""))
        out.append("<div class=row>"
                   + _spark_marked(pts, mark_t=mark_t, label=label)
                   + "</div>")
    return "".join(out)


# ---- targets ------------------------------------------------------------


def _targets_section(bundle: str) -> str:
    path = os.path.join(bundle, "targets.json")
    if not os.path.isfile(path):
        return ""
    try:
        with open(path) as f:
            snaps = json.load(f)
    except (OSError, ValueError):
        return "<h2>Targets</h2><p class=meta>(targets.json unreadable)</p>"
    if not isinstance(snaps, dict) or not snaps:
        return ""
    rows, classes = [], []
    for name, snap in sorted(snaps.items()):
        if not isinstance(snap, dict) or "error" in snap:
            err = snap.get("error") if isinstance(snap, dict) else snap
            rows.append([name, "unreachable", str(err), "-", "-"])
            classes.append("bad")
            continue
        hz = snap.get("healthz") or {}
        mt = snap.get("metrics") or {}
        status = str(hz.get("status", "?"))
        rows.append([
            name, status,
            "ok" if hz.get("ok") else "NOT ok",
            _fmt(mt.get("queue_depth", "-")),
            _fmt(mt.get("in_flight", "-")),
        ])
        classes.append("" if hz.get("ok") and status == "ok" else "bad")
    return ("<h2>Targets</h2>"
            "<p class=meta>/healthz + /metrics from every registered "
            "target at capture time; an unreachable target is evidence, "
            "not an omission.</p>"
            + _table(rows, ["target", "status", "healthz", "queue",
                            "in_flight"], classes))


# ---- the page -----------------------------------------------------------


def render_report(bundle: str, *, title: Optional[str] = None,
                  last_n: int = 120) -> str:
    """One self-contained HTML post-mortem from a bundle directory."""
    try:
        with open(os.path.join(bundle, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        manifest = {}
    events = _read_jsonl(os.path.join(bundle, "flight.jsonl"))
    trigger = str(manifest.get("trigger", "?"))
    title = title or f"Incident: {trigger}"
    body: List[str] = [
        f"<h1>{html.escape(title)}</h1>",
        f"<p class=meta>bundle <code>{html.escape(os.path.basename(os.path.abspath(bundle)))}</code>"
        f" · id <code>{html.escape(str(manifest.get('bundle_id', '?')))}</code>"
        f" · {html.escape(str(manifest.get('wall_time', '?')))}"
        f" · generated by tools/incident_report.py (stdlib+numpy, all "
        "assets inline)</p>",
    ]
    if manifest.get("detail"):
        body.append(f"<p><b>{html.escape(str(manifest['detail']))}</b></p>")
    flight = manifest.get("flight") or {}
    rows = [[k, _fmt(v)] for k, v in (
        ("trigger", trigger),
        ("suppressed since last bundle",
         manifest.get("suppressed_since_last")),
        ("cooldown (s)", manifest.get("cooldown_s")),
        ("pid / host", f"{manifest.get('pid')} / "
                       f"{manifest.get('hostname')}"),
        ("git sha", manifest.get("git_sha")),
        ("ring buffered / seen / dropped",
         f"{flight.get('buffered')} / {flight.get('seen')} / "
         f"{flight.get('dropped')}"),
        ("flight record cost (ns, measured)",
         manifest.get("flight_record_ns")),
    ) if v is not None]
    body.append("<h2>Trigger</h2>" + _table(rows, ["field", "value"]))
    ctx = manifest.get("context") or {}
    if ctx:
        body.append("<h3>Context</h3>" + _table(
            [[k, _fmt(v)] for k, v in sorted(ctx.items())],
            ["key", "value"]))
    fps = manifest.get("fingerprints") or {}
    if fps:
        body.append("<h3>ProgramSpec fingerprints</h3>" + _table(
            [[k, _fmt(v)] for k, v in sorted(fps.items())],
            ["spec", "fingerprint"]))
    crash_path = os.path.join(bundle, "crash.txt")
    if os.path.isfile(crash_path):
        try:
            with open(crash_path) as f:
                crash = f.read()
        except OSError:
            crash = "(crash.txt unreadable)"
        body.append("<h2>Crash</h2><pre style='white-space:pre-wrap;"
                    "font-size:.8em;background:#fde4e1;padding:.6em'>"
                    + html.escape(crash[:20000]) + "</pre>")
    if events:
        body.append("<h2>Timeline</h2>" + _timeline(events, last_n=last_n))
    else:
        body.append("<h2>Timeline</h2><p class=meta>(flight.jsonl empty "
                    "or missing — the ring had no events)</p>")
    body.append(_exemplar_section(manifest, events))
    body.append(_series_section(manifest, bundle))
    body.append(_targets_section(bundle))
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
            "</head><body>" + "".join(b for b in body if b)
            + "</body></html>")


def write_report(bundle: str, out_path: Optional[str] = None,
                 *, title: Optional[str] = None, last_n: int = 120) -> str:
    """Render a bundle dir into a self-contained HTML file inside it."""
    bundle = str(bundle).rstrip("/")
    if not os.path.isfile(os.path.join(bundle, "manifest.json")):
        raise OSError(f"{bundle}: not an incident bundle "
                      "(no manifest.json)")
    out_path = out_path or os.path.join(bundle, "report.html")
    text = render_report(bundle, title=title, last_n=last_n)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def main(argv: List[str]) -> int:
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(__doc__.strip())
        return 0
    args = list(argv[1:])
    out: Optional[str] = None
    title: Optional[str] = None
    last_n = 120
    rest: List[str] = []
    i = 0
    while i < len(args):
        if args[i] == "--out" and i + 1 < len(args):
            out = args[i + 1]
            i += 2
        elif args[i] == "--title" and i + 1 < len(args):
            title = args[i + 1]
            i += 2
        elif args[i] == "--events" and i + 1 < len(args):
            last_n = int(args[i + 1])
            i += 2
        else:
            rest.append(args[i])
            i += 1
    if len(rest) != 1:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    try:
        path = write_report(rest[0], out, title=title, last_n=last_n)
    except OSError as e:
        print(f"incident_report: {e}", file=sys.stderr)
        return 2
    print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
