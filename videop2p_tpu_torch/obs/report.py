"""Self-contained HTML edit report from a run ledger + ``.npz`` sidecar
(port of ``videop2p_tpu/obs/report.py``: the same sections, so a ledger of
either package renders alike).

One file, no servers, no plotting stack: stdlib + numpy only (PNGs are
encoded by hand through ``zlib``, curves are inline SVG), so the report
renders on any box — a laptop the ledger was scp'd to included. This is
the repo's equivalent of Prompt-to-Prompt's ``show_cross_attention``
(Hertz et al., 2022) plus the quality/regression evidence around it:

  * per-word cross-attention heatmap grids across steps (from the
    in-program capture, ``obs/attention.py``);
  * LocalBlend mask overlays on the edited frames + coverage curves;
  * the null-text optimization loss sparkline (full mode);
  * the edit-quality table (``obs/quality.py`` PSNR/SSIM metrics);
  * the regression verdicts (``obs/history.py`` rules), quality
    rules included;
  * a communication section for sharded runs (``obs/comm.py`` events):
    per-program collective counts/bytes, per-device telemetry with the
    cross-replica divergence verdict (must be 0.0), and per-host phase
    skew when host_phase events exist;
  * a "Where time goes" section (``obs/timing.py`` events, and
    ``trace_analysis`` events where a ledger holds them): per-program
    execute-latency distributions and device-trace breakdowns, a
    ``trace`` event's directory mined here (``obs/trace.py``'s
    chrome-trace reader);
  * a request critical-path + SLO section (``obs/spans.py`` /
    ``obs/slo.py`` events): per-segment queue/resolve/
    dispatch/decode percentiles over the run's spans and the
    per-objective error-budget-burn table.

``python -m videop2p_tpu_torch.obs.report <ledger.jsonl> [-o report.html]
[--sidecar X.npz]`` renders one, as does ``python -m
videop2p_tpu_torch.tools.edit_report`` (JAX's ``tools/edit_report.py`` renders
the same page from the same ledger; the page's own text names the JAX
tools, as JAX's does). The ledger is parsed with a local JSONL reader (not
``obs.ledger``), so this module needs numpy and the stdlib only.
"""

from __future__ import annotations

import base64
import html
import json
import os
import struct
import sys
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["render_report", "write_report", "main"]

_MAX_HEAT_COLUMNS = 8  # steps shown per heatmap row
_HEAT_SCALE = 6  # nearest-neighbor upsample factor for heat tiles

# magma-like anchors (dark → bright), lerped in _colormap
_CMAP = np.array(
    [
        [0, 0, 4], [40, 11, 84], [101, 21, 110], [159, 42, 99],
        [212, 72, 66], [245, 125, 21], [250, 193, 39], [252, 253, 191],
    ],
    dtype=np.float64,
)

_CSS = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 70em;
       color: #1a1a1a; background: #fcfcfa; }
h1 { font-size: 1.4em; } h2 { font-size: 1.1em; margin-top: 1.6em;
     border-bottom: 1px solid #ddd; padding-bottom: .2em; }
table { border-collapse: collapse; font-size: .9em; }
td, th { border: 1px solid #ddd; padding: .25em .6em; text-align: left; }
th { background: #f0efe9; }
.meta { color: #666; font-size: .85em; }
.word { font-weight: 600; margin-right: .6em; }
.tile { image-rendering: pixelated; border: 1px solid #ccc; margin: 1px; }
.row { margin: .35em 0; white-space: nowrap; overflow-x: auto; }
.steplab { color: #888; font-size: .7em; margin-right: .35em; }
.bad { background: #fde4e1; }
.ok { color: #2a7a2a; } .regressed { color: #b22; font-weight: 600; }
svg { vertical-align: middle; }
"""


# ------------------------------------------------------------ primitives --


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Ledger JSONL → event dicts, skipping torn/blank lines (a local
    re-implementation of obs.ledger.read_ledger so the import closure
    stays stdlib+numpy)."""
    events = []
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
    return events


def _last_run(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Ledger files append across invocations — keep the final run."""
    runs: List[List[Dict[str, Any]]] = []
    for e in events:
        if e.get("event") == "run_start" or not runs:
            runs.append([])
        runs[-1].append(e)
    return runs[-1] if runs else []


def _png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes (filter 0 rows, one zlib IDAT)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _img(rgb: np.ndarray, *, title: str = "", cls: str = "tile") -> str:
    uri = "data:image/png;base64," + base64.b64encode(_png(rgb)).decode()
    t = f' title="{html.escape(title, quote=True)}"' if title else ""
    return f'<img class="{cls}" src="{uri}"{t}>'


def _colormap(x: np.ndarray) -> np.ndarray:
    """[0, 1] floats → (…, 3) uint8 via the magma-like anchor table."""
    x = np.clip(np.nan_to_num(np.asarray(x, np.float64)), 0.0, 1.0)
    pos = x * (len(_CMAP) - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(_CMAP) - 1)
    frac = pos - lo
    out = _CMAP[lo] * (1.0 - frac[..., None]) + _CMAP[hi] * frac[..., None]
    return out.astype(np.uint8)


def _upsample(img: np.ndarray, scale: int) -> np.ndarray:
    return np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)


def _heat_tile(heat2d: np.ndarray, vmax: float, scale: int = _HEAT_SCALE) -> np.ndarray:
    return _upsample(_colormap(heat2d / max(vmax, 1e-12)), scale)


def _svg_spark(values: Sequence[float], *, w: int = 260, h: int = 42,
               label: str = "") -> str:
    """Inline SVG polyline sparkline; non-finite points are dropped."""
    vals = [float(v) for v in values if v is not None]
    finite = [v for v in vals if np.isfinite(v)]
    if not finite:
        return "<span class=meta>(no finite points)</span>"
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    pts = []
    n = max(len(vals) - 1, 1)
    for i, v in enumerate(vals):
        if not np.isfinite(v):
            continue
        x = 2 + i * (w - 4) / n
        y = h - 3 - (v - lo) / span * (h - 6)
        pts.append(f"{x:.1f},{y:.1f}")
    tail = f"<span class=meta> {label}</span>" if label else ""
    return (f'<svg width="{w}" height="{h}">'
            f'<polyline fill="none" stroke="#7a4df0" stroke-width="1.5" '
            f'points="{" ".join(pts)}"/></svg>{tail}')


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if not np.isfinite(v):
            return "inf" if v > 0 else ("-inf" if v < 0 else "nan")
        return f"{v:.4g}"
    return html.escape(str(v))


def _table(rows: List[List[Any]], header: List[str],
           row_classes: Optional[List[str]] = None) -> str:
    out = ["<table><tr>" + "".join(f"<th>{html.escape(h)}</th>" for h in header)
           + "</tr>"]
    for i, r in enumerate(rows):
        cls = f' class="{row_classes[i]}"' if row_classes and row_classes[i] else ""
        out.append(f"<tr{cls}>" + "".join(f"<td>{_fmt(c)}</td>" for c in r)
                   + "</tr>")
    out.append("</table>")
    return "".join(out)


# --------------------------------------------------------------- sections --


def _heat_key(scope: str) -> str:
    return f"attn_{scope}/cross_heat"


def _word_heat_section(events, sidecar) -> str:
    """Per-word heatmap grids across steps, one block per capture scope
    (inversion = the source stream's walk, edit = the edit streams)."""
    blocks = []
    for e in events:
        if e.get("event") != "attn_maps":
            continue
        scope = e.get("scope") or e.get("program") or "edit"
        heat = sidecar.get(_heat_key(scope))
        if heat is None or getattr(heat, "ndim", 0) != 5:
            continue
        T, C, rh, rw, L = heat.shape
        streams = list(e.get("streams") or range(C))
        step_ids = sorted({
            int(round(i * (T - 1) / max(min(T, _MAX_HEAT_COLUMNS) - 1, 1)))
            for i in range(min(T, _MAX_HEAT_COLUMNS))
        })
        rows = []
        for wrec in e.get("words") or []:
            tokens = [t for t in wrec.get("tokens", []) if 0 <= int(t) < L]
            pi = wrec.get("prompt", 0)
            if not tokens or pi not in streams:
                continue
            s = streams.index(pi)
            wheat = heat[:, s][..., tokens].sum(-1)  # (T, rh, rw)
            vmax = float(wheat.max())
            tiles = "".join(
                f'<span class=steplab>{t}</span>' + _img(
                    _heat_tile(wheat[t], vmax),
                    title=f"step {t}, word {wrec.get('word')!r}",
                )
                for t in step_ids
            )
            rows.append(
                f'<div class=row><span class=word>'
                f'{html.escape(str(wrec.get("word")))}'
                f'</span><span class=meta>(prompt {pi})</span><br>{tiles}</div>'
            )
        if rows:
            blocks.append(
                f"<h3>{html.escape(scope)} — {T} steps, "
                f"heat {rh}×{rw}</h3>" + "".join(rows)
            )
    if not blocks:
        return ""
    return ("<h2>Per-word cross-attention heatmaps</h2>"
            "<p class=meta>head/site/frame-averaged attention per token, "
            "pooled in-program (obs/attention.py); columns are DDIM steps, "
            "brightness normalized per word.</p>" + "".join(blocks))


def _mask_section(events, sidecar) -> str:
    attn_ev = next((e for e in events if e.get("event") == "attn_maps"
                    and f"attn_{e.get('scope', '')}/mask_heat" in sidecar), None)
    if attn_ev is None:
        return ""
    scope = attn_ev.get("scope", "edit")
    mask = sidecar[f"attn_{scope}/mask_heat"]  # (T, P, F, rh, rw)
    out = ["<h2>LocalBlend mask</h2>"]
    cov = sidecar.get(f"attn_{scope}/mask_cov")  # (T, P, F)
    if cov is not None and cov.ndim == 3:
        for p in range(cov.shape[1]):
            out.append(
                f"<div class=row><span class=meta>stream {p} coverage "
                f"(final {cov[-1, p].mean():.3f})</span> "
                + _svg_spark(cov[:, p].mean(-1), label="per step") + "</div>"
            )
    frames = sidecar.get("frames/edit")
    if frames is not None and mask.ndim == 5 and mask.shape[1] >= 2:
        m = np.clip(mask[-1, 1], 0.0, 1.0)  # final step, first edit stream
        F = min(frames.shape[0], m.shape[0])
        tiles = []
        for f in range(F):
            fr = np.asarray(frames[f], np.float64)
            hgt, wid = fr.shape[:2]
            yi = (np.arange(hgt) * m.shape[1] // max(hgt, 1)).clip(0, m.shape[1] - 1)
            xi = (np.arange(wid) * m.shape[2] // max(wid, 1)).clip(0, m.shape[2] - 1)
            mf = m[f][np.ix_(yi, xi)][..., None]
            tint = np.array([255.0, 40.0, 40.0])
            over = np.clip(fr * (1 - 0.45 * mf) + tint * 0.45 * mf, 0, 255)
            tiles.append(_img(over.astype(np.uint8), title=f"frame {f}"))
        out.append(
            "<div class=row><span class=meta>final-step mask over the edited "
            "frames (red = inside the word mask — the region the edit may "
            "change)</span><br>" + "".join(tiles) + "</div>"
        )
    return "".join(out)


def _quality_section(events) -> str:
    evs = [e for e in events if e.get("event") == "quality"]
    if not evs:
        return ""
    skip = {"event", "t", "program", "sidecar"}
    rows = []
    for e in evs:
        for k, v in e.items():
            if k not in skip and isinstance(v, (int, float)):
                rows.append([k, v])
    return ("<h2>Edit quality</h2>"
            "<p class=meta>obs/quality.py — reconstruction vs the input "
            "frames, background preservation outside the blend mask, "
            "adjacent-frame consistency (PSNR dB / SSIM).</p>"
            + _table(rows, ["metric", "value"]))


def _stream_section(events) -> str:
    """Streaming long-video jobs (stream/driver.py events): the job
    summary plus per-seam consistency. Empty for non-streaming ledgers."""
    health = [e for e in events if e.get("event") == "stream_health"]
    if not health:
        return ""
    skip = {"event", "t", "label"}
    rows = [[k, v] for e in health for k, v in e.items()
            if k not in skip and isinstance(v, (int, float))]
    out = ("<h2>Streaming job</h2>"
           "<p class=meta>stream/driver.py — windowed long-video edit: "
           "window outcomes, resume/recovery counters, and seam "
           "adjacent-frame consistency (gated by SEAM_RULES — seam PSNR "
           "regresses by dropping, src_err_max must be 0).</p>"
           + _table(rows, ["metric", "value"]))
    seams = [e for e in events if e.get("event") == "stream_seam"]
    if seams:
        srows = [[e.get("left"), e.get("right"),
                  f"[{e.get('start')}, {e.get('stop')})",
                  _fmt(e.get("seam_psnr")), _fmt(e.get("source_psnr"))]
                 for e in seams]
        out += _table(srows, ["left", "right", "blend span",
                              "seam PSNR (dB)", "source PSNR (dB)"])
    return out


def _trace_slo_section(events) -> str:
    """Request tracing + SLOs (obs/spans.py + obs/slo.py):
    per-segment critical-path percentiles over the run's spans, and the
    per-objective SLO compliance/budget-burn table. Empty for
    tracing-off, SLO-off ledgers."""
    from videop2p_tpu_torch.obs.spans import SPAN_SEGMENTS
    from videop2p_tpu_torch.obs.timing import percentile

    out = ""
    seg_samples: Dict[str, List[float]] = {}
    n_spans = 0
    trace_ids = set()
    for e in events:
        if e.get("event") != "span":
            continue
        n_spans += 1
        trace_ids.add(e.get("trace_id"))
        seg = SPAN_SEGMENTS.get(e.get("name"))
        if seg is not None:
            try:
                seg_samples.setdefault(seg, []).append(
                    float(e.get("duration_s") or 0.0))
            except (TypeError, ValueError):
                pass
    if seg_samples:
        rows = [[seg, len(vals),
                 f"{percentile(vals, 50) * 1e3:.2f}",
                 f"{percentile(vals, 99) * 1e3:.2f}",
                 f"{max(vals) * 1e3:.2f}"]
                for seg, vals in sorted(seg_samples.items())]
        out += ("<h2>Request critical path</h2>"
                "<p class=meta>obs/spans.py — per-segment latency of "
                f"{len(trace_ids)} trace(s) / {n_spans} spans (gated by "
                "SEGMENT_RULES; join ledgers with tools/trace_view.py)."
                "</p>"
                + _table(rows, ["segment", "spans", "p50 (ms)",
                                "p99 (ms)", "max (ms)"]))
    slos = [e for e in events if e.get("event") == "slo_report"]
    if slos:
        rows = [[e.get("name"), e.get("mode"), _fmt(e.get("target")),
                 _fmt(e.get("actual")), _fmt(e.get("budget_burn")),
                 "ok" if e.get("compliant") else "VIOLATED"]
                for e in slos]
        out += ("<h2>SLOs</h2>"
                "<p class=meta>obs/slo.py — per-objective error-budget "
                "burn (burn ≤ 1.0 is compliant; obs_diff SLO_RULES gate "
                "burn growth across runs).</p>"
                + _table(rows, ["objective", "mode", "target", "actual",
                                "burn", "verdict"]))
    return out


def _fleet_section(events) -> str:
    """Fleet telemetry plane: the collector's fleet_signals
    evaluations — burn-rate history, advice timeline, the last
    evaluation's headline numbers and per-tenant demand. Empty for
    collector-off ledgers."""
    sigs = [e for e in events if e.get("event") == "fleet_signals"]
    if not sigs:
        return ""
    last = sigs[-1]
    out = ("<h2>Fleet signals</h2>"
           "<p class=meta>obs/signals.py over the scraped tsdb "
           "(serve/collector.py) — multi-window burn rates, trend slopes, "
           "saturation and demand metering (gated by SIGNAL_RULES; full "
           "dashboard via tools/fleet_dash.py).</p>")
    fast = [e.get("burn_fast") for e in sigs]
    slow = [e.get("burn_slow") for e in sigs]
    out += ("<div class=row>" + _svg_spark(fast, label=(
            f"burn (fast window) over {len(sigs)} evaluations, last "
            f"{_fmt(last.get('burn_fast'))}")) + "</div>")
    out += ("<div class=row>" + _svg_spark(slow, label=(
            f"burn (slow window), last {_fmt(last.get('burn_slow'))}"))
            + "</div>")
    advice_seq = "".join(
        {"grow": "G", "hold": "·", "shrink": "s"}.get(
            str(e.get("scale_advice")), "?") for e in sigs)
    out += (f"<p class=meta>advice timeline <code>{html.escape(advice_seq)}"
            f"</code> (G=grow ·=hold s=shrink) — last: "
            f"<b>{html.escape(str(last.get('scale_advice', '?')))}</b>, "
            f"burn alerts {_fmt(last.get('burn_alerts'))}, replicas "
            f"{_fmt(last.get('replicas_up'))}/"
            f"{_fmt(last.get('replicas_total'))} up, scrape errors "
            f"{_fmt(last.get('scrape_errors'))}</p>")
    reasons = last.get("reasons") or []
    if reasons:
        out += ("<p class=meta>reasons: "
                + "; ".join(html.escape(str(r)) for r in reasons) + "</p>")
    rows = [[k, _fmt(last.get(k))] for k in (
        "error_rate_fast", "error_rate_slow", "queue_slope",
        "inflight_slope", "saturation", "latency_p99_s", "store_hit_rate",
        "scrape_error_rate") if last.get(k) is not None]
    if rows:
        out += _table(rows, ["signal", "value"])
    tenants = last.get("tenants")
    if isinstance(tenants, dict) and tenants:
        trows = [[t, _fmt(v.get("submitted_rate")),
                  _fmt(v.get("served_rate")), _fmt(v.get("shed_rate")),
                  _fmt(v.get("device_seconds"))]
                 for t, v in sorted(tenants.items()) if isinstance(v, dict)]
        out += ("<p class=meta>per-tenant demand (rates over the slow "
                "window):</p>"
                + _table(trows, ["tenant", "submit/s", "served/s",
                                 "shed/s", "device_s"]))
    return out


def _null_text_section(events) -> str:
    ev = next((e for e in events if e.get("event") == "telemetry"
               and e.get("loss_curve")), None)
    if ev is None:
        return ""
    curve = [v for v in ev["loss_curve"] if isinstance(v, (int, float))]
    return ("<h2>Null-text optimization</h2><div class=row>"
            + _svg_spark(curve, label=(
                f"loss over {len(curve)} outer steps, final "
                f"{_fmt(ev.get('loss_final'))}, "
                f"{_fmt(ev.get('inner_steps_total'))} inner Adam steps"))
            + "</div>")


def _verdict_section(events) -> str:
    ev = next((e for e in reversed(events)
               if e.get("event") == "regression_verdicts"), None)
    if ev is None:
        return ""
    verdicts = ev.get("verdicts") or []
    rows, classes = [], []
    for v in verdicts:
        if not isinstance(v, dict):
            continue
        rows.append([v.get("rule"), v.get("program"), v.get("base"),
                     v.get("new"), v.get("delta_pct"),
                     "REGRESSED" if v.get("regressed") else "ok"])
        classes.append("bad" if v.get("regressed") else "")
    status = ('<span class=ok>PASS</span>' if ev.get("pass")
              else '<span class=regressed>REGRESSIONS</span>')
    base = html.escape(str(ev.get("baseline_run_id", "?")))
    return (f"<h2>Regression verdicts</h2><p class=meta>obs/history.py rules "
            f"vs baseline run {base}: {status}</p>"
            + (_table(rows, ["rule", "program", "base", "new", "Δ%", "verdict"],
                      classes) if rows else "<p class=meta>(no shared metrics "
                                            "with the baseline)</p>"))


def _comm_section(events) -> str:
    """Distributed observability (obs/comm.py events): collective
    accounting, per-device telemetry + divergence, host skew. Empty for
    single-device / pre-distributed-obs ledgers."""
    out: List[str] = []

    comm_evs = [e for e in events if e.get("event") == "comm_analysis"]
    if comm_evs:
        rows = []
        for e in comm_evs:
            per_kind = e.get("per_kind") or {}
            kinds = ", ".join(
                f"{k}×{v.get('count')}" for k, v in sorted(per_kind.items())
                if isinstance(v, dict)
            )
            rows.append([e.get("program", "?"), e.get("num_partitions"),
                         e.get("collective_count"),
                         e.get("collective_bytes"), kinds or "-"])
        out.append(
            "<h3>Collective communication</h3>"
            "<p class=meta>static per-module collective counts and "
            "result-shape bytes of the partitioned programs "
            "(comm_analysis events).</p>"
            + _table(rows, ["program", "partitions", "collectives",
                            "bytes", "per-kind"]))

    dev_rows, dev_classes = [], []
    for e in events:
        if e.get("event") == "device_telemetry":
            div = e.get("divergence_max")
            bad = isinstance(div, (int, float)) and div != 0.0
            dev_rows.append([e.get("program", "?"), e.get("devices"),
                             div, e.get("nan_total", 0),
                             "DIVERGED" if bad else "ok"])
            dev_classes.append("bad" if bad else "")
        elif e.get("event") == "divergence":
            val = e.get("value")
            bad = isinstance(val, (int, float)) and val != 0.0
            dev_rows.append([e.get("label", "?"), "-", val, "-",
                             "DIVERGED" if bad else "ok"])
            dev_classes.append("bad" if bad else "")
    if dev_rows:
        out.append(
            "<h3>Per-device telemetry &amp; replica divergence</h3>"
            "<p class=meta>cross-replica divergence is an exactness "
            "invariant — it must be 0.0 (zero noise floor, COMM_RULES).</p>"
            + _table(dev_rows, ["program/label", "devices", "divergence",
                                "NaN", "verdict"], dev_classes))

    host: Dict[str, Dict[int, float]] = {}
    for e in events:
        if e.get("event") != "host_phase" or e.get("name") is None:
            continue
        try:
            hosts = host.setdefault(str(e["name"]), {})
            proc = int(e.get("process_index", 0))
            hosts[proc] = hosts.get(proc, 0.0) + float(e.get("seconds", 0.0))
        except (TypeError, ValueError):
            continue
    if host:
        rows = []
        for name, hosts in sorted(host.items()):
            vals = list(hosts.values())
            rows.append([name, len(hosts), f"{min(vals):.2f}",
                         f"{max(vals):.2f}", f"{max(vals) - min(vals):.2f}",
                         max(hosts, key=hosts.get)])
        out.append("<h3>Per-host phase skew</h3>"
                   + _table(rows, ["phase", "hosts", "min s", "max s",
                                   "skew s", "slowest proc"]))

    if not out:
        return ""
    return "<h2>Distributed / communication</h2>" + "".join(out)


def _time_section(events) -> str:
    """"Where time goes": per-program execute-latency
    distributions (``execute_timing`` events) and mined device traces
    (``trace_analysis`` events — including those auto-mined by
    ``write_report`` from the run's ``trace`` events). Empty for
    pre-time-domain ledgers."""
    out: List[str] = []

    timing = {e.get("program") or "?": e for e in events
              if e.get("event") == "execute_timing"}
    if timing:
        rows = []
        for prog, t in sorted(timing.items()):
            def ms(key, t=t):
                v = t.get(key)
                return f"{v * 1e3:.1f}" if isinstance(v, (int, float)) else "-"

            rows.append([prog, t.get("count"), ms("blocked_p50_s"),
                         ms("blocked_p95_s"), ms("blocked_p99_s"),
                         ms("blocked_max_s"), t.get("dispatch_fraction")])
        out.append(
            "<h3>Execute latency per program</h3>"
            "<p class=meta>blocked (end-to-end) dispatch latency in ms "
            "from the bounded per-program reservoirs (obs/timing.py, "
            "--latency); dispatch/blocked near 0 means async dispatch is "
            "overlapping with host work.</p>"
            + _table(rows, ["program", "calls", "p50", "p95", "p99",
                            "max", "disp/blk"]))

    trace_evs = [e for e in events if e.get("event") == "trace_analysis"]
    if trace_evs:
        rows = []
        for e in trace_evs:
            ov = e.get("overlap_fraction")
            rows.append([e.get("name", "?"), e.get("device_total_s"),
                         e.get("compute_s"), e.get("collective_s"),
                         "-" if ov is None else ov, e.get("idle_s"),
                         e.get("num_events")])
        out.append(
            "<h3>Device-trace breakdown</h3>"
            "<p class=meta>mined from torch.profiler's chrome traces with "
            "the stdlib reader (obs/trace.py); overlap is the "
            "fraction of collective time hidden under compute "
            "(1.0 = fully overlapped, 0.0 = fully exposed).</p>"
            + _table(rows, ["window", "device_s", "compute_s",
                            "collective_s", "overlap", "idle_s", "events"]))
        for e in trace_evs:
            fams = e.get("families") or {}
            tops = e.get("top_ops") or []
            bits = []
            if isinstance(fams, dict) and fams:
                fam_rows = sorted(
                    ((k, v) for k, v in fams.items()
                     if isinstance(v, (int, float))),
                    key=lambda kv: -kv[1])[:8]
                bits.append(_table([[k, f"{v:.4f}"] for k, v in fam_rows],
                                   ["op family", "seconds"]))
            if tops:
                top_rows = [[t.get("op", "?")[:90], t.get("seconds"),
                             t.get("count")] for t in tops[:8]
                            if isinstance(t, dict)]
                bits.append(_table(top_rows, ["top op", "seconds", "count"]))
            if bits:
                out.append(
                    f"<h4>{html.escape(str(e.get('name', '?')))}</h4>"
                    + "".join(bits))

    if not out:
        return ""
    return "<h2>Where time goes</h2>" + "".join(out)


def _phase_trace_section(events) -> str:
    phases: Dict[str, float] = {}
    for e in events:
        if e.get("event") == "phase":
            try:
                phases[e.get("name") or "?"] = (
                    phases.get(e.get("name") or "?", 0.0)
                    + float(e.get("seconds", 0.0)))
            except (TypeError, ValueError):
                continue
    out = []
    if phases:
        rows = sorted(phases.items(), key=lambda kv: -kv[1])
        out.append("<h2>Phases</h2>"
                   + _table([[k, f"{v:.2f}"] for k, v in rows],
                            ["phase", "seconds"]))
    traces = [e for e in events if e.get("event") == "trace"]
    if traces:
        items = "".join(
            f"<li><code>{html.escape(str(e.get('name')))}</code> → "
            f"<code>{html.escape(str(e.get('trace_dir')))}</code></li>"
            for e in traces)
        out.append(f"<h2>Device traces</h2><ul class=meta>{items}</ul>")
    return "".join(out)


def render_report(events: Sequence[Dict[str, Any]],
                  sidecar: Dict[str, np.ndarray],
                  *, title: str = "Video-P2P edit report") -> str:
    """One self-contained HTML page from a run's events + sidecar arrays."""
    events = [e for e in events if isinstance(e, dict)]
    start = next((e for e in events if e.get("event") == "run_start"), {})
    meta_bits = [
        f"run <code>{html.escape(str(start.get('run_id', '?')))}</code>",
        f"sha {html.escape(str(start.get('git_sha', '?')))}",
        f"backend {html.escape(str(start.get('backend', '?')))}",
        f"at {html.escape(str(start.get('wall_time', '?')))}",
    ]
    if start.get("prompt"):
        meta_bits.append(f"source prompt: “{html.escape(str(start['prompt']))}”")
    body = [
        f"<h1>{html.escape(title)}</h1>",
        f'<p class=meta>{" · ".join(meta_bits)}</p>',
        _quality_section(events),
        _word_heat_section(events, sidecar),
        _mask_section(events, sidecar),
        _null_text_section(events),
        _stream_section(events),
        _trace_slo_section(events),
        _fleet_section(events),
        _comm_section(events),
        _time_section(events),
        _verdict_section(events),
        _phase_trace_section(events),
        '<p class=meta>generated by tools/edit_report.py — stdlib+numpy, '
        'all assets embedded.</p>',
    ]
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title><style>{_CSS}</style>"
            "</head><body>" + "".join(b for b in body if b) + "</body></html>")


def _find_sidecar(events, ledger_path: str) -> Optional[str]:
    for e in reversed(events):
        sc = e.get("sidecar") if isinstance(e, dict) else None
        if not sc:
            continue
        for cand in (sc, os.path.join(os.path.dirname(os.path.abspath(
                ledger_path)), os.path.basename(sc))):
            if os.path.isfile(cand):
                return cand
    return None


def _mine_trace_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """A run that captured device traces through ``utils/profiling.py:
    trace`` (``VIDEOP2P_TRACE_DIR``) recorded only a ``trace`` event (name
    and directory): mine each such directory that still exists into a
    ``trace_analysis`` event (``mined_from: "trace"``) for the "Where time
    goes" section. Windows that already have a ``trace_analysis``
    (``obs/trace.py:trace_window``) are left alone; a missing directory or
    a parse failure skips that trace, never the report."""
    from videop2p_tpu_torch.obs.trace import analyze_trace_dir

    analyzed = {e.get("name") for e in events if e.get("event") == "trace_analysis"}
    mined: List[Dict[str, Any]] = []
    for e in events:
        if e.get("event") != "trace":
            continue
        name, tdir = e.get("name"), e.get("trace_dir")
        if not tdir or name in analyzed or not os.path.isdir(str(tdir)):
            continue
        try:
            record, _ = analyze_trace_dir(str(tdir), name=str(name))
        except Exception:  # noqa: BLE001 — mining is best-effort
            continue
        mined.append({"event": "trace_analysis", "mined_from": "trace", **record})
        analyzed.add(name)
    return events + mined


def write_report(ledger_path: str, out_path: Optional[str] = None,
                 sidecar_path: Optional[str] = None) -> str:
    """Render the LAST run of a ledger file (ledgers append across
    invocations) into a self-contained HTML file next to it."""
    events = _mine_trace_events(_last_run(_read_jsonl(ledger_path)))
    sidecar: Dict[str, np.ndarray] = {}
    sidecar_path = sidecar_path or _find_sidecar(events, ledger_path)
    if sidecar_path and os.path.isfile(sidecar_path):
        with np.load(sidecar_path) as z:
            sidecar = {k: z[k] for k in z.files}
    out_path = out_path or os.path.splitext(ledger_path)[0] + "_report.html"
    html_text = render_report(events, sidecar)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path


def main(argv: List[str]) -> int:
    """CLI: edit_report.py <ledger.jsonl> [-o report.html] [--sidecar X.npz]"""
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(main.__doc__)
        return 0
    args = list(argv[1:])
    out = sidecar = None
    pos = []
    while args:
        a = args.pop(0)
        if a in ("-o", "--out"):
            if not args:
                print(main.__doc__, file=sys.stderr)
                return 2
            out = args.pop(0)
        elif a == "--sidecar":
            if not args:
                print(main.__doc__, file=sys.stderr)
                return 2
            sidecar = args.pop(0)
        else:
            pos.append(a)
    if len(pos) != 1:
        print(main.__doc__, file=sys.stderr)
        return 2
    try:
        path = write_report(pos[0], out, sidecar)
    except OSError as e:
        print(f"edit_report: {e}", file=sys.stderr)
        return 2
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
