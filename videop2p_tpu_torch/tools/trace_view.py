"""Join span ledgers into causal trace trees (port of ``tools/trace_view.py``:
the same flags, exit codes and output).

Reads one or MANY run ledgers (a loadgen ledger, a router ledger, N
replica ledgers — rotation chains included, ``read_ledger`` follows
them), collects every ``span`` event, groups by ``trace_id`` and renders
each trace as an ASCII tree ordered by the spans' wall-clock anchors:

    python -m videop2p_tpu_torch.tools.trace_view loadgen.jsonl \\
        router_ledger.jsonl serve_out/replica*/ledger.jsonl

    trace 3f2a...  spans=6  ledgers=3  duration=2.104s
      critical path: queue 0.412s | resolve 1.203s | dispatch 0.377s | decode 0.093s
      loadgen.request  2.104s  ok  [loadgen.jsonl]
        router.submit  0.009s  ok  replica=replica1  [router_ledger.jsonl]
          serve.request  2.080s  done  rid=ab12...  [replica1/ledger.jsonl]
            serve.queue  0.412s  ok
            serve.resolve  1.203s  ok  store=disk
            ...

Spans whose parent lives in a DIFFERENT ledger join transparently — the
trace_id+parent_id links are the join keys; no shared clock or process
state is assumed. A span whose parent was never recorded (a replica
ledger viewed alone) renders as a root marked ``(orphan)`` rather than
vanishing.

``--json`` emits one machine-readable document (per-trace span lists +
the per-segment critical-path split + per-segment aggregate p50/p99
across traces) for CI. ``--trace ID`` filters to one trace. Exit codes:
0 = rendered (even zero spans — a tracing-off ledger is empty, not
broken), 2 = an input file was unreadable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

from videop2p_tpu_torch.obs.ledger import read_ledger
from videop2p_tpu_torch.obs.spans import SPAN_SEGMENTS
from videop2p_tpu_torch.obs.timing import percentile

# span attributes worth showing inline in the tree (identity/topology —
# not the timing fields, which get their own columns)
_ATTR_KEYS = ("rid", "replica", "tenant", "index", "batch_id",
              "batch_size", "store_source", "steps", "attempts", "cached")


def load_spans(paths: List[str]) -> List[Dict[str, Any]]:
    """Every ``span`` event across the ledgers, tagged with its source
    ledger's basename. Raises OSError/ValueError on an unreadable path."""
    spans: List[Dict[str, Any]] = []
    for path in paths:
        if not os.path.exists(path):
            raise OSError(f"no such ledger: {path}")
        label = os.path.basename(os.path.dirname(path) or "")
        label = (f"{label}/{os.path.basename(path)}" if label
                 else os.path.basename(path))
        for e in read_ledger(path):
            if e.get("event") == "span" and e.get("trace_id"):
                s = dict(e)
                s["_ledger"] = label
                spans.append(s)
    return spans


def group_traces(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-trace documents: the span list (wall-ordered), the root forest
    (children resolved across ledgers), and the critical-path segment
    split from :data:`SPAN_SEGMENTS`."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for s in spans:
        by_trace.setdefault(str(s["trace_id"]), []).append(s)
    traces = []
    for tid in sorted(by_trace,
                      key=lambda t: min(int(s.get("wall_ns") or 0)
                                        for s in by_trace[t])):
        tr_spans = sorted(by_trace[tid],
                          key=lambda s: (int(s.get("wall_ns") or 0),
                                         str(s.get("span_id"))))
        ids = {s.get("span_id") for s in tr_spans}
        roots, children = [], {}
        for s in tr_spans:
            parent = s.get("parent_id")
            if parent and parent in ids:
                children.setdefault(parent, []).append(s)
            else:
                s = dict(s)
                s["_orphan"] = bool(parent)  # parent named but not seen
                roots.append(s)
        segments: Dict[str, float] = {}
        for s in tr_spans:
            seg = SPAN_SEGMENTS.get(s.get("name"))
            if seg is not None:
                try:
                    segments[seg] = (segments.get(seg, 0.0)
                                     + float(s.get("duration_s") or 0.0))
                except (TypeError, ValueError):
                    pass
        walls = [int(s.get("wall_ns") or 0) for s in tr_spans]
        durations = [float(s.get("duration_s") or 0.0) for s in tr_spans]
        span_s = 0.0
        if walls:
            ends = [w / 1e9 + d for w, d in zip(walls, durations)]
            span_s = max(ends) - min(walls) / 1e9
        traces.append({
            "trace_id": tid,
            "spans": tr_spans,
            "roots": roots,
            "children": children,
            "segments": {k: round(v, 6) for k, v in sorted(segments.items())},
            "ledgers": sorted({s["_ledger"] for s in tr_spans}),
            "duration_s": round(max(span_s, 0.0), 6),
        })
    return traces


def segment_percentiles(traces: List[Dict[str, Any]]
                        ) -> Dict[str, Dict[str, float]]:
    """Aggregate p50/p99 of each critical-path segment ACROSS traces —
    the same numbers obs/history.py extracts into the `segments` section,
    recomputed here from the joined view."""
    samples: Dict[str, List[float]] = {}
    for tr in traces:
        for seg, total in tr["segments"].items():
            samples.setdefault(seg, []).append(total)
    return {
        seg: {
            "count": float(len(vals)),
            "p50_s": round(percentile(vals, 50), 6),
            "p99_s": round(percentile(vals, 99), 6),
            "max_s": round(max(vals), 6),
        }
        for seg, vals in sorted(samples.items())
    }


def _span_line(s: Dict[str, Any], depth: int) -> str:
    dur = float(s.get("duration_s") or 0.0)
    attrs = " ".join(f"{k}={s[k]}" for k in _ATTR_KEYS
                     if s.get(k) not in (None, ""))
    parts = ["  " * depth + str(s.get("name")),
             f"{dur:.3f}s", str(s.get("status") or "ok")]
    if attrs:
        parts.append(attrs)
    parts.append(f"[{s['_ledger']}]")
    if s.get("_orphan"):
        parts.append("(orphan)")
    return "  ".join(parts)


def render_trace(tr: Dict[str, Any]) -> str:
    lines = [
        f"trace {tr['trace_id']}  spans={len(tr['spans'])}  "
        f"ledgers={len(tr['ledgers'])}  duration={tr['duration_s']:.3f}s"
    ]
    if tr["segments"]:
        split = " | ".join(f"{k} {v:.3f}s"
                           for k, v in tr["segments"].items())
        lines.append(f"  critical path: {split}")

    def walk(span: Dict[str, Any], depth: int) -> None:
        lines.append("  " + _span_line(span, depth))
        for child in tr["children"].get(span.get("span_id"), []):
            walk(child, depth + 1)

    for root in tr["roots"]:
        walk(root, 0)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledgers", nargs="+",
                    help="run ledger JSONL paths (router + replicas + "
                         "loadgen — any mix; traces join on trace_id)")
    ap.add_argument("--trace", type=str, default=None,
                    help="render only this trace id (prefix match)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output for CI")
    args = ap.parse_args(argv)
    try:
        spans = load_spans(args.ledgers)
    except OSError as e:
        print(f"[trace_view] {e}", file=sys.stderr)
        return 2
    traces = group_traces(spans)
    if args.trace:
        traces = [t for t in traces
                  if t["trace_id"].startswith(args.trace.lower())]
    if args.json:
        doc = {
            "ledgers": args.ledgers,
            "traces": [{k: v for k, v in tr.items()
                        if k not in ("roots", "children")}
                       for tr in traces],
            "segment_percentiles": segment_percentiles(traces),
        }
        print(json.dumps(doc, default=str))
        return 0
    if not traces:
        print("no spans found (tracing off, or no matching trace id)")
        return 0
    for tr in traces:
        print(render_trace(tr))
        print()
    agg = segment_percentiles(traces)
    if agg:
        print(f"segments across {len(traces)} trace(s):")
        for seg, rec in agg.items():
            print(f"  {seg:10s} p50 {rec['p50_s']:.3f}s  "
                  f"p99 {rec['p99_s']:.3f}s  max {rec['max_s']:.3f}s  "
                  f"n={int(rec['count'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
