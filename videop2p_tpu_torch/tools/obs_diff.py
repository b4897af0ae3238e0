"""Diff two run ledgers (or latest-vs-history) and exit nonzero on regression
(port of ``tools/obs_diff.py``: the same flags, exit codes and output, over
the port's ``obs/history.py`` rule tables).

Usage:
  python -m videop2p_tpu_torch.tools.obs_diff BASE.jsonl NEW.jsonl
  python -m videop2p_tpu_torch.tools.obs_diff --history DIR NEW.jsonl
  python -m videop2p_tpu_torch.tools.obs_diff --history DIR   # latest vs its baseline

Compares the ``program_analysis`` events (XLA cost/memory analysis, HLO
fingerprints — obs/introspect.py), per-program compile seconds, phase
wall-clock, collective-communication accounting (``comm_analysis`` events
— obs/comm.py: per-kind collective counts and byte volumes of the sharded
programs), per-device peak-HBM residency (``memory`` snapshots), cross-replica
divergence (must be 0.0 — the zero-noise-floor invariant), per-program
execute-latency distributions (``execute_timing`` events — obs/timing.py:
blocked p50/p99 regress by growing), mined device traces
(``trace_analysis`` events — obs/trace.py: device-total seconds regress
by growing, the compute/collective overlap fraction by DROPPING), and
serving reliability (``serve_health`` events — serve/faults.py + the
engine: error rate, load-shed rate, breaker trips and deadline expiries
regress by appearing/growing, gated by ``FAULT_RULES``), and streaming
long-video jobs (``stream_health`` events — stream/driver.py: window-seam
adjacent-frame PSNR regresses by DROPPING, window failures/passthroughs
and manifest corruption by appearing, ``src_err_max`` must be exactly 0 —
gated by ``SEAM_RULES``), request-trace critical-path segments (``span``
events — obs/spans.py: per-segment queue/resolve/dispatch/decode p50/p99
regress by growing, gated by ``SEGMENT_RULES``), and SLO compliance
(``slo_report`` events — obs/slo.py: per-objective error-budget burn
regresses by growing, a compliant→violating flip always fails — gated by
``SLO_RULES``), and captured incidents (``incident`` events —
obs/incident.py: ANY increase in bundle or suppressed-capture counts,
overall or per trigger kind, regresses — gated by ``INCIDENT_RULES``),
and cost & capacity (``cost_attribution`` events — obs/cost.py:
per-engine/tenant/program device-second attribution; cost-per-request
and padding/idle waste regress by growing, utilization by dropping —
gated by ``COST_RULES``), and correctness probes (``probe`` /
``probe_audit`` events — obs/probe.py + serve/prober.py: known-answer
success rates regress by DROPPING, ANY new cross-replica answer-audit
divergence regresses, probe latency p99 by growing — gated by
``PROBE_RULES``)
between a baseline run and a new run, renders per-program tables,
evaluates the declarative regression rules (obs/history.py DEFAULT_RULES;
scale every threshold with ``--threshold-scale``), and:

  exit 0 — no rule regressed (a ledger compared against itself is always 0)
  exit 1 — at least one regression verdict
  exit 2 — usage / unreadable input

``--json`` additionally prints the machine-readable verdict object on
stdout (the tables move to stderr). CPU-runnable — this is the tier-1 CI
gate for "did this change make the compiled programs bigger".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional

from videop2p_tpu_torch.obs.history import (
    DEFAULT_RULES,
    RunHistory,
    evaluate_rules,
    extract_run,
    split_runs,
)
from videop2p_tpu_torch.obs.ledger import read_ledger


def _fmt(v: float) -> str:
    """Human-scaled number: bytes/flops get unit suffixes, small floats stay
    plain."""
    if v is None:
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{suffix}"
    return f"{v:.4g}"


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    lines = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(str(c).ljust(w) for c, w in zip(r, widths))
              for r in rows]
    return "\n".join(lines)


def render_diff(base: Dict, new: Dict, result: Dict) -> str:
    """The per-program / per-phase comparison tables plus the verdict list,
    as one string (pure — tests feed synthetic records)."""
    out: List[str] = [
        f"base: run {base.get('run_id', '?')} at {base.get('wall_time', '?')}"
        + (f"  ({base.get('source')})" if base.get("source") else ""),
        f"new:  run {new.get('run_id', '?')} at {new.get('wall_time', '?')}"
        + (f"  ({new.get('source')})" if new.get("source") else ""),
    ]

    progs = sorted(set(base.get("programs", {})) | set(new.get("programs", {})))
    if progs:
        rows = []
        for label in progs:
            b = base.get("programs", {}).get(label, {})
            n = new.get("programs", {}).get(label, {})
            fp_b, fp_n = b.get("hlo_fingerprint"), n.get("hlo_fingerprint")

            def cell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                pct = (nv / bv - 1.0) * 100.0 if bv else float("inf")
                return f"{_fmt(bv)} → {_fmt(nv)} ({pct:+.1f}%)"

            rows.append([
                label, cell("flops"), cell("bytes_accessed"),
                cell("temp_bytes"), cell("peak_hbm_bytes"),
                cell("hlo_instructions"),
                ("same" if fp_b == fp_n else "CHANGED") if fp_b and fp_n
                else "-",
            ])
        out += ["", "programs (XLA cost/memory analysis):",
                _table(rows, ["program", "flops", "bytes", "temp",
                              "peak_hbm", "instrs", "hlo"])]

    names = sorted(set(base.get("phases", {})) | set(new.get("phases", {})))
    if names:
        rows = []
        for name in names:
            b = base.get("phases", {}).get(name, {}).get("seconds")
            n = new.get("phases", {}).get(name, {}).get("seconds")
            delta = (f"{(n / b - 1.0) * 100.0:+.1f}%"
                     if b and n is not None else "-")
            rows.append([name,
                         "-" if b is None else f"{b:.2f}",
                         "-" if n is None else f"{n:.2f}", delta])
        out += ["", "phases (wall-clock s):",
                _table(rows, ["phase", "base", "new", "delta"])]

    # distributed sections (obs/comm.py) — absent/empty for older
    # ledgers and single-device runs, in which case the tables are omitted
    comms = sorted(set(base.get("comm") or {}) | set(new.get("comm") or {}))
    if comms:
        rows = []
        for label in comms:
            b = (base.get("comm") or {}).get(label, {})
            n = (new.get("comm") or {}).get(label, {})

            def ccell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                pct = (nv / bv - 1.0) * 100.0 if bv else float("inf")
                return f"{_fmt(bv)} → {_fmt(nv)} ({pct:+.1f}%)"

            rows.append([label, ccell("num_partitions"),
                         ccell("collective_count"), ccell("collective_bytes")])
        out += ["", "collectives (comm_analysis — static per-module "
                "counts/bytes):",
                _table(rows, ["program", "partitions", "collectives",
                              "bytes"])]

    devmem = sorted(set(base.get("device_memory") or {})
                    | set(new.get("device_memory") or {}))
    if devmem:
        rows = []
        for dev in devmem:
            b = (base.get("device_memory") or {}).get(dev)
            n = (new.get("device_memory") or {}).get(dev)
            delta = (f"{(n / b - 1.0) * 100.0:+.1f}%"
                     if b and n is not None else "-")
            rows.append([dev, _fmt(b), _fmt(n), delta])
        out += ["", "per-device peak HBM (memory snapshots):",
                _table(rows, ["device", "base", "new", "delta"])]

    divs = sorted(set(base.get("divergence") or {})
                  | set(new.get("divergence") or {}))
    if divs:
        rows = []
        for label in divs:
            b = (base.get("divergence") or {}).get(label)
            n = (new.get("divergence") or {}).get(label)
            rows.append([label, _fmt(b), _fmt(n),
                         "ok" if n in (None, 0.0) else "DIVERGED"])
        out += ["", "replica divergence (must be 0.0):",
                _table(rows, ["label", "base", "new", "verdict"])]

    # time-domain sections (obs/timing.py reservoirs + obs/trace.py
    # trace mining) — absent/empty for older ledgers, tables omitted
    timing = sorted(set(base.get("timing") or {}) | set(new.get("timing") or {}))
    if timing:
        rows = []
        for label in timing:
            b = (base.get("timing") or {}).get(label, {})
            n = (new.get("timing") or {}).get(label, {})

            def tcell(metric, scale=1e3, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return f"{nv * scale:.2f}"
                pct = (nv / bv - 1.0) * 100.0 if bv else float("inf")
                return f"{bv * scale:.2f} → {nv * scale:.2f} ({pct:+.1f}%)"

            cnt_b, cnt_n = b.get("count"), n.get("count")
            cnt = (_fmt(cnt_n) if cnt_b == cnt_n
                   else f"{_fmt(cnt_b)} → {_fmt(cnt_n)}")
            rows.append([label, cnt,
                         tcell("blocked_p50_s"), tcell("blocked_p99_s"),
                         tcell("blocked_max_s")])
        out += ["", "execute timing (blocked-latency ms per dispatch):",
                _table(rows, ["program", "calls", "p50", "p99", "max"])]

    traces = sorted(set(base.get("trace") or {}) | set(new.get("trace") or {}))
    if traces:
        rows = []
        for label in traces:
            b = (base.get("trace") or {}).get(label, {})
            n = (new.get("trace") or {}).get(label, {})

            def rcell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                pct = (nv / bv - 1.0) * 100.0 if bv else float("inf")
                return f"{_fmt(bv)} → {_fmt(nv)} ({pct:+.1f}%)"

            rows.append([label, rcell("device_total_s"),
                         rcell("collective_s"), rcell("overlap_fraction"),
                         rcell("idle_s")])
        out += ["", "trace analysis (device seconds; overlap regresses "
                "by dropping):",
                _table(rows, ["window", "device_total_s", "collective_s",
                              "overlap", "idle_s"])]

    # reliability section (serve_health events — serve/faults.py):
    # absent/empty for older ledgers and non-serving runs, table omitted
    rel = sorted(set(base.get("reliability") or {})
                 | set(new.get("reliability") or {}))
    if rel:
        rows = []
        for label in rel:
            b = (base.get("reliability") or {}).get(label, {})
            n = (new.get("reliability") or {}).get(label, {})

            def fcell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                return f"{_fmt(bv)} → {_fmt(nv)}"

            rows.append([label, fcell("requests"), fcell("error_rate"),
                         fcell("shed"), fcell("shed_rate"),
                         fcell("breaker_trips"), fcell("deadline_exceeded"),
                         fcell("retries")])
        out += ["", "reliability (serve_health — error/shed rates, breaker "
                "trips):",
                _table(rows, ["label", "requests", "error_rate", "sheds",
                              "shed_rate", "breaker_trips",
                              "deadline_exceeded", "retries"])]

    # streaming section (stream_health events — stream/driver.py):
    # absent/empty for older ledgers and non-streaming runs
    stream = sorted(set(base.get("stream") or {})
                    | set(new.get("stream") or {}))
    if stream:
        rows = []
        for label in stream:
            b = (base.get("stream") or {}).get(label, {})
            n = (new.get("stream") or {}).get(label, {})

            def scell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                return f"{_fmt(bv)} → {_fmt(nv)}"

            rows.append([label, scell("windows_total"), scell("windows_done"),
                         scell("windows_passthrough"), scell("windows_failed"),
                         scell("seam_min_psnr"), scell("seam_mean_psnr"),
                         scell("src_err_max")])
        out += ["", "streaming (stream_health — seam PSNR regresses by "
                "dropping; src_err_max must be 0):",
                _table(rows, ["label", "windows", "done", "passthrough",
                              "failed", "seam_min", "seam_mean",
                              "src_err_max"])]

    # critical-path segments (span events — obs/spans.py):
    # absent/empty for tracing-off ledgers, table omitted
    segs = sorted(set(base.get("segments") or {})
                  | set(new.get("segments") or {}))
    if segs:
        rows = []
        for label in segs:
            b = (base.get("segments") or {}).get(label, {})
            n = (new.get("segments") or {}).get(label, {})

            def gcell(metric, scale=1e3, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return f"{nv * scale:.2f}"
                pct = (nv / bv - 1.0) * 100.0 if bv else float("inf")
                return f"{bv * scale:.2f} → {nv * scale:.2f} ({pct:+.1f}%)"

            cnt_b, cnt_n = b.get("count"), n.get("count")
            cnt = (_fmt(cnt_n) if cnt_b == cnt_n
                   else f"{_fmt(cnt_b)} → {_fmt(cnt_n)}")
            rows.append([label, cnt, gcell("p50_s"), gcell("p99_s"),
                         gcell("max_s")])
        out += ["", "trace segments (critical-path ms per request — queue/"
                "resolve/dispatch/decode):",
                _table(rows, ["segment", "spans", "p50", "p99", "max"])]

    # SLO section (slo_report events — obs/slo.py): budget burn
    # regresses by growing; compliant regresses by flipping to 0
    slos = sorted(set(base.get("slo") or {}) | set(new.get("slo") or {}))
    if slos:
        rows = []
        for name in slos:
            b = (base.get("slo") or {}).get(name, {})
            n = (new.get("slo") or {}).get(name, {})

            def ocell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                return f"{_fmt(bv)} → {_fmt(nv)}"

            verdict = "-"
            if n:
                verdict = "ok" if n.get("compliant") else "VIOLATED"
            rows.append([name, ocell("target"), ocell("actual"),
                         ocell("budget_burn"), verdict])
        out += ["", "SLOs (slo_report — budget burn regresses by growing):",
                _table(rows, ["objective", "target", "actual", "burn",
                              "verdict"])]

    # fleet-signal section (fleet_signals/fleet_series events —
    # obs/signals.py over the collector's tsdb): absent/empty
    # for older ledgers and collector-off runs, table omitted
    sigs = sorted(set(base.get("signals") or {})
                  | set(new.get("signals") or {}))
    if sigs:
        rows = []
        for label in sigs:
            b = (base.get("signals") or {}).get(label, {})
            n = (new.get("signals") or {}).get(label, {})

            def ncell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                return f"{_fmt(bv)} → {_fmt(nv)}"

            advice = "-"
            if n:
                advice = next((a for a in ("grow", "hold", "shrink")
                               if n.get(f"advice_{a}") == 1.0), "-")
            rows.append([label, ncell("burn_fast"), ncell("burn_slow"),
                         ncell("burn_alerts"), ncell("saturation"),
                         ncell("scrape_error_rate"),
                         ncell("replicas_up"), advice])
        out += ["", "fleet signals (fleet_signals — any new burn alert "
                "regresses; saturation/scrape errors by growing):",
                _table(rows, ["label", "burn_fast", "burn_slow", "alerts",
                              "saturation", "scrape_err_rate", "up",
                              "advice"])]

    # cost section (cost_attribution events — obs/cost.py):
    # absent/empty for older ledgers and cost-off runs, table omitted;
    # cost_per_request and padding/idle waste regress by growing,
    # busy_fraction (utilization) by DROPPING — gated by COST_RULES
    costs = sorted(set(base.get("cost") or {}) | set(new.get("cost") or {}))
    if costs:
        rows = []
        for label in costs:
            b = (base.get("cost") or {}).get(label, {})
            n = (new.get("cost") or {}).get(label, {})

            def kcell(metric, b=b, n=n):
                bv, nv = b.get(metric), n.get(metric)
                if bv is None and nv is None:
                    return "-"
                if bv is None or nv is None:
                    return f"{_fmt(bv)} → {_fmt(nv)}"
                if bv == nv:
                    return _fmt(nv)
                return f"{_fmt(bv)} → {_fmt(nv)}"

            rows.append([label, kcell("requests"), kcell("device_seconds"),
                         kcell("cost_per_request_s"), kcell("busy_fraction"),
                         kcell("padding_waste"), kcell("idle_fraction"),
                         kcell("saved_device_seconds")])
        out += ["", "cost & capacity (cost_attribution — cost_per_request/"
                "padding/idle regress by growing, utilization by dropping):",
                _table(rows, ["label", "requests", "device_s",
                              "cost_per_req_s", "busy_frac", "padding_waste",
                              "idle_frac", "saved_device_s"])]

    # incident section (incident events — obs/incident.py):
    # the overall "incident" label is seeded at zero on every run, so the
    # table only renders when either side actually captured something
    incs = sorted(set(base.get("incidents") or {})
                  | set(new.get("incidents") or {}))
    inc_rows = []
    for label in incs:
        b = (base.get("incidents") or {}).get(label, {})
        n = (new.get("incidents") or {}).get(label, {})
        if not (b.get("count") or n.get("count")
                or b.get("suppressed") or n.get("suppressed")):
            continue
        inc_rows.append([
            label,
            f"{_fmt(b.get('count', 0.0))} → {_fmt(n.get('count', 0.0))}",
            f"{_fmt(b.get('suppressed', 0.0))} → "
            f"{_fmt(n.get('suppressed', 0.0))}",
            f"{_fmt(b.get('events', 0.0))} → {_fmt(n.get('events', 0.0))}",
        ])
    if inc_rows:
        out += ["", "incidents (incident events — ANY increase in "
                "captured or suppressed bundles regresses):",
                _table(inc_rows, ["label", "bundles", "suppressed",
                                  "ring_events"])]

    # correctness section (probe / probe_audit events — obs/probe.py):
    # the overall "probe" label is seeded perfect on every
    # run, so the table only renders when either side actually probed
    # (or audited a divergence)
    probes = sorted(set(base.get("probes") or {})
                    | set(new.get("probes") or {}))
    probe_rows = []
    for label in probes:
        b = (base.get("probes") or {}).get(label, {})
        n = (new.get("probes") or {}).get(label, {})
        if not (b.get("count") or n.get("count")
                or b.get("divergences") or n.get("divergences")):
            continue
        probe_rows.append([
            label,
            f"{_fmt(b.get('count', 0.0))} → {_fmt(n.get('count', 0.0))}",
            f"{_fmt(b.get('success_rate', 1.0))} → "
            f"{_fmt(n.get('success_rate', 1.0))}",
            f"{_fmt(b.get('failures', 0.0))} → "
            f"{_fmt(n.get('failures', 0.0))}",
            f"{_fmt(b.get('divergences', 0.0))} → "
            f"{_fmt(n.get('divergences', 0.0))}",
        ])
    if probe_rows:
        out += ["", "correctness probes (probe/probe_audit — success "
                "rate regresses by dropping; ANY new answer-audit "
                "divergence regresses):",
                _table(probe_rows, ["label", "probes", "success_rate",
                                    "failures", "divergences"])]

    comp = sorted(set(base.get("compiles", {})) | set(new.get("compiles", {})))
    if comp:
        rows = []
        for label in comp:
            b = base.get("compiles", {}).get(label, {}).get("seconds")
            n = new.get("compiles", {}).get(label, {}).get("seconds")
            rows.append([label,
                         "-" if b is None else f"{b:.2f}",
                         "-" if n is None else f"{n:.2f}"])
        out += ["", "compile seconds:",
                _table(rows, ["program", "base", "new"])]

    regs = result["regressions"]
    if regs:
        out += ["", f"REGRESSIONS ({len(regs)}):"]
        for v in regs:
            pct = ("new" if v["delta_pct"] is None else f"{v['delta_pct']:+.1f}%")
            note = (" [HLO fingerprint changed — XLA built a different program]"
                    if v.get("fingerprint_changed") else "")
            out.append(
                f"  {v['rule']}  {v['program']}: "
                f"{_fmt(v['base'])} → {_fmt(v['new'])} ({pct}){note}"
            )
    else:
        out += ["", "no regressions"]
    return "\n".join(out)


def _load_run(path: str) -> Optional[Dict]:
    """LAST run in a ledger file (files append across invocations)."""
    try:
        runs = split_runs(read_ledger(path))
    except OSError as e:
        print(f"obs_diff: cannot read {path}: {e}", file=sys.stderr)
        return None
    if not runs:
        print(f"obs_diff: {path} holds no events", file=sys.stderr)
        return None
    return extract_run(runs[-1], source=path)


def main(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="obs_diff.py", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("ledgers", nargs="*",
                        help="BASE.jsonl NEW.jsonl — or just NEW.jsonl with "
                             "--history")
    parser.add_argument("--history", type=str, default=None,
                        help="directory of ledger JSONLs; the baseline is "
                             "the most recent prior run sharing program "
                             "labels with the new run")
    parser.add_argument("--threshold-scale", type=float, default=1.0,
                        help="multiply every rule threshold (2.0 = twice as "
                             "tolerant)")
    parser.add_argument("--json", action="store_true",
                        help="print the machine-readable verdict object on "
                             "stdout (tables go to stderr)")
    args = parser.parse_args(argv[1:])

    if args.history is not None:
        if len(args.ledgers) > 1:
            parser.print_usage(sys.stderr)
            return 2
        try:
            hist = RunHistory.scan(args.history)
        except OSError as e:
            print(f"obs_diff: cannot scan {args.history}: {e}", file=sys.stderr)
            return 2
        new = _load_run(args.ledgers[0]) if args.ledgers else hist.latest()
        if new is None:
            print("obs_diff: no new run to compare", file=sys.stderr)
            return 2
        base = hist.baseline_for(new)
        if base is None:
            print("obs_diff: history holds no baseline run — nothing to "
                  "compare (pass)", file=sys.stderr)
            return 0
    else:
        if len(args.ledgers) != 2:
            parser.print_usage(sys.stderr)
            print(__doc__.strip(), file=sys.stderr)
            return 2
        base = _load_run(args.ledgers[0])
        new = _load_run(args.ledgers[1])
        if base is None or new is None:
            return 2

    # dataclasses.replace keeps every other field — notably `direction`:
    # rebuilding by hand once dropped it, silently flipping the
    # decrease-direction quality rules and the nonzero divergence invariant
    # back to increase-threshold semantics
    rules = tuple(
        dataclasses.replace(
            r, threshold_pct=r.threshold_pct * args.threshold_scale
        )
        for r in DEFAULT_RULES
    )
    result = evaluate_rules(base, new, rules)
    text = render_diff(base, new, result)
    if args.json:
        print(text, file=sys.stderr)
        print(json.dumps(result))
    else:
        print(text)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
