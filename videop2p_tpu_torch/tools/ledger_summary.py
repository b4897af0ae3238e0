"""Render a run-ledger JSONL (videop2p_tpu_torch/obs/ledger.py) as tables
(port of ``tools/ledger_summary.py``: the same argument, exit codes and
output).

Usage:  python -m videop2p_tpu_torch.tools.ledger_summary <ledger.jsonl>

Prints the run header (run_id / git sha / jax / backend), a per-phase
wall-clock table, a per-program compile-vs-execute table (compile events
attributed by program label, program_call dispatch times with cache
hit/miss counts), a per-program XLA cost/memory-analysis table
(``program_analysis`` events — flops, bytes, temp/peak HBM, HLO
fingerprint) with a predicted-vs-measured peak-HBM line when memory
snapshots exist, telemetry summaries with a loss-curve sparkline for the
fused null-text program, training-metric and memory-snapshot digests.
Distributed runs additionally get a collective-communication table
(``comm_analysis`` events — obs/comm.py per-kind counts/bytes), per-device
telemetry lines with the cross-replica divergence (must be 0.0),
``program_analysis_skipped`` reasons, and a per-host phase-skew table when
``host_phase`` events exist (multi-host straggler visibility). Time-domain
runs (``--latency`` / ``--trace_analysis``) additionally get a per-program
execute-timing table (blocked-latency p50/p95/p99/max with the
dispatch-vs-blocked async-overlap split) and a trace-analysis table
(device/compute/collective seconds, the compute-collective overlap
fraction, idle time, op families). Ledgers written before these events
existed render exactly as before — the sections simply don't appear.

Tolerates empty ledgers and truncated/partial JSONL lines (a killed run's
torn tail): malformed events render as far as their fields allow instead
of crashing the renderer. Diff two ledgers with
``python -m videop2p_tpu_torch.tools.obs_diff``.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, List

from videop2p_tpu_torch.obs.ledger import read_ledger
from videop2p_tpu_torch.obs.telemetry import sparkline


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    lines = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(str(c).ljust(w) for c, w in zip(r, widths))
              for r in rows]
    return "\n".join(lines)


def _f(v, default: float = 0.0) -> float:
    """Float, tolerating the junk a torn/partial JSONL line can carry."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _mb(v) -> str:
    return f"{_f(v) / 2**20:.1f}M"


def render(events: List[Dict]) -> str:
    """The full summary as one string (pure — tests feed synthetic events).
    Tolerant of empty event lists and partial events: every field access
    degrades to a placeholder rather than raising."""
    events = [e for e in events if isinstance(e, dict)]
    if not events:
        return "(empty ledger — no events)"
    out: List[str] = []
    start = next((e for e in events if e.get("event") == "run_start"), {})
    out.append(
        f"run {start.get('run_id', '?')}  "
        f"sha={start.get('git_sha', '?')}  jax={start.get('jax_version', '?')}  "
        f"backend={start.get('backend', '?')}×{start.get('device_count', '?')}  "
        f"mesh={start.get('mesh')}  at={start.get('wall_time', '?')}"
    )

    phases: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        if e.get("event") == "phase":
            phases[e.get("name") or "?"].append(_f(e.get("seconds")))
    if phases:
        rows = [[name, len(ts), f"{sum(ts):.2f}", f"{ts[-1]:.2f}"]
                for name, ts in phases.items()]
        rows.sort(key=lambda r: -float(r[2]))
        out += ["", "phases:", _table(rows, ["phase", "calls", "total_s", "last_s"])]

    compiles: Dict[str, List[float]] = defaultdict(list)
    calls: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"n": 0, "miss": 0, "dispatch_s": 0.0}
    )
    for e in events:
        if e.get("event") == "compile":
            compiles[e.get("program") or "(unattributed)"].append(
                _f(e.get("seconds"))
            )
        elif e.get("event") == "program_call":
            c = calls[e.get("program") or "(unattributed)"]
            c["n"] += 1
            c["miss"] += 1 if e.get("cache_miss") else 0
            c["dispatch_s"] += _f(e.get("dispatch_s"))
    if compiles or calls:
        rows = []
        for prog in sorted(set(compiles) | set(calls)):
            cs, c = compiles.get(prog, []), calls.get(prog)
            rows.append([
                prog, len(cs), f"{sum(cs):.2f}",
                int(c["n"]) if c else 0,
                int(c["miss"]) if c else 0,
                f"{c['dispatch_s']:.2f}" if c else "-",
            ])
        out += ["", "programs (compile vs execute):",
                _table(rows, ["program", "compiles", "compile_s",
                              "calls", "misses", "execute_s"])]

    # program_analysis: what XLA built per program (obs/introspect.py)
    analyses: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") == "program_analysis":
            analyses[e.get("program") or "(unattributed)"] = e
    if analyses:
        rows = [[
            prog,
            f"{_f(a.get('flops')) / 1e9:.2f}G",
            _mb(a.get("bytes_accessed")),
            _mb(a.get("temp_bytes")),
            _mb(a.get("peak_hbm_bytes")),
            str(a.get("hlo_instructions", "-")),
            str(a.get("hlo_fingerprint", "-")),
        ] for prog, a in sorted(analyses.items())]
        out += ["", "program analysis (XLA cost/memory of the compiled "
                "programs):",
                _table(rows, ["program", "flops", "bytes", "temp",
                              "peak_hbm", "instrs", "hlo_fingerprint"])]

    # comm_analysis: collective accounting of the sharded programs
    # (obs/comm.py) — static per-module counts/bytes, keyed like the
    # program-analysis table
    comms: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") == "comm_analysis":
            comms[e.get("program") or "(unattributed)"] = e
    if comms:
        rows = []
        for prog, c in sorted(comms.items()):
            per_kind = c.get("per_kind") or {}
            kinds = ", ".join(
                f"{k}×{v.get('count', '?')}" for k, v in sorted(per_kind.items())
                if isinstance(v, dict)
            ) or "-"
            rows.append([
                prog, str(c.get("num_partitions", "-")),
                str(c.get("collective_count", "-")),
                _mb(c.get("collective_bytes")), kinds,
            ])
        out += ["", "collectives (comm_analysis — static counts/bytes of "
                "the partitioned programs):",
                _table(rows, ["program", "partitions", "collectives",
                              "bytes", "per-kind"])]

    # execute_timing: per-dispatch latency distributions (obs/timing.py
    # reservoirs behind --latency) — the serving-SLO view of each program
    timing: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") == "execute_timing":
            timing[e.get("program") or "(unattributed)"] = e
    if timing:
        rows = []
        for prog, t in sorted(timing.items()):
            rows.append([
                prog, str(t.get("count", "-")),
                f"{_f(t.get('blocked_p50_s')) * 1e3:.1f}",
                f"{_f(t.get('blocked_p95_s')) * 1e3:.1f}",
                f"{_f(t.get('blocked_p99_s')) * 1e3:.1f}",
                f"{_f(t.get('blocked_max_s')) * 1e3:.1f}",
                f"{_f(t.get('dispatch_fraction')):.2f}",
            ])
        out += ["", "execute timing (blocked latency ms per dispatch; "
                "dispatch/blocked ~0 = async overlap working):",
                _table(rows, ["program", "calls", "p50", "p95", "p99",
                              "max", "disp/blk"])]

    # trace_analysis: mined device traces (obs/trace.py stdlib xplane
    # reader) — where device time actually went during the traced window
    trace_rows = []
    trace_extra: List[str] = []
    for e in events:
        if e.get("event") != "trace_analysis":
            continue
        ov = e.get("overlap_fraction")
        trace_rows.append([
            e.get("name", "?"),
            f"{_f(e.get('device_total_s')):.3f}",
            f"{_f(e.get('compute_s')):.3f}",
            f"{_f(e.get('collective_s')):.3f}",
            "-" if ov is None else f"{_f(ov):.2f}",
            f"{_f(e.get('idle_s')):.3f}",
            str(e.get("num_events", "-")),
        ])
        fams = e.get("families") or {}
        if isinstance(fams, dict) and fams:
            top = sorted(fams.items(), key=lambda kv: -_f(kv[1]))[:6]
            trace_extra.append(
                f"  {e.get('name', '?')} families: "
                + ", ".join(f"{k}={_f(v):.3f}s" for k, v in top)
            )
    if trace_rows:
        out += ["", "trace analysis (device time during traced windows; "
                "overlap = collective time hidden under compute):",
                _table(trace_rows, ["window", "total_s", "compute_s",
                                    "collective_s", "overlap", "idle_s",
                                    "events"])] + trace_extra

    skipped: Dict[str, str] = {}
    for e in events:
        if e.get("event") == "program_analysis_skipped":
            skipped[e.get("program") or "(unattributed)"] = str(
                e.get("reason", "?")
            )
    if skipped:
        out += ["", "program analysis skipped:"] + [
            f"  {prog}: {reason}" for prog, reason in sorted(skipped.items())
        ]

    dev_lines: List[str] = []
    for e in events:
        if e.get("event") != "device_telemetry":
            continue
        div = e.get("divergence_max")
        peaks = e.get("per_device_abs_max_peak") or []
        line = (f"  {e.get('program', '?')}: {e.get('devices', '?')} devices"
                f", divergence max {div} / final {e.get('divergence_final')}"
                f", NaN {e.get('nan_total', 0)}")
        if peaks:
            line += (f", abs_max peak spread "
                     f"[{min(map(_f, peaks)):.4g}, {max(map(_f, peaks)):.4g}]")
        if _f(div):
            line += "  <-- REPLICAS DIVERGED (must be 0.0)"
        dev_lines.append(line)
    for e in events:
        if e.get("event") != "divergence":
            continue
        val = _f(e.get("value"))
        dev_lines.append(
            f"  {e.get('label', '?')}: divergence {e.get('value')}"
            + ("  <-- REPLICAS DIVERGED (must be 0.0)" if val else "")
        )
    if dev_lines:
        out += ["", "per-device telemetry / replica divergence:"] + dev_lines

    host_phases = [e for e in events if e.get("event") == "host_phase"]
    if host_phases:
        # the skew math lives next to the event producer
        from videop2p_tpu_torch.parallel.distributed import phase_skew

        rows = [[name, s["hosts"], f"{s['min_s']:.2f}", f"{s['max_s']:.2f}",
                 f"{s['skew_s']:.2f}", s["slowest_process"]]
                for name, s in sorted(phase_skew(host_phases).items())]
        out += ["", "per-host phase skew (straggler visibility):",
                _table(rows, ["phase", "hosts", "min_s", "max_s",
                              "skew_s", "slowest_proc"])]

    tel_lines: List[str] = []
    for e in events:
        if e.get("event") != "telemetry":
            continue
        prog = e.get("program", "?")
        if e.get("loss_curve"):
            try:
                spark = sparkline(e["loss_curve"])
            except (TypeError, ValueError):
                spark = "?"
            tel_lines.append(
                f"  {prog}: loss {spark} "
                f"(final {e.get('loss_final')}), inner steps "
                f"{e.get('inner_steps_total')} total"
            )
        summary = e.get("summary") or e.get("latent")
        if isinstance(summary, dict):
            nan = summary.get("nan_total", 0)
            tel_lines.append(
                f"  {prog}: abs_max peak {summary.get('abs_max_peak')} / "
                f"final {summary.get('abs_max_final')}, NaN {nan}"
                + (f" (FIRST AT STEP {summary.get('first_nan_step')})"
                   if nan else "")
            )
        if e.get("telemetry_overhead_pct") is not None:
            tel_lines.append(
                f"  {prog}: telemetry overhead "
                f"{e['telemetry_overhead_pct']}% "
                f"({e.get('telemetry_off_s')}s off → "
                f"{e.get('telemetry_on_s')}s on)"
            )
    if tel_lines:
        out += ["", "telemetry:"] + tel_lines

    # edit-quality events (obs/quality.py) — the semantic numbers next to
    # the perf ones; arrays live in the .npz sidecar the event references
    for e in events:
        if e.get("event") != "quality":
            continue
        vals = ", ".join(
            f"{k}={v}" for k, v in e.items()
            if k not in ("event", "t", "program", "sidecar")
            and isinstance(v, (int, float))
        )
        out += ["", f"quality ({e.get('program', '?')}): {vals}"]
    attn_evs = [e for e in events if e.get("event") == "attn_maps"]
    if attn_evs:
        out += ["", "attention capture:"]
        for e in attn_evs:
            out.append(
                f"  {e.get('scope', '?')}: {e.get('steps', '?')} steps, "
                f"heat {e.get('heat_shape')}, "
                f"{len(e.get('sites') or [])} sites "
                f"(sidecar {e.get('sidecar', '-')})"
            )
    trace_evs = [e for e in events if e.get("event") == "trace"]
    if trace_evs:
        out += ["", "device traces:"] + [
            f"  {e.get('name', '?')} → {e.get('trace_dir', '?')}"
            for e in trace_evs
        ]

    metric_events = [e for e in events if e.get("event") == "metric"]
    if metric_events:
        last = metric_events[-1]
        curve = [e["train_loss"] for e in metric_events if "train_loss" in e]
        line = (f"  {len(metric_events)} steps logged, final "
                + ", ".join(f"{k}={v}" for k, v in last.items()
                            if k not in ("event", "t")))
        out += ["", "train metrics:", line]
        if curve:
            try:
                out.append(f"  loss {sparkline(curve)}")
            except (TypeError, ValueError):
                pass

    mems = [e for e in events if e.get("event") == "memory" and e.get("supported")]
    if mems:
        peak = max(
            (_f(d.get("peak_bytes_in_use")) for e in mems
             for d in (e.get("devices") or []) if isinstance(d, dict)),
            default=0.0,
        )
        out += ["", f"memory: {len(mems)} snapshots, peak "
                f"{peak / 2**30:.2f} GiB in use"]
        # per-device residency: worst peak per device id across snapshots
        # (sharded runs — one line only when >1 device reported stats)
        per_dev: Dict[str, float] = {}
        for e in mems:
            for d in e.get("devices") or []:
                if isinstance(d, dict) and d.get("peak_bytes_in_use") is not None:
                    key = f"device{d.get('device')}"
                    per_dev[key] = max(per_dev.get(key, 0.0),
                                       _f(d.get("peak_bytes_in_use")))
        if len(per_dev) > 1:
            out.append("  per-device peak: " + ", ".join(
                f"{k}={v / 2**30:.2f}G" for k, v in sorted(per_dev.items())
            ))
        # predicted-vs-measured: the largest per-program peak-HBM estimate
        # (XLA memory_analysis) against the device's measured peak — the
        # HBM-gate sanity line (predicted covers ONE program's residency;
        # measured can exceed it when executables/buffers coexist)
        if analyses:
            pred_prog, pred = max(
                ((p, _f(a.get("peak_hbm_bytes"))) for p, a in analyses.items()),
                key=lambda kv: kv[1],
            )
            if pred > 0 and peak > 0:
                out.append(
                    f"  predicted peak-HBM (largest program, {pred_prog}): "
                    f"{pred / 2**30:.2f} GiB vs measured {peak / 2**30:.2f} "
                    f"GiB ({peak / pred:.2f}× predicted)"
                )

    # fleet telemetry plane: fleet_signals evaluations from
    # the collector's signal engine + the fleet_series tsdb snapshot
    sig_evs = [e for e in events if e.get("event") == "fleet_signals"]
    if sig_evs:
        last = sig_evs[-1]
        advice_seq = "".join(
            {"grow": "G", "hold": ".", "shrink": "s"}.get(
                str(e.get("scale_advice")), "?")
            for e in sig_evs
        )
        out += ["", "fleet signals (obs/signals.py over the scraped tsdb):",
                f"  {len(sig_evs)} evaluations, burn alerts "
                f"{last.get('burn_alerts', 0)}, advice timeline [{advice_seq}]"
                f" (G=grow .=hold s=shrink)",
                f"  last: burn fast={_f(last.get('burn_fast')):.2f} "
                f"slow={_f(last.get('burn_slow')):.2f}  "
                f"saturation={_f(last.get('saturation')):.2f}  "
                f"queue_slope={_f(last.get('queue_slope')):.4f}/s  "
                f"replicas {last.get('replicas_up', '?')}/"
                f"{last.get('replicas_total', '?')} up  "
                f"scrape_errors={_f(last.get('scrape_errors')):.0f} "
                f"(rate {_f(last.get('scrape_error_rate')):.3f})  "
                f"advice={last.get('scale_advice', '?')}"]
        for reason in last.get("reasons") or []:
            out.append(f"    reason: {reason}")
        tenants = last.get("tenants")
        if isinstance(tenants, dict) and tenants:
            rows = [[t,
                     f"{_f(v.get('submitted_rate')):.3f}",
                     f"{_f(v.get('served_rate')):.3f}",
                     f"{_f(v.get('shed_rate')):.3f}",
                     f"{_f(v.get('device_seconds')):.3f}"]
                    for t, v in sorted(tenants.items())
                    if isinstance(v, dict)]
            out += ["", "  per-tenant demand (rates over the slow window):",
                    _table(rows, ["tenant", "submit/s", "served/s",
                                  "shed/s", "device_s"])]
    for e in events:
        if e.get("event") != "fleet_series":
            continue
        out += ["", f"fleet series ({e.get('label', '?')}): "
                f"{e.get('series', '?')} series / {e.get('samples', '?')} "
                f"samples, {e.get('gaps', 0)} gaps, {e.get('dropped', 0)} "
                f"dropped, span [{e.get('t_first')}, {e.get('t_last')}]s "
                f"(sidecar {e.get('sidecar', '-')})"]

    end = next((e for e in events if e.get("event") == "run_end"), None)
    if end is not None:
        out += ["", f"run ended at t={end.get('t')}s "
                f"({end.get('compile_events', 0)} compile events)"]
    return "\n".join(out)


def main(argv: List[str]) -> int:
    if any(a in ("-h", "--help") for a in argv[1:]):
        print(__doc__.strip())
        return 0
    if len(argv) != 2:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    try:
        events = read_ledger(argv[1])
    except OSError as e:
        print(f"ledger_summary: cannot read {argv[1]}: {e}", file=sys.stderr)
        return 2
    print(render(events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
