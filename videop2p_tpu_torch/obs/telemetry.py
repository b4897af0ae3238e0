"""Per-step telemetry of the pipelines' loops (port of
``videop2p_tpu/obs/telemetry.py``).

:func:`latent_stats` is the probe: four 0-d tensors of one latent (the
finite elements' abs-max and mean, the NaN and inf counts), left on the
device. A loop collects one such dict a step and stacks them once after the
loop, so telemetry adds no host synchronisation inside a step; it is
opt-in (``telemetry=False`` everywhere), and the loops' outputs are the
same bits either way.

On the host, :func:`decode_step_stats`, :func:`summarize_step_stats` and
:func:`decode_null_text_stats` turn the stacked curves into the records the
run ledger's ``telemetry`` events carry.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

__all__ = [
    "latent_stats",
    "stack_step_stats",
    "to_host",
    "decode_step_stats",
    "summarize_step_stats",
    "decode_null_text_stats",
    "sparkline",
    "telemetry_overhead_record",
    "measure_overhead",
]


def latent_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scalar statistics of one latent, as 0-d tensors on its device:
    ``abs_max`` and ``mean`` over the finite elements only (one NaN would
    otherwise hide where a blow-up started), and the NaN and inf counts
    (int32), the explicit detectors."""
    xf = x.float()
    finite = torch.isfinite(xf)
    safe = torch.where(finite, xf, torch.zeros((), dtype=xf.dtype, device=xf.device))
    nan = torch.isnan(xf)
    return {
        "abs_max": safe.abs().amax(),
        "mean": safe.mean(),
        "nan_count": nan.sum().to(torch.int32),
        "inf_count": (~finite & ~nan).sum().to(torch.int32),
    }


def stack_step_stats(records: List[Dict]) -> Dict:
    """Per-step dicts of 0-d tensors (or nested dicts of them) → one dict
    of (num_steps,) tensors, still on the device: what JAX's scan stacks."""
    if not records:
        return {}
    out = {}
    for k, v in records[0].items():
        if isinstance(v, dict):
            out[k] = stack_step_stats([r[k] for r in records])
        else:
            out[k] = torch.stack([r[k] for r in records])
    return out


def to_host(tree):
    """A record (a tensor, an array or nested dicts of them) as numpy on the
    host: the one read after a loop."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def decode_step_stats(stats: Dict) -> List[Dict[str, float]]:
    """Stacked (num_steps,) curves → one record per step; no fields or
    zero-length curves decode to ``[]`` (a killed run's partial stats still
    land in the ledger)."""
    host = {k: to_host(v) for k, v in stats.items()}
    n = min((len(v) for v in host.values()), default=0)
    out = []
    for i in range(n):
        rec = {"step": i}
        for k, v in host.items():
            val = v[i].item()
            rec[k] = round(val, 6) if isinstance(val, float) else val
        out.append(rec)
    return out


def summarize_step_stats(stats: Dict) -> Dict[str, float]:
    """The ledger-sized summary of per-step curves: the abs-max peak and
    final value, the final mean, the NaN / inf totals and the first step
    each appeared at, and the mean of any other field. No fields or
    zero-length curves give ``{"steps": 0}``."""
    host = {k: to_host(v).astype(np.float64) for k, v in stats.items()}
    n = min((len(v) for v in host.values()), default=0)
    summary: Dict[str, float] = {"steps": int(n)}
    if n == 0:
        return summary
    if "abs_max" in host:
        summary["abs_max_peak"] = round(float(host["abs_max"].max()), 6)
        summary["abs_max_final"] = round(float(host["abs_max"][-1]), 6)
    if "mean" in host:
        summary["mean_final"] = round(float(host["mean"][-1]), 6)
    for k in ("nan_count", "inf_count"):
        if k in host:
            total = int(host[k].sum())
            summary[k.replace("_count", "_total")] = total
            if total:
                summary[f"first_{k.replace('_count', '')}_step"] = int(
                    np.argmax(host[k] > 0))
    for k in host:
        if k not in ("abs_max", "mean", "nan_count", "inf_count"):
            summary[f"{k}_mean"] = round(float(host[k].mean()), 6)
    return summary


def decode_null_text_stats(stats: Dict) -> Dict:
    """Null-text optimization's ``{"final_loss", "inner_steps"[,
    "latent_stats"]}`` → the ledger record: the per-outer-step loss curve,
    the inner Adam steps taken, and the latent telemetry summarized."""
    losses = to_host(stats["final_loss"]).astype(np.float64)
    inner = to_host(stats["inner_steps"]).astype(np.int64)
    rec = {
        "loss_curve": [round(float(v), 8) for v in losses],
        "inner_steps": [int(v) for v in inner],
        "inner_steps_total": int(inner.sum()),
        "loss_final": round(float(losses[-1]), 8),
        "loss_max": round(float(losses.max()), 8),
    }
    if stats.get("latent_stats") is not None:
        rec["latent"] = summarize_step_stats(stats["latent_stats"])
    return rec


_SPARK_LEVELS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 50) -> str:
    """Unicode sparkline of a numeric series; a non-finite value renders as
    ``!``, a flat series as ``▄``."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:  # downsample by striding, keep the last point
        idx = [round(i * (len(vals) - 1) / (width - 1)) for i in range(width)]
        vals = [vals[i] for i in idx]
    finite = [v for v in vals if np.isfinite(v)]
    if not finite:
        return "!" * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if not np.isfinite(v):
            out.append("!")
        elif span <= 0:
            out.append("▄")
        else:
            out.append(_SPARK_LEVELS[int((v - lo) / span * (len(_SPARK_LEVELS) - 1))])
    return "".join(out)


def telemetry_overhead_record(off_s: float, on_s: float) -> Dict[str, float]:
    """Wall time of one program with telemetry off and on, and the
    overhead in percent."""
    return {
        "telemetry_off_s": round(float(off_s), 4),
        "telemetry_on_s": round(float(on_s), 4),
        "telemetry_overhead_pct": round(
            (float(on_s) / max(float(off_s), 1e-12) - 1.0) * 100.0, 2),
    }


def measure_overhead(run_off, run_on, *, repeats: int = 3) -> Dict[str, float]:
    """Median-of-``repeats`` comparison of two callables (each must wait for
    its own result), after one untimed call of each."""
    run_off()
    run_on()
    offs, ons = [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run_off()
        offs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run_on()
        ons.append(time.perf_counter() - t0)
    return telemetry_overhead_record(sorted(offs)[len(offs) // 2],
                                     sorted(ons)[len(ons) // 2])
