"""Device-trace mining (port of ``videop2p_tpu/obs/trace.py``): a reader of
the chrome-trace JSON ``torch.profiler`` exports, and the timeline analyses
the time-domain obs layer ledgers.

The JAX package decodes ``jax.profiler``'s ``*.xplane.pb`` protos; the
port's traces are Kineto's chrome traces (``*.json`` or ``*.json.gz``),
read with the standard library's ``json`` and ``gzip`` and numpy only, so
the HTML report can mine a trace directory copied to any machine. From a
trace's ``traceEvents``:

  * op events — the device events of category ``kernel``, ``gpu_memcpy``
    and ``gpu_memset`` (the counterpart of XLA's "XLA Ops" line);
  * module events — the ``gpu_user_annotation`` ranges, i.e. the device
    span of each ``record_function`` range, which ``obs/ledger.py:
    program_label`` opens under the program's label while the profiler
    records (the counterpart of "XLA Modules").

Both come as ``(name, start_ps, duration_ps)``, from the trace's
microsecond ``ts`` and ``dur``. :func:`analyze_events` keeps the JAX
package's semantics and record (``TRACE_ANALYSIS_FIELDS``, ``families``,
``top_ops`` and the ``.npz`` sidecar arrays): plain-sum device time,
compute and collective union lengths, the compute/collective overlap
fraction (None without a collective, as on one card), idle time over the
span and the largest gap. :func:`op_family` is the port's own table of
CUDA kernel names: the hand kernels' four families (frame attention, the
flash forward, the flash backward, GroupNorm), then gemm, conv, softmax,
reduce, elementwise, copy (memcpy, memset, layout transforms) and
collective (NCCL, which :func:`is_collective_op` matches).

:func:`trace_window` captures a region with ``torch.profiler`` and writes
the ``trace_analysis`` ledger event (``trace_analysis_skipped`` when the
profiler or the mining fails, or when a CUDA trace holds no device event:
a capture that lost its kernels is not a record of zeros). torch is
imported there, never at module import.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import tempfile
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TRACE_ANALYSIS_FIELDS",
    "OP_CATEGORIES",
    "MODULE_CATEGORY",
    "load_chrome_traces",
    "trace_events",
    "op_family",
    "is_collective_op",
    "interval_union",
    "union_length",
    "overlap_fraction",
    "analyze_events",
    "analyze_trace_dir",
    "capture",
    "trace_window",
]

# the JAX package's schema-stable field set of a trace_analysis event
# (TIMING_RULES reference these names)
TRACE_ANALYSIS_FIELDS = (
    "name",
    "trace_dir",
    "device_total_s",
    "compute_s",
    "collective_s",
    "overlap_fraction",
    "span_s",
    "idle_s",
    "idle_max_s",
    "num_events",
    "num_ops",
    "module_total_s",
    "module_span_s",
)

# device-timeline categories of Kineto's chrome trace
OP_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
MODULE_CATEGORY = "gpu_user_annotation"

# (family, substrings of the lowercased kernel name), first match wins: the
# hand kernels first (ops/csrc), then convolutions before gemms (cuDNN's
# Hopper kernels are "sm90_xmma_fprop_implicit_gemm_..." kernels)
_FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("frame_attention", ("frame_attention",)),
    ("flash_attention_fwd", ("flash_fwd",)),
    ("flash_attention_bwd", ("flash_bwd",)),
    ("group_norm", ("gn_persistent",)),
    ("collective", ("nccl",)),
    ("conv", ("cudnn", "fprop", "dgrad", "wgrad", "implicit_convolve", "implicit_gemm",
              "conv")),
    ("gemm", ("gemm", "gemv", "cutlass", "cublas", "xmma", "nvjet")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy", "nchwtonhwc", "nhwctonchw", "transpose")),
    ("elementwise", ("elementwise",)),
)


# ------------------------------------------------------------ the reader --


def load_chrome_traces(trace_dir: str) -> List[Dict[str, Any]]:
    """Every chrome trace under ``trace_dir`` (recursive; ``*.json`` and
    ``*.json.gz``), parsed."""
    traces = []
    paths = sorted(set(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True))
                   | set(glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                                   recursive=True)))
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            data = json.load(f)
        if isinstance(data, dict) and "traceEvents" in data:
            traces.append(data)
        elif isinstance(data, list):  # a bare event list is valid chrome format
            traces.append({"traceEvents": data})
    return traces


def trace_events(traces: Iterable[Dict[str, Any]],
                 categories: Sequence[str]) -> List[Tuple[str, int, int]]:
    """``(name, start_ps, duration_ps)`` of every complete event (``ph``
    "X") of the given categories, in start order; ``ts`` and ``dur`` are
    microseconds."""
    cats = set(categories)
    out = []
    for trace in traces:
        for ev in trace.get("traceEvents", ()):
            if ev.get("ph") != "X" or ev.get("cat") not in cats:
                continue
            try:
                start = int(round(float(ev["ts"]) * 1e6))
                dur = int(round(float(ev.get("dur", 0)) * 1e6))
            except (KeyError, TypeError, ValueError):
                continue
            out.append((str(ev.get("name", "?")), start, dur))
    out.sort(key=lambda e: (e[1], e[0]))
    return out


# ------------------------------------------------------ timeline algebra --


def _short_name(name: str) -> str:
    """A kernel's demangled name without return type, namespaces, template
    arguments and parameters."""
    base = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)", "")
    base = base.split("(")[0]
    depth, cut = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            cut.append(ch)
    return "".join(cut).split("::")[-1].strip() or name


def op_family(name: str) -> str:
    """The family of a CUDA kernel, memcpy or memset by its name (the
    module docstring's table); any other kernel is its own family, by its
    short name."""
    low = name.lower()
    for fam, keys in _FAMILIES:
        if any(k in low for k in keys):
            return fam
    return _short_name(name)


def is_collective_op(name: str) -> bool:
    return "nccl" in name.lower()


def interval_union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge ``(start, end)`` intervals into a sorted disjoint union;
    zero- and negative-length inputs are dropped."""
    ivs = sorted((s, e) for s, e in intervals if e > s)
    out: List[Tuple[int, int]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_length(intervals: Iterable[Tuple[int, int]]) -> int:
    return sum(e - s for s, e in interval_union(intervals))


def _intersect_length(a: Sequence[Tuple[int, int]], b: Sequence[Tuple[int, int]]) -> int:
    """Length of the intersection of two disjoint sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def overlap_fraction(compute: Iterable[Tuple[int, int]],
                     collective: Iterable[Tuple[int, int]]) -> Optional[float]:
    """``|union(compute) ∩ union(collective)| / |union(collective)|``:
    disjoint → 0.0, collectives inside compute → 1.0; None when there is
    no collective time at all (one card)."""
    coll = interval_union(collective)
    denom = sum(e - s for s, e in coll)
    if denom <= 0:
        return None
    return _intersect_length(interval_union(compute), coll) / denom


# ----------------------------------------------------------- analyses --


def analyze_events(
    op_events: Sequence[Tuple[str, int, int]],
    module_events: Sequence[Tuple[str, int, int]] = (),
    *,
    name: str = "trace",
    trace_dir: Optional[str] = None,
    top_n: int = 12,
) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``(op_name, start_ps, duration_ps)`` events → the ``trace_analysis``
    record and the ``.npz`` sidecar arrays (JAX's record and semantics:
    ``device_total_s`` a plain sum, ``compute_s`` / ``collective_s`` union
    lengths, idle against the union of all device events over the span)."""
    fam_ps: Dict[str, int] = {}
    op_ps: Dict[str, List[int]] = {}
    comp_iv: List[Tuple[int, int]] = []
    coll_iv: List[Tuple[int, int]] = []
    total_ps = 0
    for op, start, dur in op_events:
        total_ps += dur
        fam = op_family(op)
        fam_ps[fam] = fam_ps.get(fam, 0) + dur
        acc = op_ps.setdefault(op, [0, 0])
        acc[0] += dur
        acc[1] += 1
        (coll_iv if is_collective_op(op) else comp_iv).append((start, start + dur))
    all_iv = interval_union(comp_iv + coll_iv)
    span_ps = (all_iv[-1][1] - all_iv[0][0]) if all_iv else 0
    busy_ps = sum(e - s for s, e in all_iv)
    gaps = [all_iv[k + 1][0] - all_iv[k][1] for k in range(len(all_iv) - 1)]
    module_iv = interval_union((s, s + d) for _, s, d in module_events)
    top = sorted(op_ps.items(), key=lambda kv: -kv[1][0])[:top_n]
    of = overlap_fraction(comp_iv, coll_iv)
    record: Dict[str, Any] = {
        "name": name,
        "trace_dir": trace_dir,
        "device_total_s": round(total_ps / 1e12, 9),
        "compute_s": round(union_length(comp_iv) / 1e12, 9),
        "collective_s": round(union_length(coll_iv) / 1e12, 9),
        "overlap_fraction": None if of is None else round(of, 4),
        "span_s": round(span_ps / 1e12, 9),
        "idle_s": round((span_ps - busy_ps) / 1e12, 9),
        "idle_max_s": round(max(gaps, default=0) / 1e12, 9),
        "num_events": len(op_events),
        "num_ops": len(op_ps),
        "module_total_s": round(sum(d for _, _, d in module_events) / 1e12, 6),
        "module_span_s": round((module_iv[-1][1] - module_iv[0][0]) / 1e12
                               if module_iv else 0.0, 6),
        "families": {fam: round(ps / 1e12, 9)
                     for fam, ps in sorted(fam_ps.items(), key=lambda kv: -kv[1])},
        "top_ops": [{"op": op, "seconds": round(ps / 1e12, 9), "count": cnt}
                    for op, (ps, cnt) in top],
    }
    key = f"trace_{name}"
    arrays: Dict[str, np.ndarray] = {
        f"{key}/op_start_ps": np.asarray([s for _, s, _ in op_events], np.int64),
        f"{key}/op_dur_ps": np.asarray([d for _, _, d in op_events], np.int64),
        f"{key}/op_is_collective": np.asarray(
            [is_collective_op(op) for op, _, _ in op_events], bool),
        f"{key}/module_start_ps": np.asarray([s for _, s, _ in module_events], np.int64),
        f"{key}/module_dur_ps": np.asarray([d for _, _, d in module_events], np.int64),
    }
    return record, arrays


def analyze_trace_dir(trace_dir: str, *, name: str = "trace",
                      top_n: int = 12) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Load and mine every chrome trace under ``trace_dir``. A trace with
    no device event (a CPU capture) still gives a well-formed record:
    zeros, ``overlap_fraction`` None, ``num_events`` 0."""
    traces = load_chrome_traces(trace_dir)
    return analyze_events(trace_events(traces, OP_CATEGORIES),
                          trace_events(traces, (MODULE_CATEGORY,)),
                          name=name, trace_dir=trace_dir, top_n=top_n)


def capture(device=None):
    """A ``torch.profiler`` capture (not started) of the host's activity
    and, when ``device`` is a CUDA device, the card's: the host's
    ``record_function`` ranges are what the card's ``gpu_user_annotation``
    module events project.

    Kineto keeps CUPTI alive across captures by default, and then drops
    the kernels of a capture taken minutes after the first (CUPTI's clock
    drifts; ``utils/profiler_probe.py``): ``TEARDOWN_CUPTI=1`` is set here
    unless the variable is set. Kineto reads it when a capture stops, not
    when torch loads (torch's own profiler writes it just before a capture
    starts), so setting it here is in time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    cuda = device is not None and torch.device(device).type == "cuda"
    return profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []))


def _launch_counts() -> Dict[str, int]:
    """The hand kernels' own launch counters (``ops/``)."""
    from videop2p_tpu_torch.ops import attention as fa
    from videop2p_tpu_torch.ops import groupnorm as gn

    bwd = fa.flash_bwd_launch_counts()
    return {"frame_attention": fa.launch_count(), "group_norm": gn.launch_count(),
            "flash_attention": fa.flash_launch_count(),
            "flash_bwd_dkv": bwd["dkv"], "flash_bwd_dq": bwd["dq"]}


@contextlib.contextmanager
def trace_window(name: str, *, trace_dir: Optional[str] = None, device=None,
                 sidecar: bool = True, top_n: int = 12) -> Iterator[str]:
    """Capture the region with ``torch.profiler`` (:func:`capture`) and
    mine it.

    ``device`` is the device the region computes on; the region should
    synchronize the card before it ends. On exit the chrome trace is exported to
    ``<trace_dir>/trace_<name>.json`` and mined (:func:`analyze_trace_dir`)
    into a ``trace_analysis`` event of the active ledger, with the
    per-event arrays in ``<trace_dir>/trace_<name>.npz`` and the hand
    kernels' launch counters over the window (``launches``). A profiler or
    mining failure, or a CUDA capture with no device event, writes
    ``trace_analysis_skipped`` with the reason instead; nothing raises into
    the traced code. With no active ledger the capture is still written.
    """
    import torch

    from videop2p_tpu_torch.obs.ledger import current_ledger

    cuda = device is not None and torch.device(device).type == "cuda"
    target = trace_dir or tempfile.mkdtemp(prefix=f"videop2p_trace_{name}_")
    os.makedirs(target, exist_ok=True)
    prof = None
    try:
        prof = capture(device)
        prof.__enter__()
    except Exception:  # noqa: BLE001 — a second active profiler is not fatal
        prof = None
    before = _launch_counts()
    try:
        yield target
    finally:
        after = _launch_counts()
        led = current_ledger()
        reason = None
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(target, f"trace_{name}.json"))
            except Exception:  # noqa: BLE001
                prof = None
        if prof is None:
            reason = "profiler_unavailable"
        else:
            try:
                record, arrays = analyze_trace_dir(target, name=name, top_n=top_n)
                if cuda and record["num_events"] == 0:
                    reason = "no_device_events"
                else:
                    sidecar_path = None
                    if sidecar and arrays:
                        sidecar_path = os.path.join(target, f"trace_{name}.npz")
                        np.savez_compressed(sidecar_path, **arrays)
                    if led is not None:
                        led.event("trace_analysis", sidecar=sidecar_path,
                                  launches={k: after[k] - before[k] for k in after},
                                  **record)
            except Exception:  # noqa: BLE001 — mining never kills a run
                reason = "analysis_error"
        if reason is not None and led is not None:
            led.event("trace_analysis_skipped", name=name, reason=reason, trace_dir=target)
