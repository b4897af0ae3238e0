"""The streaming edit driver: long footage as resumable window jobs (port of
``videop2p_tpu/stream/driver.py``).

:func:`run_stream_job` chunks a long clip into overlapping temporal windows
(:mod:`videop2p_tpu_torch.stream.windows`), runs every window through a
warm :class:`~videop2p_tpu_torch.serve.engine.EditEngine` as an ordinary
edit request — windows that differ only in frame content share every
program, and with ``max_inflight`` > 1 the engine's scheduler may batch
compatible windows into one dispatch like concurrent tenants — and
re-assembles the edited windows with a deterministic crossfade. Device
memory stays FLAT per window: each harvested result is popped off the
engine (:meth:`EditEngine.take_videos`), persisted to the job manifest's
sidecar, and released.

  * **resume** — every window's terminal state persists atomically in the
    :class:`~videop2p_tpu_torch.stream.manifest.JobManifest` as it lands; a
    killed or preempted job restarted over the same job dir SKIPS every
    validated window (no request, no inversion for it) and recomputes only
    the rest, bit for bit as an uninterrupted run.
  * **per-window fault isolation** — a window whose request fails is
    retried up to ``window_retries`` times at the job level (the engine's
    :class:`~videop2p_tpu_torch.serve.faults.RetryPolicy` absorbs transient
    dispatch faults underneath); a window still failing is POISONED and
    degrades to a recorded ``passthrough`` (its source frames, crossfaded
    like any other window) instead of killing the job, unless
    ``degrade=False``.
  * **checkpoint-then-exit** — ``stop_event`` (the CLI's SIGTERM handler
    sets it) stops new submissions, harvests what is in flight so its
    windows persist, writes the health summary with ``interrupted=1`` and
    returns; the next invocation resumes.
  * **seam quality** — each window boundary's adjacent-frame PSNR
    (``obs/quality.py``) lands in ``stream_seam`` events and the job-level
    ``stream_health`` summary (:data:`STREAM_HEALTH_FIELDS`).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from videop2p_tpu_torch.obs.spans import (
    format_traceparent,
    make_span_id,
    make_trace_id,
)
from videop2p_tpu_torch.stream.manifest import JobManifest
from videop2p_tpu_torch.stream.windows import (
    Window,
    assemble_video,
    plan_windows,
    seam_spans,
    window_key,
)

__all__ = [
    "run_stream_job",
    "StreamJobResult",
    "STREAM_HEALTH_FIELDS",
    "STREAM_WINDOW_FIELDS",
    "STREAM_SEAM_FIELDS",
]

# the job-level `stream_health` summary's fields: the JAX package's tuple,
# so both packages' ledgers read alike
STREAM_HEALTH_FIELDS = (
    "total_frames", "window", "overlap", "windows_total", "windows_done",
    "windows_passthrough", "windows_skipped", "windows_failed", "retries",
    "interrupted", "manifest_corrupt", "manifest_recovered",
    "store_disk_hits", "store_memory_hits", "fresh_inversions",
    "src_err_max", "seams", "seam_min_psnr", "seam_mean_psnr",
    "source_seam_min_psnr",
)

# the per-window and per-seam ledger records
STREAM_WINDOW_FIELDS = ("index", "key", "status", "attempts",
                        "store_source", "src_err", "window_s")
STREAM_SEAM_FIELDS = ("left", "right", "start", "stop", "seam_psnr",
                      "source_psnr")


@dataclass
class StreamJobResult:
    """What a (possibly interrupted) streaming job hands back."""

    video: Optional[np.ndarray]  # (total, H, W, 3) [0,1]; None if interrupted
    health: Dict[str, Any]
    manifest: JobManifest
    seams: List[Dict[str, Any]] = field(default_factory=list)
    windows: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return self.video is not None


def _seam_metrics(video01: np.ndarray, source01: np.ndarray,
                  plan: Sequence[Window]) -> List[Dict[str, Any]]:
    """Per-seam adjacent-frame consistency over the assembled clip: for
    each window boundary, the WORST adjacent-frame PSNR across the
    transitions entering, crossing and leaving the blended overlap —
    plus the source clip's own number over the same transitions (a
    fast-moving source is allowed a low absolute seam PSNR; the gate
    compares runs, not absolutes)."""
    from videop2p_tpu_torch.obs.quality import adjacent_frame_psnr

    total = video01.shape[0]
    out = []
    for span in seam_spans(plan):
        a = max(span["start"] - 1, 0)
        b = min(span["stop"] + 1, total)
        if b - a < 2:
            continue
        seam = float(np.min(np.asarray(
            adjacent_frame_psnr(video01[a:b])
        )))
        src = float(np.min(np.asarray(
            adjacent_frame_psnr(source01[a:b])
        )))
        out.append({
            "left": span["left"], "right": span["right"],
            "start": span["start"], "stop": span["stop"],
            "seam_psnr": round(seam, 4) if np.isfinite(seam) else seam,
            "source_psnr": round(src, 4) if np.isfinite(src) else src,
        })
    return out


def run_stream_job(
    engine,
    frames: np.ndarray,
    prompts: Sequence[str],
    *,
    job_dir: str,
    overlap: int = 2,
    seed: int = 0,
    save_name: str = "stream",
    request_kwargs: Optional[Dict[str, Any]] = None,
    window_retries: int = 2,
    max_inflight: int = 4,
    resume: bool = True,
    degrade: bool = True,
    stop_event: Optional[Any] = None,
    faults: Optional[Any] = None,
    wait_s: float = 600.0,
    submit_retry_s: float = 0.1,
) -> StreamJobResult:
    """Run (or resume) one streaming edit job; see the module docstring.

    ``engine`` must keep videos for harvesting (``keep_videos=True``): the
    job pops each result as it lands, so residency stays as deep as the
    windows in flight. The window size is the engine spec's ``video_len``
    (the warm programs take exactly that many frames); ``overlap`` frames
    are shared between neighbours and crossfaded at assembly.
    ``request_kwargs`` are the per-window :class:`EditRequest` fields (the
    controller's: ``is_word_swap``, ``blend_word``, ``cross_replace_steps``,
    ...). ``faults`` is the plan whose ``corrupt:manifest`` directive tears
    manifest writes; dispatch chaos (``fail@K``, ``hang@K:S``) goes to the
    ENGINE's plan, since windows are requests.
    """
    if not getattr(engine, "keep_videos", False):
        raise ValueError(
            "run_stream_job needs keep_videos=True on the engine — the "
            "job harvests each window's frames in-process"
        )
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (F, H, W, 3), got {frames.shape}")
    window = int(engine.spec.video_len)
    total = int(frames.shape[0])
    plan = plan_windows(total, window, int(overlap))
    spec_fp = engine.spec.fingerprint()
    request_kwargs = dict(request_kwargs or {})
    import hashlib

    identity = {
        "spec_fingerprint": spec_fp,
        "clip_sha": hashlib.sha256(
            np.ascontiguousarray(frames).tobytes()
        ).hexdigest()[:16],
        "prompts": list(prompts),
        "seed": int(seed),
        "request": {k: request_kwargs[k] for k in sorted(request_kwargs)},
        "total_frames": total,
        "window": window,
        "overlap": int(overlap),
    }
    manifest = JobManifest(job_dir, identity, faults=faults)
    if resume:
        manifest.load()
    else:
        manifest.entries = {}

    ledger = getattr(engine, "ledger", None)
    # job-scoped tracing: when the ENGINE traces, the job gets
    # a root `stream.job` span and one `stream.window` child per window
    # spanning submit→harvest — resumed windows appear as zero-duration
    # "cached" spans, so a resumed job's trace shows exactly what was
    # recomputed. Tracing off: tracer.emit is inert, nothing changes.
    tracer = getattr(engine, "tracer", None)
    tracing = tracer is not None and getattr(tracer, "enabled", False)
    trace_id = make_trace_id() if tracing else None
    job_span = make_span_id() if tracing else None
    job_wall = time.time_ns() if tracing else None
    job_t0 = time.perf_counter()
    wspans: Dict[int, tuple] = {}  # index -> (span_id, wall_ns, t0)
    keys = {
        w.index: window_key(spec_fp, frames[w.start:w.stop], prompts,
                            seed=seed, extra=identity["request"])
        for w in plan
    }
    outputs: Dict[int, np.ndarray] = {}
    skipped = 0
    for w in plan:
        entry = manifest.entries.get(w.index)
        if entry is not None and entry.get("key") != keys[w.index]:
            # identity matches but the per-window key doesn't — a plan
            # geometry change under the same job dir; recompute
            manifest.entries.pop(w.index, None)
            continue
        cached = manifest.valid_output(w.index)
        if cached is not None:
            outputs[w.index] = cached
            skipped += 1
            if tracing:
                tracer.emit(
                    "stream.window", trace_id=trace_id,
                    span_id=make_span_id(), parent_id=job_span,
                    duration_s=0.0, status="cached", index=w.index,
                    cached=True,
                )

    counters = {
        "done": 0, "passthrough": 0, "failed": 0, "retries": 0,
        "disk": 0, "memory": 0, "fresh": 0,
    }
    src_err_max = 0.0
    window_records: List[Dict[str, Any]] = []
    interrupted = False

    def _stopped() -> bool:
        return stop_event is not None and stop_event.is_set()

    def _submit(w: Window) -> Optional[str]:
        """Submit one window request, riding out brief refusals (breaker
        open / queue full) on a bounded deterministic schedule; None
        means the engine would not take it within the window's retry
        budget."""
        from videop2p_tpu_torch.serve.engine import EditRequest

        req = EditRequest(
            frames=frames[w.start:w.stop],
            prompt=list(prompts)[0],
            prompts=list(prompts),
            save_name=f"{save_name}_w{w.index:04d}",
            seed=int(seed),
            **request_kwargs,
        )
        tp = None
        if tracing:
            # one span per window across ALL its attempts: keep the first
            # submit's anchor so the span covers submit→harvest
            if w.index not in wspans:
                wspans[w.index] = (make_span_id(), time.time_ns(),
                                   time.perf_counter())
            tp = format_traceparent(trace_id, wspans[w.index][0])
        for attempt in range(max(int(window_retries), 0) + 1):
            try:
                return engine.submit(req, traceparent=tp)
            except Exception as e:  # noqa: BLE001 — refusal is data, not a crash
                counters["retries"] += 1
                if ledger is not None:
                    ledger.event("stream_window_retry", index=w.index,
                                 phase="submit", error=f"{type(e).__name__}: {e}")
                retry_after = getattr(e, "retry_after_s", None)
                time.sleep(min(max(float(retry_after or 0.0), submit_retry_s),
                               2.0))
        return None

    def _finish_window(w: Window, status: str, out_frames: np.ndarray,
                       attempts: int, rec: Optional[Dict[str, Any]],
                       error: Optional[str] = None) -> None:
        nonlocal src_err_max
        src_err = rec.get("src_err") if rec else None
        store_source = rec.get("store_source") if rec else None
        if status == "done" and src_err is not None:
            src_err_max = max(src_err_max, float(src_err))
            counters[{"disk": "disk", "memory": "memory",
                      "fresh": "fresh"}.get(store_source, "fresh")] += 1
        manifest.complete_window(
            w.index, keys[w.index], out_frames, status=status,
            attempts=attempts, src_err=src_err, store_source=store_source,
            error=error,
        )
        outputs[w.index] = np.asarray(out_frames, np.float32)
        counters[status if status == "done" else "passthrough"] += 1
        window_s = rec.get("total_s") if rec else None
        record = {
            "index": w.index, "key": keys[w.index], "status": status,
            "attempts": attempts, "store_source": store_source,
            "src_err": src_err, "window_s": window_s,
        }
        window_records.append(record)
        if ledger is not None:
            ledger.event("stream_window", **record)
            if window_s is not None:
                ledger.record_execute(
                    "stream_window_e2e", float(window_s), float(window_s),
                    trace_id if tracing else None,
                )
        if tracing:
            sp = wspans.get(w.index)
            if sp is not None:
                span_id, wall_w, t0_w = sp
                tracer.emit(
                    "stream.window", trace_id=trace_id, span_id=span_id,
                    parent_id=job_span, wall_ns=wall_w,
                    duration_s=time.perf_counter() - t0_w, status=status,
                    index=w.index, attempts=attempts,
                )

    def _passthrough(w: Window, attempts: int, error: str) -> None:
        counters["failed"] += 1
        if not degrade:
            raise RuntimeError(
                f"window {w.index} poisoned after {attempts} attempt(s): "
                f"{error} (degrade=False)"
            )
        # incident plane: a poisoned window that degrades to passthrough is
        # quality loss the job will not report as an error — capture the
        # evidence now (debounced: a poisoned RUN is one bundle)
        inc = getattr(engine, "incidents", None)
        if inc is not None:
            inc.trigger("window_poisoned",
                        detail=f"window {w.index} degraded to passthrough "
                               f"after {attempts} attempt(s): {error}",
                        index=w.index, attempts=attempts)
        src01 = frames[w.start:w.stop].astype(np.float32) / 255.0
        _finish_window(w, "passthrough", src01, attempts, None, error=error)

    pending = deque(w for w in plan if w.index not in outputs)
    inflight: "deque[tuple]" = deque()  # (rid, window, attempts)
    attempts_left = {w.index: max(int(window_retries), 0) + 1 for w in plan}
    while pending or inflight:
        while (pending and len(inflight) < max(int(max_inflight), 1)
               and not _stopped()):
            w = pending.popleft()
            used = max(int(window_retries), 0) + 2 - attempts_left[w.index]
            rid = _submit(w)
            if rid is None:
                _passthrough(w, used, "engine refused the window "
                                      "(submit retries exhausted)")
                continue
            inflight.append((rid, w, used))
        if not inflight:
            if _stopped():
                interrupted = bool(pending)
                break
            continue
        rid, w, used = inflight.popleft()
        rec = engine.result(rid, wait_s=wait_s)
        status = rec.get("status")
        if status == "done":
            videos = engine.take_videos(rid)
            if videos is None:
                _passthrough(w, used, "engine returned no frames")
                continue
            _finish_window(w, "done", np.asarray(videos[-1], np.float32),
                           used, rec)
            continue
        # window-level failure: error / deadline_exceeded / engine_closed /
        # still-running past wait_s — retry the whole window, then degrade
        err = f"{status}: {rec.get('error', 'request not terminal')}"
        attempts_left[w.index] -= 1
        if attempts_left[w.index] > 0 and not _stopped():
            counters["retries"] += 1
            if ledger is not None:
                ledger.event("stream_window_retry", index=w.index,
                             phase="window", error=err)
            pending.appendleft(w)
        else:
            _passthrough(w, used, err)
        if _stopped() and not inflight:
            interrupted = bool(pending)
            break

    video01 = None
    seams: List[Dict[str, Any]] = []
    if not interrupted and len(outputs) == len(plan):
        video01 = assemble_video(plan, outputs, total)
        source01 = frames.astype(np.float32) / 255.0
        seams = _seam_metrics(video01, source01, plan)
        np.save(os.path.join(job_dir, "final.npy"), video01)
        try:
            from videop2p_tpu_torch.utils.video_io import save_video_gif

            save_video_gif(video01, os.path.join(job_dir, f"{save_name}.gif"))
        except Exception:  # noqa: BLE001 — the artifact is a nicety, final.npy is the record
            pass

    seam_vals = [s["seam_psnr"] for s in seams]
    src_vals = [s["source_psnr"] for s in seams]
    health = {
        "total_frames": total,
        "window": window,
        "overlap": int(overlap),
        "windows_total": len(plan),
        "windows_done": counters["done"],
        "windows_passthrough": counters["passthrough"],
        "windows_skipped": skipped,
        "windows_failed": counters["failed"],
        "retries": counters["retries"],
        "interrupted": int(interrupted),
        "manifest_corrupt": manifest.corrupt_detected,
        "manifest_recovered": manifest.recovered_entries,
        "store_disk_hits": counters["disk"],
        "store_memory_hits": counters["memory"],
        "fresh_inversions": counters["fresh"],
        "src_err_max": src_err_max,
        "seams": len(seams),
        "seam_min_psnr": min(seam_vals) if seam_vals else float("inf"),
        "seam_mean_psnr": (float(np.mean(seam_vals)) if seam_vals
                           else float("inf")),
        "source_seam_min_psnr": min(src_vals) if src_vals else float("inf"),
    }
    if ledger is not None:
        for s in seams:
            ledger.event("stream_seam", **s)
        ledger.event("stream_health", **health)
    if tracing:
        tracer.emit(
            "stream.job", trace_id=trace_id, span_id=job_span,
            parent_id=None, wall_ns=job_wall,
            duration_s=time.perf_counter() - job_t0,
            status="interrupted" if interrupted else "ok",
            windows=len(plan), skipped=skipped,
            passthrough=counters["passthrough"],
        )
    return StreamJobResult(video=video01, health=health, manifest=manifest,
                           seams=seams, windows=window_records)
