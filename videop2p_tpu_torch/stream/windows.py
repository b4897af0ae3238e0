"""Temporal windowing for streaming long-video editing (port of
``videop2p_tpu/stream/windows.py``).

The warm serve programs take exactly ``spec.video_len`` frames. The
streaming tier never grows them: a long clip is chunked into OVERLAPPING
fixed-size temporal windows, every window runs through the warm
:class:`~videop2p_tpu_torch.serve.programs.ProgramSet` as an ordinary engine
request, and the edited windows are re-assembled with a deterministic linear
crossfade over each overlap, so the seams are continuous instead of hard
cuts.

Everything here is pure host math (numpy + stdlib): the window plan, the
crossfade weights, the assembly, the content-addressed per-window key and
the static cost model :func:`streaming_plan_record`. Determinism is the
point: the same plan, weights and assembly order on every run is what makes
a killed job's resume bit-identical to an uninterrupted one
(``stream/manifest.py``, ``stream/driver.py``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "Window",
    "plan_windows",
    "blend_weights",
    "assemble_video",
    "seam_spans",
    "window_key",
    "synthetic_clip",
    "streaming_plan_record",
]


@dataclass(frozen=True)
class Window:
    """One temporal window of the source clip: source frames
    ``[start, stop)`` (``stop - start`` always equals the plan's window
    size — the warm programs take exactly that many frames)."""

    index: int
    start: int
    stop: int

    @property
    def frames(self) -> int:
        return self.stop - self.start


def plan_windows(total_frames: int, window: int, overlap: int) -> List[Window]:
    """The deterministic window plan: fixed-size windows marching by
    ``stride = window - overlap``, with the FINAL window anchored at
    ``total - window`` so every source frame is covered by a full-size
    window (the last pair may therefore overlap by more than ``overlap``).
    A clip no longer than one window is a single window — the streaming
    path degenerates to the one-shot path exactly."""
    total_frames = int(total_frames)
    window = int(window)
    overlap = int(overlap)
    if window < 2:
        raise ValueError(f"window must be >= 2 frames, got {window}")
    if not 0 <= overlap < window:
        raise ValueError(
            f"overlap must be in [0, window), got overlap={overlap} "
            f"window={window}"
        )
    if total_frames < window:
        raise ValueError(
            f"clip shorter than one window ({total_frames} < {window}) — "
            "run the one-shot path instead"
        )
    stride = window - overlap
    starts: List[int] = []
    start = 0
    while True:
        starts.append(start)
        if start + window >= total_frames:
            break
        start = min(start + stride, total_frames - window)
    return [Window(i, s, s + window) for i, s in enumerate(starts)]


def blend_weights(n: int) -> np.ndarray:
    """The crossfade ramp over an ``n``-frame overlap: the incoming
    window's weight at overlap frame ``i`` is ``(i + 1) / (n + 1)`` — it
    never reaches 0 or 1 inside the overlap, so BOTH windows contribute
    at every blended frame (a pure step function would just move the
    seam, not soften it)."""
    n = int(n)
    if n <= 0:
        return np.zeros((0,), np.float32)
    return (np.arange(1, n + 1, dtype=np.float32)) / (n + 1)


def assemble_video(
    plan: Sequence[Window],
    outputs: Dict[int, np.ndarray],
    total_frames: int,
) -> np.ndarray:
    """Re-assemble the full clip from per-window outputs, left to right,
    crossfading each overlap region with :func:`blend_weights`.

    ``outputs[w.index]`` is that window's (window, H, W, C) float array.
    Assembly is strictly sequential in window order — pure, deterministic,
    and independent of the order the windows were computed in (the
    scheduler may have batched them arbitrarily)."""
    if not plan:
        raise ValueError("empty window plan")
    missing = [w.index for w in plan if w.index not in outputs]
    if missing:
        raise ValueError(f"missing window outputs for indices {missing}")
    first = np.asarray(outputs[plan[0].index], np.float32)
    out = np.zeros((int(total_frames),) + first.shape[1:], np.float32)
    covered = 0  # frames [0, covered) already written
    for w in plan:
        win = np.asarray(outputs[w.index], np.float32)
        if win.shape[0] != w.frames:
            raise ValueError(
                f"window {w.index} output has {win.shape[0]} frames, "
                f"plan says {w.frames}"
            )
        # frames this window shares with what's already written
        ov = max(min(covered - w.start, w.frames), 0)
        if ov > 0:
            ramp = blend_weights(ov).reshape((ov,) + (1,) * (win.ndim - 1))
            seg = slice(w.start, w.start + ov)
            out[seg] = (1.0 - ramp) * out[seg] + ramp * win[:ov]
        out[w.start + ov:w.stop] = win[ov:]
        covered = max(covered, w.stop)
    return out


def seam_spans(plan: Sequence[Window]) -> List[Dict[str, int]]:
    """The blended region of each adjacent window pair, as assembled-clip
    frame spans: ``{"left", "right", "start", "stop"}`` where
    ``[start, stop)`` is the overlap region (the seam the quality gate
    scores — ``stream/driver.py`` measures adjacent-frame PSNR over
    ``[start - 1, stop]`` so the transitions entering, crossing and
    leaving the blend are all covered)."""
    spans = []
    for left, right in zip(plan, plan[1:]):
        spans.append({
            "left": left.index,
            "right": right.index,
            "start": right.start,
            "stop": min(left.stop, right.stop),
        })
    return spans


def window_key(
    spec_fingerprint: str,
    frames: np.ndarray,
    prompts: Sequence[str],
    *,
    seed: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Content-addressed identity of one window's edit: the program-set
    fingerprint x the window's OWN frame bytes x the prompt pair x the
    seed x the edit parameters. Two jobs editing the same footage with the
    same spec share keys window for window (so their inversions share the
    disk store), and any content or parameter change misses instead of
    replaying a stale window."""
    from videop2p_tpu_torch.utils.inv_cache import inversion_cache_key

    clip = hashlib.sha256(
        np.ascontiguousarray(np.asarray(frames)).tobytes()
    ).hexdigest()[:16]
    return inversion_cache_key(
        kind="stream_window",
        spec=spec_fingerprint,
        clip=clip,
        prompts=list(prompts),
        seed=int(seed),
        **dict(extra or {}),
    )


def synthetic_clip(
    total_frames: int, size: int = 16, *, seed: int = 0
) -> np.ndarray:
    """A deterministic synthetic long clip for CPU runs and tests:
    a smoothly drifting sinusoidal texture, (F, size, size, 3) uint8.
    Same ``(total_frames, size, seed)`` → identical bytes in every
    process — the SIGKILL-resume acceptance test regenerates the clip in
    the resumed process and must get the same content."""
    rng = np.random.RandomState(int(seed))
    phase = rng.rand(3) * 2 * np.pi
    freq = 0.5 + rng.rand(3)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    frames = np.empty((int(total_frames), size, size, 3), np.float64)
    for t in range(int(total_frames)):
        drift = 0.15 * t
        for c in range(3):
            frames[t, :, :, c] = 0.5 + 0.5 * np.sin(
                freq[c] * (xx + yy) / size * 2 * np.pi + phase[c] + drift
            )
    return (frames * 255).astype(np.uint8)


def streaming_plan_record(
    total_frames: int,
    window: int,
    overlap: int,
    *,
    steps: int,
    latent_size: int,
    latent_channels: int = 4,
    flops_per_window: Optional[float] = None,
) -> Dict[str, Any]:
    """The static cost model of one streaming plan: window count, the
    overlap redundancy (frames processed / frames delivered − 1), total
    flops scaled from one window's (``flops_per_window``, given by the
    caller, e.g. the ``flops`` of a window's ``program_analysis`` events),
    and the content-addressed store footprint (one fp32 trajectory of
    ``steps + 1`` latents per window — the disk entry a killed job
    rehydrates from). Streaming holds device memory flat per window while
    total work grows linearly."""
    plan = plan_windows(total_frames, window, overlap)
    n = len(plan)
    processed = n * int(window)
    store_per = (int(steps) + 1) * int(window) * int(latent_size) ** 2 \
        * int(latent_channels) * 4
    return {
        "total_frames": int(total_frames),
        "window": int(window),
        "overlap": int(overlap),
        "stride": int(window) - int(overlap),
        "windows": n,
        "frames_processed": processed,
        "overlap_overhead": round(processed / int(total_frames) - 1.0, 4),
        "flops_per_window": flops_per_window,
        "flops_total": (flops_per_window * n
                        if flops_per_window else None),
        "store_bytes_per_window": store_per,
        "store_bytes_total": store_per * n,
    }
