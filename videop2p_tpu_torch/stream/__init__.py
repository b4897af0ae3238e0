"""Streaming long-video editing (port of ``videop2p_tpu/stream/``).

Footage longer than the programs' ``video_len`` is edited as a sequence of
overlapping fixed-size temporal windows through the warm serving engine:
resumable through the per-window job manifest, fault-isolated per window,
with seam quality recorded.

  * :mod:`videop2p_tpu_torch.stream.windows` — the deterministic window
    plan, crossfade assembly, content-addressed window keys, the static
    cost model;
  * :mod:`videop2p_tpu_torch.stream.manifest` — atomic per-window
    persistence and corrupt-manifest recovery;
  * :mod:`videop2p_tpu_torch.stream.driver` — the job driver
    (:func:`run_stream_job`): retries, passthrough degradation,
    checkpoint-then-exit, the ``stream_health`` ledger summary.

Entry point: ``python -m videop2p_tpu_torch.cli.stream``.
"""

from videop2p_tpu_torch.stream.driver import (
    STREAM_HEALTH_FIELDS,
    STREAM_SEAM_FIELDS,
    STREAM_WINDOW_FIELDS,
    StreamJobResult,
    run_stream_job,
)
from videop2p_tpu_torch.stream.manifest import JobManifest, WINDOW_STATUSES
from videop2p_tpu_torch.stream.windows import (
    Window,
    assemble_video,
    blend_weights,
    plan_windows,
    seam_spans,
    streaming_plan_record,
    synthetic_clip,
    window_key,
)

__all__ = [
    "run_stream_job",
    "StreamJobResult",
    "STREAM_HEALTH_FIELDS",
    "STREAM_WINDOW_FIELDS",
    "STREAM_SEAM_FIELDS",
    "JobManifest",
    "WINDOW_STATUSES",
    "Window",
    "plan_windows",
    "blend_weights",
    "assemble_video",
    "seam_spans",
    "window_key",
    "synthetic_clip",
    "streaming_plan_record",
]
