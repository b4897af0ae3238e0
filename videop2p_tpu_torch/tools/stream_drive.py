"""Closed-loop streaming long-video driver (port of ``tools/stream_drive.py``:
the same flags plus ``--device``, the same fault plans and exit codes).

Builds a deterministic synthetic N-window clip, a tiny (or real) warm
in-process engine, and runs one resumable streaming edit job through
``videop2p_tpu_torch.stream.run_stream_job`` — the CI-sized twin of
``python -m videop2p_tpu_torch.cli.stream``. Everything the job observes
lands in ONE run ledger (the engine's): per-window ``stream_window`` events
+ ``stream_window_e2e`` latency reservoirs, per-boundary ``stream_seam``
records, the engine's ``serve_health``, and the job-level
``stream_health`` summary — so two drive ledgers diff and GATE through
``python -m videop2p_tpu_torch.tools.obs_diff`` (``SEAM_RULES`` +
``FAULT_RULES`` + ``TIMING_RULES``) like any other run:

    python -m videop2p_tpu_torch.tools.stream_drive --frames 14 --video_len 4 \\
        --overlap 1 --steps 2 --job_dir /tmp/jobA --ledger drive_a.jsonl
    python -m videop2p_tpu_torch.tools.stream_drive --frames 14 --video_len 4 \\
        --overlap 1 --steps 2 --job_dir /tmp/jobB --ledger drive_b.jsonl
    python -m videop2p_tpu_torch.tools.obs_diff drive_a.jsonl drive_b.jsonl

The engine runs on CUDA unless ``--device cpu`` is passed. ``--tiny`` is
on whether or not it is passed (as in the JAX tool), so the default width
of 512 resolves to the tiny models' 16 (``ProgramSpec.resolved``).

Chaos drills ride the same deterministic plans as the serving tier:
``--faults fail@2`` exercises the engine's transient-retry path under a
window; ``--faults 'unavail@2-99'`` (with ``--max_retries 0``) poisons
windows into recorded passthroughs; ``--faults corrupt:manifest`` tears
every manifest write so the NEXT run must detect and recover. A SIGKILL
at any point leaves a resumable job: rerun with the same ``--job_dir``
and the completed windows are skipped.

Exit status: 0 on a fully-edited clip; 1 when any window failed or
degraded to passthrough (``--allow_passthrough`` tolerates degradations —
chaos drills expect them) or when ``--min_seam_psnr`` is set and the
worst seam falls below it; 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=14,
                    help="synthetic clip length (frames)")
    ap.add_argument("--overlap", type=int, default=1)
    ap.add_argument("--job_dir", type=str, default="stream_drive_job")
    ap.add_argument("--ledger", type=str, default=None,
                    help="run-ledger path (default <job_dir>/stream_ledger"
                         ".jsonl)")
    ap.add_argument("--no_resume", action="store_true")
    ap.add_argument("--window_retries", type=int, default=2)
    ap.add_argument("--max_inflight", type=int, default=4)
    ap.add_argument("--prompt", type=str, default="a rabbit is jumping")
    ap.add_argument("--edit_prompt", type=str,
                    default="a origami rabbit is jumping")
    ap.add_argument("--seed", type=int, default=0)
    # tiny-engine knobs (CI defaults)
    ap.add_argument("--tiny", action="store_true", default=None)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--video_len", type=int, default=4,
                    help="frames per window (the warm programs' geometry)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--scheduler", type=str, default="continuous",
                    choices=["drain", "continuous", "fair"])
    ap.add_argument("--max_retries", type=int, default=2,
                    help="engine-level transient dispatch retries")
    ap.add_argument("--dispatch_timeout_s", type=float, default=None)
    # chaos + gates
    ap.add_argument("--faults", type=str, default=None,
                    help="deterministic chaos plan (serve/faults.py DSL + "
                         "corrupt:manifest)")
    ap.add_argument("--allow_passthrough", action="store_true",
                    help="degraded (passthrough) windows do not fail the "
                         "drive — chaos drills expect them")
    ap.add_argument("--min_seam_psnr", type=float, default=None,
                    help="exit 1 when the worst window-seam adjacent-frame "
                         "PSNR falls below this (dB)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the engine runs on (cuda, or cpu for a "
                         "smoke run)")
    args = ap.parse_args(argv)

    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSpec
    from videop2p_tpu_torch.stream import run_stream_job, synthetic_clip

    tiny = True if args.tiny is None else args.tiny
    spec = ProgramSpec(checkpoint=args.checkpoint, tiny=tiny,
                       width=args.width, video_len=args.video_len,
                       steps=args.steps, seed=args.seed)
    resolved = spec.resolved()
    frames = synthetic_clip(args.frames, resolved.width, seed=args.seed)
    faults = FaultPlan.parse(args.faults) if args.faults else None
    os.makedirs(args.job_dir, exist_ok=True)
    engine = EditEngine(
        spec,
        out_dir=os.path.join(args.job_dir, "serve_out"),
        persist_dir=os.path.join(args.job_dir, "inv_store"),
        max_batch=args.max_batch,
        scheduler=args.scheduler,
        max_retries=args.max_retries,
        dispatch_timeout_s=args.dispatch_timeout_s,
        ledger_path=(args.ledger
                     or os.path.join(args.job_dir, "stream_ledger.jsonl")),
        keep_videos=True,
        faults=faults,
        device=args.device,
    )
    prompts = [args.prompt, args.edit_prompt]
    # a batch runs its members through the singleton's programs: nothing
    # to warm per batch size
    engine.warm(tuple(prompts))
    try:
        result = run_stream_job(
            engine, frames, prompts,
            job_dir=args.job_dir,
            overlap=args.overlap,
            seed=args.seed,
            window_retries=args.window_retries,
            max_inflight=args.max_inflight,
            resume=not args.no_resume,
            faults=faults,
        )
    finally:
        engine.close()
    record = {
        "stream_health": result.health,
        "seams": result.seams,
        "windows": result.windows,
        "ledger": engine.ledger.path,
        "final": (os.path.join(args.job_dir, "final.npy")
                  if result.complete else None),
    }
    print(json.dumps(record, default=str))
    health = result.health
    if not result.complete:
        print("[stream_drive] job incomplete", file=sys.stderr)
        return 1
    degraded = health["windows_failed"] or health["windows_passthrough"]
    if degraded and not args.allow_passthrough:
        print(f"[stream_drive] {health['windows_passthrough']} window(s) "
              "degraded to passthrough "
              f"({health['windows_failed']} poisoned)", file=sys.stderr)
        return 1
    if (args.min_seam_psnr is not None
            and health["seam_min_psnr"] < args.min_seam_psnr):
        print(f"[stream_drive] seam_min_psnr {health['seam_min_psnr']} < "
              f"required {args.min_seam_psnr}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
