"""Streaming long-video editing: footage longer than one window (port of
``videop2p_tpu/cli/stream.py``, with the same flags plus ``--device``).

Chunks a long clip into overlapping ``--video_len``-frame windows, runs
every window through a warm in-process serving engine (windows are
requests: the scheduler may batch compatible ones), crossfades the edited
windows back together, and persists a per-window job manifest under
``--job_dir``, so a killed or preempted job RESUMES from its last completed
window with the same bits.

SIGTERM / SIGINT checkpoint-then-exit: the job stops submitting windows,
harvests what is in flight (so those windows persist), writes the
``stream_health`` summary with ``interrupted=1`` and exits 0; rerun the
same command to continue.

Run:  python -m videop2p_tpu_torch.cli.stream --checkpoint <dir> \
          --image data/long_clip --prompt "a rabbit is jumping" \
          --edit_prompt "a origami rabbit is jumping" --job_dir job1
      python -m videop2p_tpu_torch.cli.stream --device cpu --tiny --synthetic 20 \
          --video_len 4 --steps 2 --overlap 1 --job_dir /tmp/job   # a CPU smoke run

``--incidents DIR`` arms the incident plane: breaker-open, deadline,
poisoned-window and crash bundles under DIR. ``--mesh`` (with
``--ring_variant`` / ``--tp_collectives``) serves the windows as
``cli/serve.py`` does: a model-parallel mesh under ``torchrun``, rank 0
running the job and the engine, the other ranks following its calls; a
data mesh in this one process.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    # clip source
    ap.add_argument("--image", type=str, default=None,
                    help="frame directory of the LONG clip (every frame is "
                         "loaded; windows slice it)")
    ap.add_argument("--synthetic", type=int, default=None, metavar="F",
                    help="generate a deterministic F-frame synthetic clip "
                         "instead of --image (CPU smoke / chaos drills)")
    ap.add_argument("--prompt", type=str, default="a rabbit is jumping")
    ap.add_argument("--edit_prompt", type=str,
                    default="a origami rabbit is jumping")
    ap.add_argument("--job_dir", type=str, required=True,
                    help="the job's persistent state: manifest.json, "
                         "per-window sidecars, the final video, the engine "
                         "artifacts and the run ledger. Rerunning with the "
                         "same dir RESUMES the job")
    ap.add_argument("--no_resume", action="store_true",
                    help="ignore a persisted manifest and recompute every "
                         "window (the disk inversion store still amortizes)")
    # window geometry
    ap.add_argument("--overlap", type=int, default=2,
                    help="frames shared (and crossfaded) between adjacent "
                         "windows; the window size itself is --video_len")
    ap.add_argument("--window_retries", type=int, default=2,
                    help="per-window job-level retries before the window is "
                         "declared poisoned and degrades to passthrough")
    ap.add_argument("--max_inflight", type=int, default=4,
                    help="windows submitted concurrently (lets the engine "
                         "scheduler batch compatible windows; memory per "
                         "window stays flat — results are harvested and "
                         "released as they land)")
    ap.add_argument("--no_degrade", action="store_true",
                    help="a poisoned window kills the job instead of "
                         "degrading to a recorded passthrough")
    # edit parameters (the per-window request surface)
    ap.add_argument("--is_word_swap", action="store_true")
    ap.add_argument("--blend_word", type=str, nargs=2, default=None)
    ap.add_argument("--cross_replace_steps", type=float, default=0.2)
    ap.add_argument("--self_replace_steps", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    # spec knobs (mirror cli/serve.py)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--video_len", type=int, default=8,
                    help="frames per window — the warm programs' geometry")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--mixed_precision", type=str, default="fp32",
                    choices=["fp32", "no", "fp16", "bf16"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the engine serves on (cuda, or cpu for a smoke run)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="dp,sp,tp device mesh (cli/serve.py's): sp/tp under torchrun")
    ap.add_argument("--ring_variant", type=str, default="overlap",
                    choices=["overlap", "bidir", "serial"],
                    help="ring-attention rotation schedule on sp>1 meshes")
    ap.add_argument("--tp_collectives", type=str, default="gspmd",
                    choices=["gspmd", "psum_scatter"],
                    help="row-parallel output reduction on tp>1 meshes")
    # engine knobs
    ap.add_argument("--store_budget_gb", type=float, default=4.0)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--scheduler", type=str, default="continuous",
                    choices=["drain", "continuous", "fair"],
                    help="batching policy for the window requests "
                         "(continuous keeps devices full as windows land)")
    ap.add_argument("--max_retries", type=int, default=2,
                    help="engine-level transient dispatch retries under "
                         "each window")
    ap.add_argument("--dispatch_timeout_s", type=float, default=None)
    ap.add_argument("--ledger", type=str, default=None,
                    help="run-ledger path (default <job_dir>/stream_ledger"
                         ".jsonl) — stream_window / stream_seam / "
                         "stream_health events land here")
    ap.add_argument("--faults", type=str, default=None,
                    help="deterministic chaos plan (serve/faults.py DSL; "
                         "fail@K / hang@K:S hit window dispatches, "
                         "corrupt:manifest tears manifest writes) — "
                         "chaos testing only")
    ap.add_argument("--tracing", action="store_true",
                    help="request-scoped tracing (obs/spans.py): the job gets a root "
                         "stream.job span with one stream.window child per window "
                         "(resumed windows show as cached spans) plus the engine's "
                         "per-request span tree")
    ap.add_argument("--incidents", type=str, default=None, metavar="DIR",
                    help="arm the incident plane (obs/incident.py): the job ledger tees "
                         "into a flight ring, and breaker-open / deadline / poisoned-window "
                         "/ crash triggers write debounced capture bundles under DIR "
                         "(default off) — render with python -m "
                         "videop2p_tpu_torch.tools.incident_report")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.image is None) == (args.synthetic is None):
        build_parser().error("pass exactly one of --image / --synthetic")
    import os
    import signal
    import threading

    import numpy as np

    from videop2p_tpu_torch.cli.serve import follow, ranked_programs
    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSpec
    from videop2p_tpu_torch.stream import run_stream_job, synthetic_clip

    spec = ProgramSpec(
        checkpoint=args.checkpoint, width=args.width,
        video_len=args.video_len, steps=args.steps,
        guidance_scale=args.guidance_scale, tiny=args.tiny,
        mixed_precision=args.mixed_precision, seed=args.seed, mesh=args.mesh,
        ring_variant=args.ring_variant, tp_collectives=args.tp_collectives,
    )
    resolved = spec.resolved()
    programs = None
    ranked = ranked_programs(spec, args.device)
    if ranked is not None:
        rank, programs = ranked
        if rank != 0:
            return follow(programs)
    if args.synthetic is not None:
        frames = synthetic_clip(args.synthetic, resolved.width, seed=args.seed)
    else:
        from videop2p_tpu_torch.data.dataset import load_frame_sequence

        frames = load_frame_sequence(args.image, size=resolved.width)
    faults = FaultPlan.parse(args.faults) if args.faults else None
    if faults is not None:
        print(f"[stream] CHAOS MODE: injecting fault plan {args.faults!r}", flush=True)
    os.makedirs(args.job_dir, exist_ok=True)
    engine = EditEngine(
        spec,
        out_dir=os.path.join(args.job_dir, "serve_out"),
        store_budget_bytes=int(args.store_budget_gb * (1 << 30)),
        persist_dir=os.path.join(args.job_dir, "inv_store"),
        max_batch=args.max_batch,
        scheduler=args.scheduler,
        max_retries=args.max_retries,
        dispatch_timeout_s=args.dispatch_timeout_s,
        ledger_path=(args.ledger
                     or os.path.join(args.job_dir, "stream_ledger.jsonl")),
        keep_videos=True,
        faults=faults,
        tracing=args.tracing,
        incidents=args.incidents,
        device=args.device,
        programs=programs,
    )
    prompts = [args.prompt, args.edit_prompt]
    request_kwargs = dict(
        is_word_swap=args.is_word_swap,
        blend_word=args.blend_word,
        cross_replace_steps=args.cross_replace_steps,
        self_replace_steps=args.self_replace_steps,
    )
    print(f"[stream] warming programs (spec {engine.spec.fingerprint()})...", flush=True)
    # the capture program is keyed by the controller's structure: warm the
    # windows' own, so no window builds a program
    engine.warm(tuple(prompts), controller_kwargs=request_kwargs)

    # checkpoint-then-exit on SIGTERM/SIGINT (the orchestrator's preemption
    # signal, as run_tuning's): the job checks the event between windows,
    # persists everything already harvested, and returns; rerunning the same
    # command resumes from the manifest
    stop_event = threading.Event()

    def _handler(signum, frame):
        print(f"[stream] signal {signum} — checkpointing then exiting", flush=True)
        stop_event.set()

    installed = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            installed.append((sig, signal.signal(sig, _handler)))
        except ValueError:  # not the main thread (embedded use)
            pass
    try:
        result = run_stream_job(
            engine, frames, prompts,
            job_dir=args.job_dir,
            overlap=args.overlap,
            seed=args.seed,
            request_kwargs=request_kwargs,
            window_retries=args.window_retries,
            max_inflight=args.max_inflight,
            resume=not args.no_resume,
            degrade=not args.no_degrade,
            stop_event=stop_event,
            faults=faults,
        )
    finally:
        for sig, old in installed:
            signal.signal(sig, old)
        engine.close()  # on a mesh the other ranks exit
    print(json.dumps({"stream_health": result.health}, default=str), flush=True)
    if result.complete:
        print(f"[stream] done: {result.health['windows_done']} edited + "
              f"{result.health['windows_passthrough']} passthrough window(s) "
              f"-> {os.path.join(args.job_dir, 'final.npy')}", flush=True)
        assert result.video is not None and np.isfinite(result.video).all()
        return 0
    print("[stream] interrupted — rerun the same command to resume "
          f"({result.health['windows_done'] + result.health['windows_skipped']}"
          f"/{result.health['windows_total']} windows persisted)", flush=True)
    return 0


if __name__ == "__main__":
    from videop2p_tpu_torch.parallel.distributed import leave_process_group

    rc = main()
    leave_process_group(rc)  # a rank of a torchrun world leaves in step
    raise SystemExit(rc)
