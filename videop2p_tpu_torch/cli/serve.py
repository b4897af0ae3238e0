"""Edit-serving entry point: a persistent engine behind a JSON HTTP API (port
of ``videop2p_tpu/cli/serve.py``, with the same flags plus ``--device``).

Holds one warm :class:`~videop2p_tpu_torch.serve.programs.ProgramSet` (the
models and the edit programs of one checkpoint / geometry / steps spec), a
device-resident inversion store and a micro-batcher, so repeat and
concurrent edits pay neither a process start nor a second inversion of a
clip. On the card the served edit runs the fused frame-attention and
GroupNorm kernels of ``ops/csrc``.

Run:  python -m videop2p_tpu_torch.cli.serve [--checkpoint DIR] --port 8000
      python -m videop2p_tpu_torch.cli.serve --device cpu --tiny --steps 2 \\
          --video_len 2 --port 0          # a CPU smoke server

Then ``POST /v1/edits`` a JSON request (``serve/engine.py:EditRequest``),
``GET /v1/edits/<id>/result?wait_s=60`` for its record, ``GET /healthz`` and
``GET /metrics[?format=prometheus]``. SIGTERM drains (``--drain_s``) and exits
0. ``--slo`` writes the SLO reports into the ledger at shutdown;
``--incidents DIR`` arms the incident plane (breaker-open, deadline, crash
and ``kill -USR1 <pid>`` bundles under DIR).

Several GPUs (``--mesh dp,sp,tp``, with ``--ring_variant`` and
``--tp_collectives`` as the run CLIs take them):

  * a model-parallel mesh (sp or tp > 1) runs one process per GPU:
    ``torchrun --standalone --nproc_per_node sp·tp -m
    videop2p_tpu_torch.cli.serve --mesh 1,sp,tp ...``. Every rank builds
    its shard of the set; rank 0 binds the port, runs the engine and writes
    the GIFs, the other ranks follow its calls. SIGTERM to rank 0 (its pid
    is in the ``listening`` line) drains it and then releases the others,
    which ignore SIGTERM and exit when released. A mesh that is not the
    world raises, naming torchrun. Any ``--mesh`` given under torchrun serves this way, 1,1,1
    included (one rank driving itself through the channel).
  * a data mesh (dp > 1, sp = tp = 1) is this one process over the first dp
    GPUs; ``--batch_dispatch vmap`` splits each batch over them.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="tuned pipeline dir (random-init smoke when absent)")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--video_len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--guidance_scale", type=float, default=7.5)
    ap.add_argument("--tiny", action="store_true",
                    help="random-init tiny models (weightless smoke mode)")
    ap.add_argument("--mixed_precision", type=str, default="fp32",
                    choices=["fp32", "no", "fp16", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the engine serves on (cuda, or cpu for a smoke run)")
    ap.add_argument("--mesh", type=str, default=None,
                    help="dp,sp,tp — sp/tp shard the model (one torchrun process per "
                         "GPU); dp>1 is the serving data axis batched dispatches shard "
                         "over (one process over the first dp GPUs)")
    ap.add_argument("--ring_variant", type=str, default="overlap",
                    choices=["overlap", "bidir", "serial"],
                    help="ring-attention rotation schedule on sp>1 meshes "
                         "(parallel/ring.py); enters the spec fingerprint")
    ap.add_argument("--tp_collectives", type=str, default="gspmd",
                    choices=["gspmd", "psum_scatter"],
                    help="row-parallel output reduction on tp>1 meshes: all-reduce, or "
                         "reduce-scatter + all-gather; enters the spec fingerprint")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--out_dir", type=str, default="serve_out",
                    help="per-request artifact dir (GIFs, the serve ledger)")
    ap.add_argument("--store_budget_gb", type=float, default=4.0,
                    help="device-resident inversion-store byte budget (LRU)")
    ap.add_argument("--inv_store", type=str, default=None,
                    help="disk write-through root for inversion trajectories "
                         "(shared with the CLIs' --inv_store)")
    ap.add_argument("--max_batch", type=int, default=4,
                    help="micro-batch cap per dispatch")
    ap.add_argument("--max_wait_ms", type=float, default=50.0,
                    help="admit-window deadline before dispatching a partial batch")
    ap.add_argument("--batch_dispatch", type=str, default="scan", choices=["scan", "vmap"],
                    help="scan: one dispatch, per-request results bit-identical to "
                         "singletons; vmap: split over the data mesh's replicas, each "
                         "result its singleton's bits on its device")
    # scheduling policy + per-tenant QoS (serve/sched.py)
    ap.add_argument("--scheduler", type=str, default="drain",
                    choices=["drain", "continuous", "fair"],
                    help="batching policy: drain = plan-boundary windows; continuous = "
                         "iteration-level admission (new compatible requests join the "
                         "NEXT dispatch, deadline-aware ordering); fair = per-tenant "
                         "priority lanes + deficit-round-robin QoS")
    ap.add_argument("--tenants", type=str, default=None,
                    help="per-tenant QoS config: 'name:weight[:priority]' pairs (e.g. "
                         "'A:5,B:1') or a JSON object with weight/priority/deadline_s per "
                         "tenant; requests pick their lane with the 'tenant' field")
    ap.add_argument("--max_batch_wait_ms", type=float, default=None,
                    help="cap any request's total batch-formation wait (drain: bounds "
                         "the admit window by the first request's time in the queue; "
                         "continuous: the partial-batch fill hold). Default: unbounded")
    ap.add_argument("--batch_order", type=str, default="first_seen",
                    choices=["first_seen", "oldest"],
                    help="drain-policy dispatch order of planned chunks: first_seen, or "
                         "oldest (by each chunk's oldest member)")
    ap.add_argument("--ledger", type=str, default=None,
                    help="serve ledger path (default <out_dir>/serve_ledger.jsonl); "
                         "/metrics reads its reservoirs")
    ap.add_argument("--no_warm", action="store_true",
                    help="skip the startup warm-up (the kernels then build on the "
                         "first request)")
    ap.add_argument("--warm_prompts", type=str, nargs=2,
                    default=["a video", "an edited video"],
                    help="source/edit prompt pair the warm-up runs")
    ap.add_argument("--step_buckets", type=int, nargs="*", default=[],
                    help="additional few-step edit variants to warm (e.g. 20 8): exact "
                         "timestep subsets of --steps served from the SAME inversion "
                         "products; per-request 'steps' outside the warmed buckets is a "
                         "400")
    # per-UNet-call cost levers (models/quant.py, pipelines/reuse.py)
    ap.add_argument("--quant_mode", type=str, default="off", choices=["off", "w8", "w8a8"],
                    help="UNet weight quantization at set build: w8 = int8 weights with "
                         "per-output-channel scales, dequantized at use; w8a8 adds "
                         "activation fake-quant at the attention and feed-forward "
                         "inputs. Fixed per set — requests asserting another mode get a "
                         "400; enters the spec fingerprint")
    ap.add_argument("--reuse_schedule", type=str, default="off",
                    help="default cross-step deep-feature reuse schedule ('uniform:K' or "
                         "'custom:<p0,p1,...>'); enters the spec fingerprint")
    ap.add_argument("--reuse_buckets", type=str, nargs="*", default=[],
                    help="additional reuse schedules to warm; per-request "
                         "'reuse_schedule' outside the warmed set is a 400")
    # consistency-distilled few-step student (train/distill.py)
    ap.add_argument("--student_ckpt", type=str, default=None,
                    help="consistency-distilled student checkpoint (train/distill.py "
                         "save_student): serves requests with 'student': true over the "
                         "SAME teacher inversion products; enters the spec fingerprint")
    ap.add_argument("--student_buckets", type=int, nargs="*", default=[],
                    help="student step buckets to warm (e.g. 1 2 4); a student request "
                         "outside them — or without --student_ckpt — is a 400")
    # resilience knobs (serve/faults.py)
    ap.add_argument("--max_queue", type=int, default=64,
                    help="bounded admit queue: over this many in-flight requests, "
                         "submits shed with HTTP 429")
    ap.add_argument("--deadline_s", type=float, default=None,
                    help="default per-request deadline (seconds from submit); expired "
                         "requests fail with terminal status deadline_exceeded")
    ap.add_argument("--dispatch_timeout_s", type=float, default=None,
                    help="watchdog budget around each device dispatch: past it the batch "
                         "fails deadline_exceeded instead of wedging the engine (the "
                         "abandoned work still runs on the card)")
    ap.add_argument("--max_retries", type=int, default=2,
                    help="transient dispatch failures retry this many times (capped "
                         "jitter-free exponential backoff)")
    ap.add_argument("--breaker_threshold", type=int, default=3,
                    help="consecutive dispatch failures that trip the circuit breaker "
                         "open (submits then fast-fail 503 with Retry-After)")
    ap.add_argument("--breaker_open_s", type=float, default=5.0,
                    help="open-window seconds before the breaker half-opens for its "
                         "recovery probe")
    ap.add_argument("--drain_s", type=float, default=5.0,
                    help="graceful-shutdown window: SIGTERM/SIGINT stops admitting and "
                         "gives queued work this long before failing leftovers with "
                         "engine_closed")
    ap.add_argument("--faults", type=str, default=None,
                    help="deterministic fault-injection plan (serve/faults.py DSL, e.g. "
                         "'fail@2,hang@4:1.5,unavail@5-7,corrupt:*'); also via "
                         "VIDEOP2P_SERVE_FAULTS — chaos testing only")
    # request tracing (obs/spans.py), the SLO report and the incident plane
    ap.add_argument("--tracing", action="store_true",
                    help="request-scoped tracing: every request's admit → queue → "
                         "resolve → dispatch → decode lifecycle lands as span ledger "
                         "events; an inbound traceparent header continues the caller's "
                         "trace")
    ap.add_argument("--slo", action="store_true",
                    help="evaluate the default SLO objectives (obs/slo.py: availability, "
                         "deadline-miss rate, served p99) over the run at shutdown into "
                         "slo_report ledger events — obs_diff SLO_RULES gate budget burn")
    ap.add_argument("--incidents", type=str, default=None, metavar="DIR",
                    help="arm the incident plane (obs/incident.py): the flight recorder "
                         "tees ledger events into a bounded ring, and breaker-open / "
                         "dispatch-deadline / crash / SIGUSR1 triggers write debounced "
                         "atomic capture bundles under DIR — render with python -m "
                         "videop2p_tpu_torch.tools.incident_report")
    return ap


def ranked_programs(spec, device: str):
    """The set of a ``--mesh`` launched under ``torchrun`` (every rank
    calls it): the process group joined, the mesh checked against the
    world (it raises naming torchrun), the control channel's group made,
    and this rank's set. Returns ``(rank, set)``; None for a plain process
    or a data mesh (one process)."""
    from videop2p_tpu_torch.cli.common import parse_mesh, validate_mesh
    from videop2p_tpu_torch.parallel.distributed import control_group, initialize_distributed
    from videop2p_tpu_torch.serve import ProgramSet

    if spec.mesh is None:
        return None
    dp, sp, tp = parse_mesh(spec.mesh)
    if dp > 1 and sp == tp == 1:
        return None
    if "WORLD_SIZE" not in os.environ and sp * tp == 1:
        return None
    rank = initialize_distributed(device)
    validate_mesh(spec.mesh, spec.resolved().video_len)
    control_group()
    return rank, ProgramSet(spec, device=device)


def follow(programs) -> int:
    """A follower rank: run rank 0's calls until its engine closes. SIGTERM
    is ignored (rank 0 drains, then releases this rank)."""
    try:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    except ValueError:  # not the main thread (embedded use)
        pass
    stats = programs.follow()
    print(f"[serve] rank released after {stats['calls']} calls; kept runners "
          f"{stats.get('runners')}", flush=True)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from videop2p_tpu_torch.serve import EditEngine, FaultPlan, ProgramSpec
    from videop2p_tpu_torch.serve.http import EditServer

    spec = ProgramSpec(
        checkpoint=args.checkpoint, width=args.width, video_len=args.video_len,
        steps=args.steps, guidance_scale=args.guidance_scale, tiny=args.tiny,
        mixed_precision=args.mixed_precision, seed=args.seed, mesh=args.mesh,
        ring_variant=args.ring_variant, tp_collectives=args.tp_collectives,
        quant_mode=args.quant_mode, reuse_schedule=args.reuse_schedule,
        student_ckpt=args.student_ckpt)
    ranked = ranked_programs(spec, args.device)
    programs = None
    if ranked is not None:
        from videop2p_tpu_torch.parallel.distributed import process_count

        rank, programs = ranked
        if rank != 0:
            return follow(programs)
        print(f"[serve] rank 0 of {process_count()} drives the mesh {spec.mesh} "
              "through the control channel", flush=True)
    faults = FaultPlan.parse(args.faults) if args.faults else None
    if faults is not None:
        print(f"[serve] CHAOS MODE: injecting fault plan {args.faults!r}", flush=True)
    engine = EditEngine(
        spec, out_dir=args.out_dir,
        store_budget_bytes=int(args.store_budget_gb * (1 << 30)),
        persist_dir=args.inv_store, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1000.0, batch_dispatch=args.batch_dispatch,
        scheduler=args.scheduler, tenants=args.tenants,
        max_batch_wait_s=(args.max_batch_wait_ms / 1000.0
                          if args.max_batch_wait_ms is not None else None),
        batch_order=args.batch_order, ledger_path=args.ledger, max_queue=args.max_queue,
        default_deadline_s=args.deadline_s, dispatch_timeout_s=args.dispatch_timeout_s,
        max_retries=args.max_retries, breaker_threshold=args.breaker_threshold,
        breaker_open_s=args.breaker_open_s, faults=faults, tracing=args.tracing,
        slo=args.slo, incidents=args.incidents, device=args.device, programs=programs)
    if not args.no_warm:
        print(f"[serve] warming programs (spec {engine.spec.fingerprint()})...", flush=True)
        info = engine.warm(tuple(args.warm_prompts), step_buckets=tuple(args.step_buckets),
                           reuse_schedules=tuple(args.reuse_buckets),
                           student_steps=tuple(args.student_buckets))
        print(f"[serve] warm in {info['seconds']}s (step buckets {info['steps']}, reuse {info['reuse']}, quant "
              f"{info['quant']}, student {info['student']})", flush=True)
    server = EditServer(engine, host=args.host, port=args.port)
    print(f"[serve] listening on {server.url}  (pid {os.getpid()}, ledger: "
          f"{engine.ledger.path})", flush=True)

    # drain, then exit, on SIGTERM: stop the HTTP loop from a helper thread
    # (shutdown() from the handler itself would deadlock: it runs on the
    # thread serve_forever blocks), then the finally below drains the engine
    def _sigterm(signum, frame):
        print("[serve] SIGTERM — draining", flush=True)
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down", flush=True)
    finally:
        server.httpd.server_close()
        engine.close(drain_s=args.drain_s)  # on a mesh the other ranks exit
    return 0


if __name__ == "__main__":
    from videop2p_tpu_torch.parallel.distributed import leave_process_group

    rc = main()
    leave_process_group(rc)  # a rank of a torchrun world leaves in step
    raise SystemExit(rc)
