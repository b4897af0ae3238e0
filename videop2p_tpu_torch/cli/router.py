"""Fleet entry point: a stdlib HTTP router over N edit-engine replicas (port
of ``videop2p_tpu/cli/router.py``, with the same flags plus ``--device``).

Two ways to get a fleet:

  * route over ALREADY-RUNNING engines (their own ``cli/serve.py``
    processes, possibly on other hosts) —

      python -m videop2p_tpu_torch.cli.router \
          --replicas http://host-a:8000,http://host-b:8000 --port 9000

  * spawn local subprocess replicas first (one ``cli/serve.py`` child per
    replica on its own port, all sharing ``--inv_store``), then route —

      python -m videop2p_tpu_torch.cli.router --spawn 2 --inv_store shared/inv \
          --port 9000
      python -m videop2p_tpu_torch.cli.router --spawn 2 --device cpu --tiny \
          --steps 2 --video_len 2 --port 0      # a CPU smoke fleet

The router ranks replicas by their ``/healthz`` status and ``/metrics``
queue and latency gauges, routes around open circuit breakers, retries
refused submits deterministically, and serves the fleet's ``/healthz`` and
``/metrics[?format=prometheus]``. Clients are unchanged: the router speaks
the engine's JSON API. SIGTERM stops the router, then the spawned replicas
(each drains on its own SIGTERM), and exits 0. Every spawned child gets
``--device`` and the ``--serve_arg`` flags (e.g. ``--serve_arg=--mixed_precision
--serve_arg=bf16``); on one host they all serve on that device.
``--incidents DIR`` tees the router's ledger into a flight ring and writes
crash and ``kill -USR1 <pid>`` bundles under DIR, each with every replica's
``/healthz`` + ``/metrics``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--replicas", type=str, default=None,
                    help="comma-separated base URLs of running engines "
                         "(mutually exclusive with --spawn)")
    ap.add_argument("--spawn", type=int, default=None,
                    help="spawn this many local cli/serve.py subprocess "
                         "replicas sharing --inv_store before routing")
    # spec knobs forwarded to spawned replicas
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--video_len", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device spawned replicas serve on (cuda, or cpu for a "
                         "smoke run)")
    ap.add_argument("--out_dir", type=str, default="router_out",
                    help="router ledger + spawned-replica artifact root")
    ap.add_argument("--inv_store", type=str, default=None,
                    help="shared content-addressed disk inversion-store "
                         "root (default <out_dir>/inv_store) — what makes "
                         "replicas a fleet: an inversion on one is a disk "
                         "store-hit on every other")
    ap.add_argument("--serve_arg", action="append", default=[],
                    help="extra flag forwarded verbatim to every spawned "
                         "replica (repeatable), e.g. --serve_arg=--scheduler"
                         " --serve_arg=continuous")
    # router knobs
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--ledger", type=str, default=None,
                    help="router ledger path (default <out_dir>/"
                         "router_ledger.jsonl) — router_health lands here")
    ap.add_argument("--timeout_s", type=float, default=30.0,
                    help="per-replica request timeout")
    ap.add_argument("--max_retries", type=int, default=2,
                    help="full routing passes retried (deterministic "
                         "backoff) before the router answers 503")
    ap.add_argument("--suspend_s", type=float, default=1.0,
                    help="suspect window after a replica refuses a submit")
    ap.add_argument("--probe_ttl_s", type=float, default=0.5,
                    help="health/metrics probe cache TTL")
    ap.add_argument("--tracing", action="store_true",
                    help="request-scoped tracing (obs/spans.py): record a "
                         "router.submit span per routed request and "
                         "forward a child traceparent to the chosen "
                         "replica — run the replicas with --tracing too "
                         "and join the ledgers by trace id")
    ap.add_argument("--incidents", type=str, default=None, metavar="DIR",
                    help="arm the incident plane (obs/incident.py): the router ledger "
                         "tees into a flight ring, replicas become bundle probe targets, "
                         "and crash/SIGUSR1 triggers write debounced capture bundles under "
                         "DIR — render with tools/incident_report.py")
    return ap


def main(argv=None) -> int:
    import os
    import signal
    import sys
    import threading

    args = build_parser().parse_args(argv)
    if bool(args.replicas) == bool(args.spawn):
        build_parser().error("exactly one of --replicas / --spawn required")

    supervisor = None
    if args.spawn:
        from videop2p_tpu_torch.serve.programs import ProgramSpec
        from videop2p_tpu_torch.serve.replica import ReplicaSupervisor

        spec = ProgramSpec(checkpoint=args.checkpoint, width=args.width,
                           video_len=args.video_len, steps=args.steps,
                           tiny=args.tiny, seed=args.seed)
        supervisor = ReplicaSupervisor(
            spec, args.spawn, mode="subprocess", out_dir=args.out_dir,
            persist_dir=args.inv_store, host=args.host,
            serve_argv=["--device", args.device, *args.serve_arg],
        )
        print(f"[router] spawning {args.spawn} replicas "
              f"(shared store: {supervisor.persist_dir})...", flush=True)
        supervisor.start()
        urls = supervisor.urls
    else:
        urls = [u.strip() for u in args.replicas.split(",") if u.strip()]

    from videop2p_tpu_torch.serve.router import Router, RouterServer

    os.makedirs(args.out_dir, exist_ok=True)
    router = Router(
        urls,
        timeout_s=args.timeout_s, max_retries=args.max_retries,
        suspend_s=args.suspend_s, probe_ttl_s=args.probe_ttl_s,
        ledger_path=(args.ledger
                     or os.path.join(args.out_dir, "router_ledger.jsonl")),
        tracing=args.tracing,
        incidents=args.incidents,
    )
    server = RouterServer(router, host=args.host, port=args.port)
    print(f"[router] listening on {server.url} over {len(urls)} replica(s):")
    for u in urls:
        print(f"[router]   {u}")
    sys.stdout.flush()

    def _sigterm(signum, frame):
        print("[router] SIGTERM — shutting down", flush=True)
        threading.Thread(target=server.httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[router] shutting down")
    finally:
        server.httpd.server_close()
        router.close()
        if supervisor is not None:
            supervisor.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
