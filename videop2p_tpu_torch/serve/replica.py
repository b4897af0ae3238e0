"""Replica supervision: N edit engines sharing one disk inversion store
(port of ``videop2p_tpu/serve/replica.py``).

The fleet tier runs several :class:`~videop2p_tpu_torch.serve.engine.
EditEngine` replicas behind one :class:`~videop2p_tpu_torch.serve.router.
Router`. Replicas share nothing in memory: what makes them a fleet is the
content-addressed DISK inversion store root (``serve/store.py``
write-through + rehydration), so a clip inverted on replica A persists its
trajectory under the shared root, and the same request landing on replica B
is a disk store hit — B rebuilds the capture through its warm inversion
program (``src_err == 0.0``, no program-cache miss, no frame IO), never a
second inversion from frames.

Two run modes:

  * ``"inproc"`` — N engines and their HTTP servers inside THIS process.
    By default (``share_programs=True``) they share one warm
    :class:`~videop2p_tpu_torch.serve.programs.ProgramSet`: the first
    replica warms it, the rest adopt its warm lists, and every replica's
    worker thread dispatches through the same models on the same device.
    The programs hold no per-request state (the controller and the capture
    are arguments), so two requests served at once give the bits each
    gives alone. Per-replica :class:`~videop2p_tpu_torch.serve.faults.
    FaultPlan` injection makes the router's shedding testable.
  * ``"subprocess"`` — one ``python -m videop2p_tpu_torch.cli.serve`` child
    per replica on its own port, each with its own CUDA context, models and
    programs, all with the same ``--inv_store``; ``serve_argv`` (e.g.
    ``--device``, ``--mixed_precision``) goes to every child. The
    supervisor waits for every ``/healthz`` before it reports the fleet up,
    and stops the children with SIGTERM so they drain.

Every child gets the same argv: on a host with several cards they all
serve on the default device (pinning replica *i* to ``cuda:i`` waits for
ROADMAP Queue 1 item 13's rest).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Replica", "ReplicaSupervisor", "free_port"]


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (a subprocess replica needs its port
    before the child can bind)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class Replica:
    """One running engine replica: its name, URL and (by mode) in-process
    handles or child process."""

    name: str
    url: str
    engine: Any = None          # EditEngine (inproc mode)
    server: Any = None          # EditServer (inproc mode)
    proc: Any = None            # subprocess.Popen (subprocess mode)
    meta: Dict[str, Any] = field(default_factory=dict)


class ReplicaSupervisor:
    """Start and stop N engine replicas over one shared inversion-store root.

    ``faults`` maps a replica INDEX to a :class:`FaultPlan` (or its DSL
    string), so a chaos run can take exactly one replica through an
    unavailable window while the rest stay healthy. ``engine_kwargs`` go to
    every in-process engine (``device`` among them); ``programs`` is an
    already built (possibly warm) set to share instead of a new one.
    """

    def __init__(
        self,
        spec: Any,
        replicas: int = 2,
        *,
        out_dir: str,
        persist_dir: Optional[str] = None,
        mode: str = "inproc",
        host: str = "127.0.0.1",
        share_programs: bool = True,
        programs: Any = None,
        engine_kwargs: Optional[Dict[str, Any]] = None,
        warm_prompts: Any = ("a video", "an edited video"),
        warm_kwargs: Optional[Dict[str, Any]] = None,
        faults: Optional[Dict[int, Any]] = None,
        serve_argv: Optional[List[str]] = None,
        startup_timeout_s: float = 600.0,
    ):
        if mode not in ("inproc", "subprocess"):
            raise ValueError(f"mode must be 'inproc' or 'subprocess', got {mode!r}")
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.spec = spec
        self.n = int(replicas)
        self.mode = mode
        self.host = host
        self.out_dir = out_dir
        # the shared content-addressed disk root IS the fleet's state
        self.persist_dir = persist_dir or os.path.join(out_dir, "inv_store")
        self.share_programs = bool(share_programs)
        self.programs = programs
        self.engine_kwargs = dict(engine_kwargs or {})
        self.warm_prompts = tuple(warm_prompts)
        # EditEngine.warm's keywords (controller_kwargs, step_buckets, ...)
        self.warm_kwargs = dict(warm_kwargs or {})
        self.faults = dict(faults or {})
        self.serve_argv = list(serve_argv or [])
        self.startup_timeout_s = float(startup_timeout_s)
        self.replicas: List[Replica] = []

    # ---- lifecycle -------------------------------------------------------

    def start(self) -> List[Replica]:
        if self.replicas:
            return self.replicas
        os.makedirs(self.persist_dir, exist_ok=True)
        if self.mode == "inproc":
            self._start_inproc()
        else:
            self._start_subprocess()
        return self.replicas

    def stop(self) -> None:
        for r in self.replicas:
            if r.server is not None:
                try:
                    r.server.close()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    pass
            if r.engine is not None:
                try:
                    r.engine.close()
                except Exception:  # noqa: BLE001
                    pass
            if r.proc is not None:
                try:
                    r.proc.terminate()  # SIGTERM → the CLI's graceful drain
                except Exception:  # noqa: BLE001
                    pass
        for r in self.replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=30.0)
                except Exception:  # noqa: BLE001
                    r.proc.kill()
                    r.proc.wait()
        self.replicas = []

    def __enter__(self) -> "ReplicaSupervisor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def urls(self) -> List[str]:
        return [r.url for r in self.replicas]

    # ---- inproc mode -----------------------------------------------------

    def _start_inproc(self) -> None:
        from videop2p_tpu_torch.serve.engine import EditEngine
        from videop2p_tpu_torch.serve.faults import FaultPlan
        from videop2p_tpu_torch.serve.http import EditServer
        from videop2p_tpu_torch.serve.programs import ProgramSet

        shared = self.programs
        if shared is None and self.share_programs:
            shared = ProgramSet(self.spec, device=self.engine_kwargs.get("device", "cuda"))
        for i in range(self.n):
            name = f"replica{i}"
            plan = self.faults.get(i)
            if isinstance(plan, str):
                plan = FaultPlan.parse(plan)
            engine = EditEngine(
                self.spec,
                out_dir=os.path.join(self.out_dir, name),
                persist_dir=self.persist_dir,
                programs=shared,
                faults=plan,
                **self.engine_kwargs,
            )
            if i == 0 or not self.share_programs:
                # the first replica warms the (shared) programs; the rest
                # adopt the warm lists
                engine.warm(self.warm_prompts, **self.warm_kwargs)
            else:
                warmed = shared.warmed or {}
                engine.warm_steps.update(warmed.get("steps", []))
                engine.warm_reuse.update(warmed.get("reuse", []))
                engine.warm_student.update(warmed.get("student", []))
            server = EditServer(engine, host=self.host).start()
            self.replicas.append(Replica(
                name=name, url=server.url, engine=engine, server=server,
                meta={"faults": getattr(plan, "spec", None)},
            ))

    # ---- subprocess mode -------------------------------------------------

    def _spec_argv(self) -> List[str]:
        spec = self.spec
        argv = ["--width", str(spec.width), "--video_len", str(spec.video_len),
                "--steps", str(spec.steps), "--seed", str(spec.seed)]
        if spec.checkpoint:
            argv += ["--checkpoint", spec.checkpoint]
        if spec.tiny:
            argv += ["--tiny"]
        return argv

    def _start_subprocess(self) -> None:
        from videop2p_tpu_torch.serve.client import engine_available

        procs = []
        for i in range(self.n):
            name = f"replica{i}"
            port = free_port(self.host)
            out = os.path.join(self.out_dir, name)
            os.makedirs(out, exist_ok=True)
            argv = [sys.executable, "-m", "videop2p_tpu_torch.cli.serve",
                    "--host", self.host, "--port", str(port),
                    "--out_dir", out, "--inv_store", self.persist_dir]
            argv += self._spec_argv() + self.serve_argv
            plan = self.faults.get(i)
            if plan is not None:
                argv += ["--faults", plan if isinstance(plan, str) else plan.spec]
            with open(os.path.join(out, "serve.log"), "ab") as log:
                proc = subprocess.Popen(argv, stdout=log, stderr=log)
            procs.append(Replica(name=name, url=f"http://{self.host}:{port}", proc=proc))
        deadline = time.perf_counter() + self.startup_timeout_s
        for r in procs:
            while not engine_available(r.url, timeout_s=2.0):
                if r.proc.poll() is not None:
                    self.replicas = procs
                    self.stop()
                    raise RuntimeError(
                        f"{r.name} exited with rc={r.proc.returncode} before answering "
                        f"/healthz (see {self.out_dir}/{r.name}/serve.log)")
                if time.perf_counter() > deadline:
                    self.replicas = procs
                    self.stop()
                    raise TimeoutError(
                        f"{r.name} did not answer /healthz within "
                        f"{self.startup_timeout_s:.0f}s")
                time.sleep(0.5)
        self.replicas = procs
