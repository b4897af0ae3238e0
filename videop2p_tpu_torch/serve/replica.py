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
    and stops each child with SIGTERM to the process that serves (the pid
    of its ``listening`` line) so it drains. A ``serve_argv`` whose
    ``--mesh`` shards the model (sp or tp > 1) starts each child under
    ``python -m torch.distributed.run --standalone --nproc_per_node
    sp·tp``: never as one process, which would serve a single rank. There
    the SIGTERM goes to rank 0, not to the launcher (which would stop
    every rank and cut the drain short); rank 0 drains, then releases the
    other ranks, and the launcher exits with them.

Every child gets the same argv, as the JAX package's: on a host with
several cards they all serve on the same devices.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Replica", "ReplicaSupervisor", "free_port", "listening_pid"]

# how long stop() waits for a child to drain and exit after its SIGTERM
_STOP_WAIT_S = 60.0


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (a subprocess replica needs its port
    before the child can bind)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def listening_pid(log_path: str) -> int:
    """The pid of the process that serves, from the last ``listening``
    line ``cli/serve.py`` wrote to ``log_path`` (under ``torchrun``, rank
    0's)."""
    with open(log_path, errors="replace") as fh:
        pids = [int(line.split("(pid ")[1].split(",")[0]) for line in fh
                if "listening on" in line and "(pid " in line]
    if not pids:
        raise RuntimeError(f"no listening line in {log_path}")
    return pids[-1]


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
            if r.proc is not None and r.proc.poll() is None:
                try:
                    # SIGTERM → the CLI's graceful drain, in the process
                    # that serves (rank 0 under torchrun)
                    os.kill(r.meta.get("pid", r.proc.pid), signal.SIGTERM)
                except Exception:  # noqa: BLE001
                    pass
        for r in self.replicas:
            if r.proc is not None:
                try:
                    r.proc.wait(timeout=_STOP_WAIT_S)
                except subprocess.TimeoutExpired:
                    r.proc.terminate()  # a launcher stops every rank
                    try:
                        r.proc.wait(timeout=_STOP_WAIT_S)
                    except subprocess.TimeoutExpired:
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

    def launcher(self) -> List[str]:
        """A child's command up to its module: ``torch.distributed.run``
        with one process per GPU for a model-parallel ``--mesh``."""
        mesh = None
        for i, a in enumerate(self.serve_argv):
            if a == "--mesh" and i + 1 < len(self.serve_argv):
                mesh = self.serve_argv[i + 1]
            elif a.startswith("--mesh="):
                mesh = a.split("=", 1)[1]
        launcher = [sys.executable]
        if mesh:
            from videop2p_tpu_torch.cli.common import parse_mesh

            _, sp, tp = parse_mesh(mesh)
            if sp * tp > 1:
                launcher += ["-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node", str(sp * tp)]
        return launcher

    def _start_subprocess(self) -> None:
        from videop2p_tpu_torch.serve.client import engine_available

        procs = []
        for i in range(self.n):
            name = f"replica{i}"
            port = free_port(self.host)
            out = os.path.join(self.out_dir, name)
            os.makedirs(out, exist_ok=True)
            argv = [*self.launcher(), "-m", "videop2p_tpu_torch.cli.serve",
                    "--host", self.host, "--port", str(port),
                    "--out_dir", out, "--inv_store", self.persist_dir]
            argv += self._spec_argv() + self.serve_argv
            plan = self.faults.get(i)
            if plan is not None:
                argv += ["--faults", plan if isinstance(plan, str) else plan.spec]
            log_path = os.path.join(out, "serve.log")
            with open(log_path, "ab") as log:
                proc = subprocess.Popen(argv, stdout=log, stderr=log)
            procs.append(Replica(name=name, url=f"http://{self.host}:{port}", proc=proc,
                                 meta={"log": log_path}))
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
            # printed before the server answers /healthz
            r.meta["pid"] = listening_pid(r.meta["log"])
        self.replicas = procs
