"""Process-group bootstrap, the (dp, sp, tp) mesh and per-process phase
timing (port of ``videop2p_tpu/parallel/distributed.py``).

JAX joins its hosts with ``jax.distributed.initialize()`` (one process per
host, every chip of the host in it). PyTorch runs one process per GPU,
launched by ``torchrun``, which sets ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` — the counterparts of
``JAX_PROCESS_ID`` / ``JAX_NUM_PROCESSES`` / ``JAX_COORDINATOR_ADDRESS``.
:func:`initialize_distributed` reads them: NCCL on the GPUs (each process
on ``cuda:LOCAL_RANK``), gloo for ``--device cpu``; a single plain process
(nothing set) joins nothing.

``host_phase`` events: with one process per GPU, ``world_size > 1`` plays
the part of JAX's ``process_count() > 1``, so a multi-GPU run records them
where JAX's single process on a multi-chip host records none.

The host control channel (:class:`ControlChannel`): JAX serves a mesh from
one controller, so its engine's calls reach every chip by themselves. Here
each GPU has its own process, so rank 0 drives the others: it broadcasts
one call's descriptor (a picklable object of CPU values) over a gloo group
beside NCCL (:func:`control_group`) and every rank runs the call on its own
inputs, in the same order. A call runs in two steps, each closed by an
exchange of every rank's outcome: ``prepare`` (host work only: a failure
there reaches rank 0 at once and no rank enters a collective) and the
device work it returns (a failure there reaches rank 0 once the collectives
of the other ranks fail, within :data:`TIMEOUT`). No rank waits longer
than that for another.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import threading
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from videop2p_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh

__all__ = [
    "initialize_distributed",
    "make_hybrid_mesh",
    "process_index",
    "process_count",
    "host_phase_record",
    "emit_host_phase",
    "gather_host_phases",
    "phase_skew",
    "control_group",
    "leave_process_group",
    "ControlChannel",
    "RankCallError",
    "STOP",
]

# the timeout of every collective of a run: a rank that died or took
# another branch fails the others in bounded time instead of hanging them
TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(device: str = "cuda") -> int:
    """Join the process group of a ``torchrun`` launch; returns this
    process's rank. NCCL for ``device`` "cuda" (``torch.cuda.set_device
    (LOCAL_RANK)`` first, so each process owns its GPU), gloo for "cpu".
    A single plain process (no ``WORLD_SIZE`` in the environment) joins
    nothing and is rank 0; a group already initialized is kept."""
    if dist.is_initialized():
        return dist.get_rank()
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        return 0
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device is "
                               "available; pass --device cpu to run on gloo")
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {"device_id": torch.device("cuda", local_rank)} if backend == "nccl" else {}
    try:
        dist.init_process_group(backend, rank=rank, world_size=int(world),
                                timeout=TIMEOUT, **kwargs)
    except TypeError:  # a torch without device_id
        dist.init_process_group(backend, rank=rank, world_size=int(world), timeout=TIMEOUT)
    return dist.get_rank()


def make_hybrid_mesh(dp: int, sp: int, tp: int, *, device=None) -> Mesh:
    """The (dp, sp, tp) mesh. JAX's places ``data`` across slices so that
    only gradient reductions cross the slow network; one node has one
    slice, where it is exactly :func:`make_mesh`."""
    return make_mesh((dp, sp, tp), AXES, device=device)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# ------------------------------------------------- per-process timing --


def host_phase_record(name: str, seconds: float) -> Dict[str, Any]:
    """One process's wall-clock for a named phase, tagged with its identity
    (JAX's fields: ``process_index`` is the rank, ``process_count`` the
    world size)."""
    return {
        "name": name,
        "seconds": round(float(seconds), 4),
        "process_index": process_index(),
        "process_count": process_count(),
        "hostname": socket.gethostname(),
    }


def emit_host_phase(name: str, seconds: float, ledger=None) -> None:
    """Append a ``host_phase`` event to ``ledger`` (default: the active run
    ledger; a no-op without one) and keep its record on the ledger for
    :func:`gather_host_phases`. The ledger's ``phase`` calls it in a
    multi-process run."""
    if ledger is None:
        from videop2p_tpu_torch.obs.ledger import current_ledger

        ledger = current_ledger()
    if ledger is not None:
        rec = host_phase_record(name, seconds)
        kept = getattr(ledger, "host_phases", None)
        if kept is not None:
            kept.append(rec)
        ledger.event("host_phase", **rec)


def gather_host_phases(ledger) -> None:
    """Collective over the world: every rank's ``host_phase`` records (kept
    by its ledger) reach rank 0, which appends the other ranks' to its own
    ledger, so one file holds every process's phases. Every rank calls it
    at the end of a run; a rank without a ledger sends nothing."""
    if process_count() == 1:
        return
    mine = list(getattr(ledger, "host_phases", ()) or ())
    everyone = [None] * process_count()
    dist.all_gather_object(everyone, mine)
    if process_index() == 0 and ledger is not None:
        for rank, recs in enumerate(everyone):
            if rank == 0 or not recs:
                continue
            for rec in recs:
                ledger.event("host_phase", **rec)


def phase_skew(events: Iterable[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Per-phase straggler summary over ``host_phase`` events: the fastest
    and slowest process's seconds, the skew (max − min) and the slowest
    process index (a process that measured a phase more than once counts
    its summed seconds)."""
    per_phase: Dict[str, Dict[int, float]] = {}
    for e in events:
        if not isinstance(e, dict) or e.get("event", "host_phase") != "host_phase":
            continue
        name = e.get("name")
        if name is None:
            continue
        try:
            seconds = float(e.get("seconds", 0.0))
            proc = int(e.get("process_index", 0))
        except (TypeError, ValueError):
            continue
        hosts = per_phase.setdefault(str(name), {})
        hosts[proc] = hosts.get(proc, 0.0) + seconds
    out: Dict[str, Dict[str, Any]] = {}
    for name, hosts in per_phase.items():
        slowest = max(hosts, key=hosts.get)
        out[name] = {
            "hosts": len(hosts),
            "min_s": round(min(hosts.values()), 4),
            "max_s": round(max(hosts.values()), 4),
            "skew_s": round(max(hosts.values()) - min(hosts.values()), 4),
            "slowest_process": slowest,
        }
    return out


# ------------------------------------------------ host control channel --

_CONTROL: List[Any] = []
_CONTROL_LOCK = threading.Lock()

# the first item of the descriptor that ends a follower's loop (a call's
# descriptor is a tuple whose first item names its program)
STOP = "__stop__"


def control_group():
    """The gloo group of the host control channel over the whole world
    (collective: every rank creates it, in the same order as its other
    groups; ``parallel/mesh.py:warm_collectives`` does so at set-up). None
    without a process group."""
    if not dist.is_initialized():
        return None
    with _CONTROL_LOCK:
        if not _CONTROL:
            _CONTROL.append(dist.new_group(backend="gloo", timeout=TIMEOUT))
        return _CONTROL[0]


def leave_process_group(rc: int, then: Optional[Callable[[], None]] = None) -> None:
    """End this process with exit code ``rc`` in step with the other ranks
    of its process group; without one, run ``then`` and return.

    After a barrier on :func:`control_group` (every rank is done with its
    collectives) the streams are flushed and the process leaves through
    ``os._exit``, without the interpreter's finalization. A gloo worker
    thread may still be dropping its last work's tensors when the main
    thread is done: a tensor whose Python object the C++ side keeps alive
    takes the GIL to free it, and a thread that takes the GIL while the
    interpreter finalizes is ended by ``pthread_exit``, whose unwinding
    through the worker's C++ frames calls ``std::terminate`` (SIGABRT,
    "terminate called without an active exception"). A served mesh's
    ranks aborted that way now and then under load. Call it last, when
    everything the process writes is closed. ``then``: this rank's own
    work after the barrier, which enters no collective (Stage 1's
    distillation on rank 0): the other ranks leave without waiting for it,
    and a failure in it makes the exit code 1."""
    if not dist.is_initialized():
        if then is not None:
            then()
        return
    dist.barrier(group=control_group())
    if then is not None:
        try:
            then()
        except Exception:  # noqa: BLE001 — reported, then the rank leaves with 1
            traceback.print_exc()
            rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


class RankCallError(RuntimeError):
    """A rank-synchronous call failed on one or more ranks (named in the
    message). ``step`` is ``"prepare"`` (no rank entered a collective: the
    ranks are still in step) or ``"run"``."""

    def __init__(self, message: str, *, step: str, ranks: List[int]):
        super().__init__(message)
        self.step = step
        self.ranks = ranks


def _describe(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


class ControlChannel:
    """Rank-synchronous calls over :func:`control_group`: rank 0
    :meth:`lead`\\ s, every other rank :meth:`follow`\\ s until rank 0 sends
    :data:`STOP`. ``prepare(descriptor)`` runs on every rank (rank 0's
    included) and returns the call's device work as a callable; its value
    on rank 0 is :meth:`lead`'s, or with ``gather`` every rank's value in
    rank order (each must pickle). Without a process group every call runs
    locally."""

    def __init__(self, group=None):
        self.group = group if group is not None else control_group()
        self.rank = process_index()
        self.world = process_count()
        self.calls = 0

    def _exchange(self, outcome: Any) -> List[Any]:
        """Every rank's outcome of one step, in rank order."""
        if self.group is None:
            return [outcome]
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, outcome, group=self.group)
        return out

    def _broadcast(self, desc: Any) -> Any:
        if self.group is None:
            return desc
        box = [desc]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _run(self, desc: Any, prepare: Callable[[Any], Callable[[], Any]],
             gather: bool) -> Any:
        """Both steps of one call on this rank; raises :class:`RankCallError`
        on every rank when any rank failed (a follower's loop reports and
        goes on)."""
        self.calls += 1
        result, local = None, None
        try:
            work = prepare(desc)
        except BaseException as e:  # noqa: BLE001 — reported to every rank
            work, local = None, e
        errs = self._exchange(None if local is None else _describe(local))
        self._raise_any(errs, "prepare", local)
        try:
            result = work()
        except BaseException as e:  # noqa: BLE001
            local = e
        outcomes = self._exchange((None if local is None else _describe(local),
                                   result if gather and local is None else None))
        self._raise_any([err for err, _ in outcomes], "run", local)
        return [value for _, value in outcomes] if gather else result

    def _raise_any(self, errs: List[Optional[str]], step: str,
                   local: Optional[BaseException]) -> None:
        failed = [r for r, e in enumerate(errs) if e is not None]
        if not failed:
            return
        message = f"rank-synchronous call failed in {step} on rank(s) {failed}: " + "; ".join(
            f"rank {r}: {errs[r]}" for r in failed)
        raise RankCallError(message, step=step, ranks=failed) from local

    def lead(self, desc: Any, prepare: Callable[[Any], Callable[[], Any]], *,
             gather: bool = False) -> Any:
        """Rank 0: send ``desc`` and run it here and on every rank."""
        if self.rank != 0:
            raise RuntimeError(f"rank {self.rank} cannot lead: rank 0 drives the mesh")
        gather, desc = self._broadcast((gather, desc))
        return self._run(desc, prepare, gather)

    def stop(self, *extra: Any) -> None:
        """Rank 0: release every follower; ``extra`` reaches their
        ``on_stop``."""
        self._broadcast((False, (STOP, *extra)))

    def follow(self, prepare: Callable[[Any], Callable[[], Any]],
               on_stop: Optional[Callable[[Any], None]] = None) -> int:
        """Ranks > 0: run rank 0's calls until it sends :data:`STOP`;
        returns the number of calls run. A failed call is printed and the
        loop goes on (rank 0 raised it)."""
        while True:
            gather, desc = self._broadcast(None)
            if desc[0] == STOP:
                if on_stop is not None:
                    on_stop(desc)
                return self.calls
            try:
                self._run(desc, prepare, gather)
            except RankCallError as e:
                print(f"[rank {self.rank}] {e}", flush=True)
