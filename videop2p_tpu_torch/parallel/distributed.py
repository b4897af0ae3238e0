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
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Dict, Iterable

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
