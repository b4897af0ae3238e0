"""Shared helper (no tests of its own) of the port's multi-process tests:
run a function on N local ranks of a gloo process group.

Ranks are processes of the ``spawn`` start method, so a child loads only
torch and the module that defines the function: the test modules that use
this helper import JAX inside their test functions only. Every child runs
with one intra-op thread. The group's store is a file under a temporary
directory (no TCP port to collide across test workers), and
``init_process_group`` and every collective time out after
:data:`GROUP_TIMEOUT_S`. :func:`run_ranks` waits for its children until a
deadline and kills any that remain, so a deadlock fails one test instead of
hanging the suite.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

GROUP_TIMEOUT_S = 60


def _child(fn, rank: int, world: int, store: str, args: tuple, results) -> None:
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks; returns
    their results in rank order (each must pickle). Raises with the
    children's tracebacks if any rank fails, or if the ranks have not all
    answered by ``timeout`` seconds (the stragglers are killed)."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="torch_dist_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, os.path.join(tmp, "store"),
                                                   args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got, errors = {}, []
    try:
        while len(got) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, status, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                if not any(p.is_alive() for p in procs) and results.empty():
                    break
                continue
            if status == "ok":
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise AssertionError("ranks failed:\n" + "\n".join(errors))
    if len(got) < world:
        missing = sorted(set(range(world)) - set(got))
        raise AssertionError(f"ranks {missing} did not answer within {timeout} s "
                             "(deadlock or crash); killed")
    return [got[r] for r in range(world)]


def frames_mesh(n: int, tensor: int = 1):
    """Inside a rank: a ``(1, n, tensor)`` mesh over the first ``n·tensor``
    ranks of the world (every rank must call it: the groups are created
    collectively), or None on the ranks outside it."""
    import torch
    import torch.distributed as dist

    from videop2p_tpu_torch.parallel.mesh import AXES, Mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    size = n * tensor
    # every rank takes part in creating every group, in the same order
    frames_groups = {}
    for t in range(tensor):
        ranks = [s * tensor + t for s in range(n)]
        frames_groups[t] = (ranks, dist.new_group(ranks))
    tensor_groups = {}
    for s in range(n):
        ranks = [s * tensor + t for t in range(tensor)]
        tensor_groups[s] = (ranks, dist.new_group(ranks))
    data_groups = {r: ([r], dist.new_group([r])) for r in range(size)}
    if rank >= size or world < size:
        return None
    s, t = rank // tensor, rank % tensor
    return Mesh(shape={"data": 1, "frames": n, "tensor": tensor}, rank=rank,
                coords={"data": 0, "frames": s, "tensor": t},
                groups={"data": data_groups[rank][1], "frames": frames_groups[t][1],
                        "tensor": tensor_groups[s][1]},
                ranks={"data": [rank], "frames": frames_groups[t][0],
                       "tensor": tensor_groups[s][0]},
                device=torch.device("cpu"), axis_names=AXES)
