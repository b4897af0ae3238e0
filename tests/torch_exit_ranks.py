"""Shared helper (no tests of its own): a program for the ranks of a
``torch.distributed.run`` launch on gloo that ends the way a served
mesh's ranks do — collectives on three groups, rank 0's last
``broadcast_object_list`` as the control channel's stop — and then leaves
by ``parallel/distributed.py:leave_process_group`` (``leave``) or returns
to the interpreter's finalization (``finalize``).

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_exit_ranks.py leave|finalize

With ``finalize`` a gloo worker still freeing the broadcast's tensors
when the interpreter finalizes aborts the rank ("terminate called without
an active exception") now and then; the busier the host, the oftener.
"""

import datetime
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from videop2p_tpu_torch.parallel.distributed import control_group, leave_process_group  # noqa: E402


def main(mode: str) -> int:
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    rank = dist.get_rank()
    frames = dist.new_group(backend="gloo")
    control = control_group()
    for i in range(10):
        box = [("call", i) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=control)
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, (rank, i), group=control)
        dist.all_reduce(torch.full((64,), float(rank)), group=frames)
    print(f"rank {rank} done", flush=True)
    box = [("stop",) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=control)
    if mode == "leave":
        leave_process_group(0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
