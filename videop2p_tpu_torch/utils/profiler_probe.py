"""Does torch.profiler keep the kernels of a trace taken minutes after the
process's first one? (One GPU.)

Traces ``x @ x`` (2048², fp32) three times with CUDA activity only and once
with the host's activity too, at 0, 0.5, 3, 4 and 5 minutes after start,
idle in between, and prints how many of the three kernel launches each trace
held. Run it under Kineto's two CUPTI settings, side by side on one card:

    TEARDOWN_CUPTI=0 python3 -m videop2p_tpu_torch.utils.profiler_probe &
    TEARDOWN_CUPTI=1 python3 -m videop2p_tpu_torch.utils.profiler_probe

With ``KINETO_LOG_LEVEL=1`` Kineto's stderr gives each trace's
"Out-of-range" count: the kernel records it dropped as outside the trace's
capture window.
"""

import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

MARKS_MIN = (0, 0.5, 3, 4, 5)


def held(activities, fn, iters: int = 3) -> int:
    """The kernel events a trace of ``iters`` calls of ``fn`` holds."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def main() -> None:
    x = torch.randn(2048, 2048, device="cuda")

    def fn():
        return x @ x

    cuda_only = [ProfilerActivity.CUDA]
    with_host = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    label = f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI', 'unset')}"
    t0 = time.time()
    for mark in MARKS_MIN:
        time.sleep(max(0.0, t0 + 60 * mark - time.time()))
        counts = [held(cuda_only, fn) for _ in range(3)]
        print(f"{label} t={time.time() - t0:7.1f} s: CUDA-only traces held {counts} of 3 "
              f"kernels, with the host's activity {held(with_host, fn)}", flush=True)


if __name__ == "__main__":
    main()
