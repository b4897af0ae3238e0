"""videop2p_tpu_torch — the Video-P2P editing system in PyTorch, with
hand-written CUDA kernels for Hopper (sm_90a).

A port of ``videop2p_tpu`` (JAX) that keeps its public layouts so the two
can be compared tensor for tensor:

  * videos and latents are channels-last, ``(batch, frames, height, width,
    chan)``;
  * frame attention takes q ``(B, F, H, N, D)`` against frame-0 k/v
    ``(B, H, N, D)``;
  * GroupNorm runs on ``(N, rows, C)`` slabs.

Entry points run on CUDA unless the caller passes a CPU device; on a CPU
tensor each kernel wrapper runs its plain PyTorch version. The package
imports neither JAX nor anything of ``videop2p_tpu``.
"""

__version__ = "0.1.0"
