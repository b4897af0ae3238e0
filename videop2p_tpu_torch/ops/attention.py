"""Frame attention (every frame's queries against frame 0's keys/values): a
hand-written CUDA kernel, its plain PyTorch versions, and the dispatch rule.

Port of ``videop2p_tpu/ops/attention.py``. Shapes: q (B, F, H, N, D); k, v
(B, H, N, D), shared by all F frames; out (B, F, H, N, D) in q's dtype.

  * :func:`dense_frame_attention` — one product, f32 softmax; the small-site
    path (N < 1024 tokens) on every device.
  * :func:`chunked_frame_attention` — the same math over query chunks, so the
    score tensor never exceeds B·F·H·q_chunk·N; the plain version of the
    kernel (a dense score tensor at 64² would need ~13 GB in fp32).
  * :func:`fused_frame_attention` — ``csrc/frame_attention.cu`` on a CUDA
    tensor (frames folded into the query axis, K/V tiles streamed through
    shared memory with an online softmax), the chunked plain version on a
    CPU tensor.
  * :func:`frame_attention` — the dispatch of
    ``make_frame_attention_fn("auto")``: dense below ``MIN_LARGE_TOKENS``,
    else the kernel wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from videop2p_tpu_torch.ops._build import bind

__all__ = [
    "dense_frame_attention",
    "chunked_frame_attention",
    "fused_frame_attention",
    "frame_attention",
    "launch_count",
    "reset_launch_count",
    "MIN_LARGE_TOKENS",
]

MIN_LARGE_TOKENS = 1024
_SOURCE = "frame_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128

_launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    return bind(_SOURCE, "frame_attention_fwd",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def dense_frame_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bfhqd,bhkd->bfhqk", q, k) * scale
    probs = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("bfhqk,bhkd->bfhqd", probs, v)


def chunked_frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, q_chunk: int = 512) -> torch.Tensor:
    """Exact attention over query chunks of the token axis; dense when N does
    not split into whole chunks (the JAX version's rule)."""
    n = q.shape[3]
    if n % q_chunk != 0 or n <= q_chunk:
        return dense_frame_attention(q, k, v)
    return torch.cat(
        [dense_frame_attention(q[:, :, :, i:i + q_chunk], k, v)
         for i in range(0, n, q_chunk)], dim=3)


def _check_shapes(q, k, v):
    if q.dim() != 5:
        raise ValueError(
            "frame attention takes q of shape (B, F, H, N, D); "
            f"got rank-{q.dim()} {tuple(q.shape)}")
    b, _, h, n, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, n, d):
            raise ValueError(
                f"{name} must be {(b, h, n, d)} for q {tuple(q.shape)}, "
                f"got {tuple(t.shape)}")


def fused_frame_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Frame attention through the CUDA kernel for a CUDA tensor, the chunked
    plain version for a CPU tensor. q, k and v may be strided views whose
    last dimension is contiguous; the output has the memory layout
    (B, F, N, H, D) seen as (B, F, H, N, D), so merging heads afterwards is
    a view."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return chunked_frame_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_frame_attention runs on cuda or cpu, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "fused_frame_attention takes float32 or bfloat16 q, k, v of one "
            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("fused_frame_attention needs a contiguous last dimension")
    b, f, h, n, d = q.shape
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the kernel's grid")
    out = torch.empty((b, f, n, h, d), device=q.device, dtype=q.dtype).transpose(2, 3)
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, f, h, n, d,
                ctypes.cast(strides, ctypes.c_void_p), float(d ** -0.5), stream)
    global _launches
    _launches += 1
    return out


def frame_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """The ``"auto"`` dispatch (videop2p_tpu/ops/attention.py:204-262): dense
    below ``MIN_LARGE_TOKENS`` tokens, else :func:`fused_frame_attention`
    (the kernel on a CUDA tensor, the chunked plain version on a CPU one)."""
    _check_shapes(q, k, v)
    if q.shape[3] < MIN_LARGE_TOKENS:
        return dense_frame_attention(q, k, v)
    return fused_frame_attention(q, k, v)
