"""GroupNorm(+SiLU) over channels-last slabs: a hand-written CUDA kernel and
its plain PyTorch version.

Port of ``videop2p_tpu/ops/groupnorm.py``. ``x`` has shape (N, rows, C):
statistics are per (sample n, group g) over rows × C/G channels, in f32, with
the biased variance E[x²]−E[x]² (the JAX kernel's formula, not torch's
two-pass ``F.group_norm``). ``y = (x−mean)·rsqrt(var+eps)·scale + bias``,
optionally followed by SiLU, in x's dtype.

:func:`fused_group_norm` launches ``csrc/groupnorm.cu`` on a CUDA tensor and
runs :func:`group_norm_reference` on a CPU tensor. On a CUDA tensor its
backward recomputes through :func:`group_norm_reference` (JAX:
``_fused_gn_bwd``, videop2p_tpu/ops/groupnorm.py:194-210). There is no slab-size
gate: the TPU kernel's VMEM limit (rows % 256, ≤ 3 MiB) does not carry over,
and the CUDA kernel takes every UNet GroupNorm site.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from videop2p_tpu_torch.ops._autograd import recompute_grads
from videop2p_tpu_torch.ops._build import bind

__all__ = ["fused_group_norm", "group_norm_reference", "launch_count",
           "reset_launch_count", "stats_chunks"]

_SOURCE = "groupnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# statistics blocks to aim for: several waves over the card's 132 SMs
_TARGET_STAT_BLOCKS = 512
# the apply kernel folds per-channel coefficients into 48 KB of shared memory
_MAX_CHANNELS = 6144
# kernels per call: partial sums, per-group statistics, apply
_KERNELS_PER_CALL = 3

_launches = 0


@functools.lru_cache(maxsize=None)
def _launcher():
    return bind(_SOURCE, "group_norm_fwd", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count` (three per
    call on a CUDA tensor)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def group_norm_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """The plain version: f32 statistics pass, then the apply pass (a port of
    ``group_norm_reference``, videop2p_tpu/ops/groupnorm.py:213-235)."""
    n, rows, c = x.shape
    g = num_groups
    xf = x.float().reshape(n, rows, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(n, rows, c) * scale.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def stats_chunks(n: int, rows: int) -> tuple:
    """(chunks, rows per chunk) that split each sample's rows so the
    statistics pass has about ``_TARGET_STAT_BLOCKS`` blocks."""
    want = max(1, min(rows, -(-_TARGET_STAT_BLOCKS // n)))
    per = -(-rows // want)
    return -(-rows // per), per


def fused_group_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int,
    eps: float = 1e-5,
    act: str = "none",
) -> torch.Tensor:
    """GroupNorm(+SiLU) of a (N, rows, C) slab: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor. Differentiable in x, scale
    and bias: on a CUDA tensor the backward recomputes through the plain
    version, as the JAX package's does."""
    if act not in ("none", "silu"):
        raise ValueError(f"act must be 'none' or 'silu', got {act!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (N, rows, C), got shape {tuple(x.shape)}")
    n, rows, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(
            f"scale/bias must be ({c},), got {tuple(scale.shape)}/{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return group_norm_reference(x, scale, bias, num_groups=num_groups,
                                    eps=eps, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm runs on cuda or cpu, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_group_norm takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_group_norm needs a contiguous x")
    if c > _MAX_CHANNELS:
        raise ValueError(f"fused_group_norm takes at most {_MAX_CHANNELS} channels, got {c}")
    return _FusedGroupNorm.apply(x, scale, bias, num_groups, float(eps), act)


class _FusedGroupNorm(torch.autograd.Function):
    """The kernel forward; the backward recomputes through
    :func:`group_norm_reference`."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups: int, eps: float, act: str):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = dict(num_groups=num_groups, eps=eps, act=act)
        return _launch(x, scale, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, grad_out):
        def plain(x, scale, bias):
            return group_norm_reference(x, scale, bias, **ctx.config)

        return recompute_grads(plain, ctx.saved_tensors, ctx.needs_input_grad[:3],
                               grad_out) + (None, None, None)


def _launch(x, scale, bias, num_groups: int, eps: float, act: str) -> torch.Tensor:
    n, rows, c = x.shape
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    chunks, per = stats_chunks(n, rows)
    y = torch.empty_like(x)
    partial = torch.empty((n, chunks, 2, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((n, num_groups, 2), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _launcher()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                partial.data_ptr(), stats.data_ptr(), _DTYPES[x.dtype], n, rows,
                c, num_groups, chunks, per, float(eps), int(act == "silu"), stream)
    global _launches
    _launches += _KERNELS_PER_CALL
    return y
