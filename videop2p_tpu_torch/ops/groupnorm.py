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
gate: the TPU kernel's VMEM limit (rows % 256, ≤ 3 MiB) does not carry over.

The kernel is one persistent, cooperative launch a call: one block per SM,
each over a contiguous range of the flat (N·rows) rows, a grid barrier
between the statistics and the apply, the first rows of each range kept in
shared memory between the two. :func:`plan` decides its geometry in plain
Python (the CPU tests reach it); the wrapper keeps one scratch buffer per
device and stream (the barrier's counter and the per-block partial sums),
grown when a call needs more and never allocated per call.

A slab whose rows are split over several processes (the frame-pooled resnet
norms when frames are sharded, ``parallel/mesh.py``) runs the same kernel in
two launches: :func:`group_norm_stats` (the per-(sample, group) Σx, Σx² in
f32, the fused launch's bits) and, after the caller all-reduces them,
:func:`group_norm_apply`. With one shard the pair gives the fused launch's
bits.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from videop2p_tpu_torch.obs.introspect import hidden_from_analysis, note_kernel
from videop2p_tpu_torch.ops._autograd import recompute_grads
from videop2p_tpu_torch.ops._build import bind
from videop2p_tpu_torch.utils.cuda_graphs import count_launch

__all__ = ["fused_group_norm", "group_norm_reference", "group_norm_stats",
           "group_norm_apply", "launch_count", "reset_launch_count", "plan", "GnPlan",
           "LAUNCHES_PER_CALL"]

_SOURCE = "groupnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# dynamic shared memory one block may use on sm_90 (227 KB)
SMEM_LIMIT = 232_448
# threads a block at most (the kernel's __launch_bounds__)
_MAX_THREADS = 512
# the scratch's head: the grid barrier's 64-bit ticket counter, padded
_SCRATCH_HEAD = 16
# kernel launches per call on a CUDA tensor: one persistent launch
LAUNCHES_PER_CALL = 1
# group_norm_staged's modes (csrc/groupnorm.cu)
_STATS, _APPLY = 1, 2

_launches = 0
# two engines may launch from two threads at once (see ops/attention.py)
_count_lock = threading.Lock()
# (device index, stream) → the scratch buffer, grown on demand
_scratch: dict = {}
# the buffers a growth replaced: a captured CUDA graph may still launch on one
_retired: list = []


class GnPlan(NamedTuple):
    """The launch geometry of one call (``csrc/groupnorm.cu``)."""

    vec: int          # channels a thread moves per access (16 bytes, or 1)
    threads: int      # threads a block
    lanes: int        # row lanes: a thread walks rows lane, lane + lanes, …
    colsets: int      # columns a thread owns (lanes == 1 when > 1)
    grid: int         # blocks: one per SM, every call
    samples_per_block: int  # K: the most samples one block's range touches
    blocks_per_sample: int  # S: the most blocks whose ranges touch one sample
    smem_rows: int    # rows of a block's range kept in shared memory
    capacity_rows: int  # rows a block's shared memory could hold
    smem_bytes: int   # dynamic shared memory a block asks for
    scratch_bytes: int  # ticket counter + N·S·G (sum, sum of squares) f32 pairs
    launches: int     # kernel launches per call

    def row_start(self, b: int, total: int) -> int:
        """The first flat row of block ``b``'s range (as the kernel splits)."""
        return b * total // self.grid


@functools.lru_cache(maxsize=None)
def _launcher():
    return bind(_SOURCE, "group_norm_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _staged_launcher():
    return bind(_SOURCE, "group_norm_staged", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 16
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def plan(n: int, rows: int, c: int, dtype: torch.dtype, sms: int, num_groups: int = 32,
         aligned: bool = True) -> GnPlan:
    """The kernel's geometry for x of shape (n, rows, c): a grid of ``sms``
    blocks (one per SM, co-resident), block b over the flat rows
    [b·R/sms, (b+1)·R/sms) of R = n·rows; a thread per column of ``vec``
    channels (16 bytes when c allows it and x is 16-byte ``aligned``, else
    one channel) and row lane; as many of each range's first rows in shared
    memory as fit beside the per-lane sums and the statistics. Raises
    ValueError on a shape the kernel cannot take."""
    if dtype not in _ITEMSIZE:
        raise TypeError(f"fused_group_norm takes float32 or bfloat16, got {dtype}")
    if n < 1 or rows < 1 or c < 1 or sms < 1 or c % num_groups:
        raise ValueError(f"no GroupNorm plan for (N, rows, C) = ({n}, {rows}, {c}), "
                         f"{num_groups} groups, {sms} SMs")
    total = n * rows
    if total >= 2 ** 31:
        raise ValueError(f"fused_group_norm takes fewer than 2^31 rows, got N·rows = {total}")
    itemsize = _ITEMSIZE[dtype]
    wide = 16 // itemsize
    vec = wide if aligned and c % wide == 0 else 1
    cols = c // vec
    if cols <= _MAX_THREADS:
        colsets, lanes = 1, _MAX_THREADS // cols
        threads = -(-lanes * cols // 32) * 32
    else:
        colsets, lanes = -(-cols // _MAX_THREADS), 1
        per_set = -(-cols // colsets)
        threads = -(-per_set // 32) * 32
    grid = sms
    k = 1
    for b in range(grid):
        r0, r1 = b * total // grid, (b + 1) * total // grid
        if r1 > r0:
            k = max(k, (r1 - 1) // rows - r0 // rows + 1)
    # the blocks whose ranges touch sample m: block_of(m·rows) … block_of((m+1)·rows − 1)
    s_max = max(((m + 1) * rows * grid - 1) // total - ((m * rows + 1) * grid - 1) // total + 1
                for m in range(n))
    # per-lane sums [lanes][c] × 2, statistics [K][G][2], per-warp group sums [warps][G][2]
    fixed = (2 * lanes * c + 2 * k * num_groups + 2 * (threads // 32) * num_groups) * 4
    if fixed > SMEM_LIMIT:
        raise ValueError(
            f"fused_group_norm cannot take (N, rows, C) = ({n}, {rows}, {c}) with "
            f"{num_groups} groups: the per-lane sums and statistics need {fixed} bytes "
            f"of shared memory a block, over the {SMEM_LIMIT} an SM has")
    row_bytes = c * itemsize
    # the slab is padded to 16 bytes ahead of the sums
    capacity = (SMEM_LIMIT - fixed) // 16 * 16 // row_bytes
    smem_rows = min(-(-total // grid), capacity)
    smem_bytes = -(-smem_rows * row_bytes // 16) * 16 + fixed
    return GnPlan(vec=vec, threads=threads, lanes=lanes, colsets=colsets, grid=grid,
                  samples_per_block=k, blocks_per_sample=s_max, smem_rows=smem_rows,
                  capacity_rows=capacity, smem_bytes=smem_bytes,
                  scratch_bytes=_SCRATCH_HEAD + n * s_max * num_groups * 2 * 4,
                  launches=LAUNCHES_PER_CALL)


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count` (one per
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
    # raises on a shape the kernel cannot take, before autograd records it
    _plan_for(x, num_groups)
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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_for(x: torch.Tensor, num_groups: int) -> GnPlan:
    n, rows, c = x.shape
    return plan(n, rows, c, x.dtype, _sm_count(x.device.index), num_groups,
                x.data_ptr() % 16 == 0)


def _scratch_for(device: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """The scratch of (device, stream), grown to ``nbytes``: allocated
    zeroed (the barrier's counter starts at 0 and is never reset), and
    reused by every later call on that stream, which runs after it. A
    grown scratch keeps the one it replaces alive (a graph captured on the
    stream holds its address)."""
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        if buf is not None:
            _retired.append(buf)
        # built once and kept: a program analysis must not see it only on
        # the call that happens to grow it
        with hidden_from_analysis():
            buf = _scratch[key] = torch.zeros(max(nbytes, 1 << 16), dtype=torch.uint8,
                                              device=device)
    return buf


def _params(x, scale, bias):
    """scale and bias as the kernel reads them: as they are when both are
    float32 or both bfloat16 (no cast a call), else cast to float32; on x's
    device. Returns (scale, bias, param_bf16)."""
    param_bf16 = scale.dtype == bias.dtype == torch.bfloat16
    if not (param_bf16 or scale.dtype == bias.dtype == torch.float32):
        scale, bias = scale.float(), bias.float()
    return scale.to(x.device).contiguous(), bias.to(x.device).contiguous(), param_bf16


def _count(launches: int) -> None:
    global _launches
    with _count_lock:
        _launches += launches


def _launch(x, scale, bias, num_groups: int, eps: float, act: str) -> torch.Tensor:
    n, rows, c = x.shape
    p = _plan_for(x, num_groups)
    scale, bias, param_bf16 = _params(x, scale, bias)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch_for(x.device, stream, p.scratch_bytes)
    _launcher()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                scratch.data_ptr(), _DTYPES[x.dtype], int(param_bf16), n, rows, c,
                num_groups, p.vec, p.threads, p.lanes, p.colsets, p.grid,
                p.samples_per_block, p.blocks_per_sample, p.smem_rows, p.smem_bytes,
                float(eps), int(act == "silu"), stream)
    count_launch(_count, p.launches)
    # no product; the SiLU's sigmoid an element
    note_kernel("group_norm_fwd", _SOURCE, (x, scale, bias), (y,),
                transcendentals=x.numel() if act == "silu" else 0)
    return y


def _check_staged(x: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (N, rows, C), got shape {tuple(x.shape)}")
    if x.shape[2] % num_groups:
        raise ValueError(f"channels {x.shape[2]} not divisible by groups {num_groups}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the GroupNorm kernel runs on cuda or cpu, got {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in _DTYPES:
            raise TypeError(f"the GroupNorm kernel takes float32 or bfloat16, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("the GroupNorm kernel needs a contiguous x")


def _staged(mode: int, x, scale, bias, y, sums, num_groups: int, eps: float, silu: bool,
            shards: int) -> None:
    n, rows, c = x.shape
    p = _plan_for(x, num_groups)
    if mode == _APPLY:
        # no slab: the apply re-reads x (the slab of the statistics launch
        # is gone with it)
        slab = -(-p.smem_rows * c * _ITEMSIZE[x.dtype] // 16) * 16
        p = p._replace(smem_rows=0, smem_bytes=p.smem_bytes - slab)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    scratch = _scratch_for(x.device, stream, p.scratch_bytes)
    _staged_launcher()(x.data_ptr(), scale.data_ptr() if scale is not None else None,
                       bias.data_ptr() if bias is not None else None,
                       y.data_ptr() if y is not None else None, scratch.data_ptr(),
                       sums.data_ptr(), mode, _DTYPES[x.dtype],
                       int(scale is not None and scale.dtype == torch.bfloat16), n, rows, c,
                       num_groups, p.vec, p.threads, p.lanes, p.colsets, p.grid,
                       p.samples_per_block, p.blocks_per_sample, p.smem_rows, p.smem_bytes,
                       float(eps), int(silu), int(shards), stream)
    count_launch(_count, 1)


def group_norm_stats(x: torch.Tensor, *, num_groups: int) -> torch.Tensor:
    """The per-(sample, group) Σx and Σx² of a (N, rows, C) slab in f32, as
    (N, G, 2): the kernel's statistics launch on a CUDA tensor (the fused
    launch's sums, bit for bit), the plain sums on a CPU tensor. Not
    differentiable (``parallel/mesh.py`` recomputes its backward)."""
    _check_staged(x, num_groups)
    n, rows, c = x.shape
    if x.device.type == "cpu":
        xf = x.detach().float().reshape(n, rows, num_groups, c // num_groups)
        return torch.stack([xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))], dim=-1)
    sums = torch.empty(n, num_groups, 2, dtype=torch.float32, device=x.device)
    _staged(_STATS, x, None, None, None, sums, num_groups, 0.0, False, 1)
    note_kernel("group_norm_stats", _SOURCE, (x,), (sums,))
    return sums


def group_norm_apply(x: torch.Tensor, sums: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, num_groups: int, eps: float = 1e-5,
                     act: str = "none", shards: int = 1) -> torch.Tensor:
    """GroupNorm(+SiLU) of a (N, rows, C) slab with statistics from ``sums``
    ((N, G, 2) Σx, Σx² in f32 over ``shards`` slabs of ``rows`` rows each,
    the reduced :func:`group_norm_stats` of every shard): mean and the
    biased E[x²]−E[x]² over rows·C/G·shards elements. The kernel's apply
    launch on a CUDA tensor, the plain version on a CPU tensor. Not
    differentiable."""
    if act not in ("none", "silu"):
        raise ValueError(f"act must be 'none' or 'silu', got {act!r}")
    _check_staged(x, num_groups)
    n, rows, c = x.shape
    if tuple(sums.shape) != (n, num_groups, 2) or sums.dtype != torch.float32:
        raise ValueError(f"sums must be float32 ({n}, {num_groups}, 2), got "
                         f"{sums.dtype} {tuple(sums.shape)}")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(
            f"scale/bias must be ({c},), got {tuple(scale.shape)}/{tuple(bias.shape)}")
    count = rows * (c // num_groups) * shards
    if x.device.type == "cpu":
        xf = x.detach().float().reshape(n, rows, num_groups, c // num_groups)
        mean = (sums[..., 0] / count)[:, None, :, None]
        var = (sums[..., 1] / count)[:, None, :, None] - mean * mean
        y = (xf - mean) * torch.rsqrt(var + eps)
        y = y.reshape(n, rows, c) * scale.detach().float() + bias.detach().float()
        if act == "silu":
            y = y * torch.sigmoid(y)
        return y.to(x.dtype)
    if sums.device != x.device or not sums.is_contiguous():
        raise ValueError("sums must be contiguous on x's device")
    scale, bias, _ = _params(x, scale, bias)
    y = torch.empty_like(x)
    _staged(_APPLY, x, scale, bias, y, sums, num_groups, eps, act == "silu", shards)
    note_kernel("group_norm_apply", _SOURCE, (x, sums, scale, bias), (y,),
                transcendentals=x.numel() if act == "silu" else 0)
    return y
