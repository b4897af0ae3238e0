"""Frame attention (every frame's queries against frame 0's keys/values): two
hand-written CUDA kernels, their plain PyTorch versions, and the dispatch.

Port of ``videop2p_tpu/ops/attention.py``. Shapes: q (B, F, H, N, D); k, v
(B, H, N, D), shared by all F frames; out (B, F, H, N, D) in q's dtype.

  * :func:`dense_frame_attention` — one product, f32 softmax; the small-site
    path (N < 1024 tokens) on every device.
  * :func:`chunked_frame_attention` — the same math over query chunks, so the
    score tensor never exceeds B·F·H·q_chunk·N; the plain version of the
    fused kernel (a dense score tensor at 64² would need ~13 GB in fp32).
  * :func:`fused_frame_attention` — ``csrc/frame_attention.cu`` on a CUDA
    tensor (frames folded into the query axis, K/V tiles streamed through
    shared memory with an online softmax), the chunked plain version on a
    CPU tensor. Its backward takes the chunked plain version's gradients
    one query chunk at a time (JAX's ``_fused_bwd``).
  * :func:`flash_frame_attention`, :func:`flash_rect_frame_attention` — the
    port of the stock Pallas flash-attention kernel: ``csrc/flash_attention.cu``
    on a CUDA tensor, with K/V read per frame at batch stride 0 or with
    frames folded into the query length; their plain
    versions (``*_reference``, through :func:`attention_reference`) on a
    CPU tensor. Their backward is the port of the stock backward kernels:
    ``csrc/flash_attention_bwd.cu`` (dQ, then dK/dV) from the forward's
    per-row residuals; :func:`attention_reference_bwd` is its plain
    version.
  * :func:`make_frame_attention_fn` — the dispatch by implementation name;
    :func:`frame_attention` is its ``"auto"`` rule.

In bfloat16 both forward kernels run one Hopper design
(``csrc/frame_attention_sm90.cuh``: ``wgmma`` on the tensor cores, K/V tiles
fed by TMA, the softmax in registers), and the flash backward another
(``csrc/flash_attention_bwd_sm90.cuh``: ``wgmma``, Q/dO or K/V tiles fed by
TMA, p and dS in registers, the dK/dV query walk split over a thread-block
cluster by :func:`dkv_split`). In float32 both forward kernels and the
flash backward run on the TF32 tensor cores with error-compensated products
(3×TF32: ``csrc/frame_attention_tf32_sm90.cuh`` for the forward,
``csrc/flash_attention_bwd_tf32_sm90.cuh`` for the backward, on the pieces
of ``csrc/sm90_tf32_common.cuh``): a prep kernel writes TF32 hi/lo tiles
into a scratch the wrapper allocates, and ``wgmma`` runs every product as
three TF32 passes; PyTorch's own products keep TF32 off. The float32 kernels
read every operand at any strides.
The TMA path reads q, k and v in place, so a bf16 CUDA tensor it cannot take
raises (:func:`check_tma_operand`), never copies; the backward copies only
an output gradient (or, rarely, a broadcast q) that its TMA maps cannot
read (:func:`_tma_rows`), since autograd, not the caller, chose its layout.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Optional

import torch

from videop2p_tpu_torch.obs.introspect import note_kernel
from videop2p_tpu_torch.ops._autograd import recompute_grads
from videop2p_tpu_torch.ops._build import bind
from videop2p_tpu_torch.utils.cuda_graphs import count_launch

__all__ = [
    "dense_frame_attention",
    "chunked_frame_attention",
    "fused_frame_attention",
    "attention_reference",
    "attention_reference_bwd",
    "flash_frame_attention",
    "flash_rect_frame_attention",
    "flash_frame_attention_reference",
    "flash_rect_frame_attention_reference",
    "make_frame_attention_fn",
    "frame_attention",
    "launch_count",
    "reset_launch_count",
    "flash_launch_count",
    "reset_flash_launch_count",
    "flash_bwd_launch_counts",
    "reset_flash_bwd_launch_counts",
    "check_tma_operand",
    "dkv_split",
    "FRAME_ATTENTION_IMPLS",
    "MIN_LARGE_TOKENS",
]

MIN_LARGE_TOKENS = 1024
FRAME_ATTENTION_IMPLS = ("auto", "fused", "dense", "chunked", "flash", "flash_rect")
_SOURCE = "frame_attention.cu"
_FLASH_SOURCE = "flash_attention.cu"
_FLASH_BWD_SOURCE = "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
# the bf16 dK/dV kernel: keys per block, query rows per tile (at most), and
# the portable thread-block cluster size
_DKV_KEYS = 128
_DKV_ROWS = 64
_MAX_CLUSTER = 8

_launches = 0
_flash_launches = 0
_flash_bwd_launches = {"dkv": 0, "dq": 0}
# two engines may launch from two threads at once: a count is one
# read-modify-write under this lock, so none is lost
_count_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _launcher():
    # q, k, v, out, then the shape, the strides, the scale, the scratch and
    # the stream
    return bind(_SOURCE, "frame_attention_fwd",
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _flash_launcher():
    return bind(_FLASH_SOURCE, "flash_attention_fwd",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _fwd_scratch_query():
    return bind(_SOURCE, "frame_attention_tf32_scratch_bytes",
                [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)])


def _fwd_scratch(q: torch.Tensor, b0: int, h: int, lk: int, d: int) -> Optional[torch.Tensor]:
    """The float32 forward kernels' scratch for a q of B0·H (b0, h)
    problems of ``lk`` keys (the K/V tiles their prep kernel writes, TF32
    hi/lo, ≈ 4·B0·H·Lk·D floats), freed after the call; None in bfloat16."""
    if q.dtype != torch.float32:
        return None
    nbytes = ctypes.c_longlong(0)
    _fwd_scratch_query()(b0, h, lk, d, ctypes.byref(nbytes))
    return torch.empty(nbytes.value, device=q.device, dtype=torch.uint8)


@functools.lru_cache(maxsize=None)
def _flash_bwd_launcher(name: str):
    # q, k, v, o, dout, m, l, rows, then dq or dk, dv; the dK/dV launcher
    # takes the cluster split before the stream
    outs, split = ([ctypes.c_void_p] * 2, [ctypes.c_int]) if name == "dkv" else (
        [ctypes.c_void_p], [])
    return bind(_FLASH_BWD_SOURCE, f"flash_attention_bwd_{name}",
                [ctypes.c_void_p] * 8 + outs + [ctypes.c_int] * 7
                + [ctypes.c_void_p, ctypes.c_float] + split + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _flash_bwd_scratch_query():
    return bind(_FLASH_BWD_SOURCE, "flash_attention_bwd_scratch_bytes",
                [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)])


def _flash_bwd_scratch_bytes(b0: int, b1: int, h: int, lq: int, lk: int, d: int) -> int:
    """Bytes of the float32 backward's scratch: the tiles its prep kernel
    writes for the dQ and dK/dV kernels."""
    nbytes = ctypes.c_longlong(0)
    _flash_bwd_scratch_query()(b0, b1, h, lq, lk, d, ctypes.byref(nbytes))
    return nbytes.value


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _add_fused(n: int) -> None:
    global _launches
    with _count_lock:
        _launches += n


def _add_flash(n: int) -> None:
    global _flash_launches
    with _count_lock:
        _flash_launches += n


def _add_flash_bwd_dq(n: int) -> None:
    with _count_lock:
        _flash_bwd_launches["dq"] += n


def _add_flash_bwd_dkv(n: int) -> None:
    with _count_lock:
        _flash_bwd_launches["dkv"] += n


def launch_count() -> int:
    """Launches of the fused kernel since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_launch_count() -> int:
    """Launches of the flash kernel since the last
    :func:`reset_flash_launch_count`."""
    return _flash_launches


def reset_flash_launch_count() -> None:
    global _flash_launches
    _flash_launches = 0


def flash_bwd_launch_counts() -> dict:
    """Launches of the two flash backward kernels (``"dkv"``, ``"dq"``)
    since the last :func:`reset_flash_bwd_launch_counts`."""
    return dict(_flash_bwd_launches)


def reset_flash_bwd_launch_counts() -> None:
    for name in _flash_bwd_launches:
        _flash_bwd_launches[name] = 0


def dense_frame_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    scale = q.shape[-1] ** -0.5
    sim = torch.einsum("bfhqd,bhkd->bfhqk", q, k) * scale
    probs = torch.softmax(sim.float(), dim=-1).to(q.dtype)
    return torch.einsum("bfhqk,bhkd->bfhqd", probs, v)


def chunked_frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, q_chunk: int = 512) -> torch.Tensor:
    """Exact attention over query chunks of the token axis; dense when N does
    not split into whole chunks (the JAX version's rule). Under autograd it
    saves only q, k and v, and its backward recomputes one chunk's scores
    at a time (:func:`_chunked_grads`): the memory bound of JAX's
    ``jax.checkpoint`` per chunk."""
    n = q.shape[3]
    if n % q_chunk != 0 or n <= q_chunk:
        return dense_frame_attention(q, k, v)
    return _ChunkedFrameAttention.apply(q, k, v, q_chunk)


class _ChunkedFrameAttention(torch.autograd.Function):
    """The chunks' outputs, nothing of them saved; the backward is
    :func:`_chunked_grads`."""

    @staticmethod
    def forward(ctx, q, k, v, q_chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.q_chunk = q_chunk
        return torch.cat([dense_frame_attention(q[:, :, :, i:i + q_chunk], k, v)
                          for i in range(0, q.shape[3], q_chunk)], dim=3)

    @staticmethod
    def backward(ctx, grad_out):
        return (*_chunked_grads(ctx.saved_tensors, ctx.needs_input_grad[:3], grad_out,
                                ctx.q_chunk), None)


def _chunked_grads(inputs, needs, grad_out: torch.Tensor, q_chunk: int = 512) -> tuple:
    """The gradients of :func:`chunked_frame_attention` at ``inputs`` (q, k,
    v) against ``grad_out``, None where ``needs`` is false, one query chunk
    at a time: each chunk's forward is recomputed once and its
    vector-Jacobian product taken at once, so one chunk's scores are alive
    at a time; dK and dV sum over the chunks in order."""
    q, k, v = inputs
    n = q.shape[3]
    if n % q_chunk != 0 or n <= q_chunk:
        return recompute_grads(dense_frame_attention, inputs, needs, grad_out)
    dq, dk, dv = [], None, None
    for i in range(0, n, q_chunk):
        rows = slice(i, i + q_chunk)
        gq, gk, gv = recompute_grads(dense_frame_attention, (q[:, :, :, rows], k, v), needs,
                                     grad_out[:, :, :, rows])
        dq.append(gq)
        dk = gk if dk is None else dk + gk
        dv = gv if dv is None else dv + gv
    return torch.cat(dq, dim=3) if needs[0] else None, dk, dv


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


def _check_cuda_inputs(name, q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} needs a contiguous last dimension")
    if q.shape[-1] > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {_MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16:
        for operand, t in (("q", q), ("k", k), ("v", v)):
            check_tma_operand(f"{name} {operand}", t)


def _tma_fault(t: torch.Tensor) -> Optional[str]:
    """Why the bf16 kernels' TMA path cannot read ``t`` in place, or None if
    it can: last dimension contiguous, base address aligned to 16 bytes,
    and the stride of every other dimension longer than 1 a multiple of 16
    bytes (a TMA tensor map's rule; a stride of 0, K/V shared by frames, is
    one). Reads only the tensor's metadata, so it runs on a CPU tensor too."""
    item = t.element_size()
    if t.stride(-1) != 1:
        return f"the TMA path needs a contiguous last dimension, got D stride {t.stride(-1)}"
    if t.data_ptr() % 16:
        return (f"the TMA path needs a base address aligned to 16 bytes, got "
                f"{t.data_ptr():#x} ({t.data_ptr() % 16} bytes off)")
    for dim, (size, stride) in enumerate(zip(t.shape[:-1], t.stride()[:-1])):
        if size > 1 and (stride * item) % 16:
            return (f"the TMA path needs strides that are multiples of 16 bytes, got "
                    f"stride {stride} ({stride * item} bytes) in dimension {dim} of shape "
                    f"{tuple(t.shape)}")
    return None


def check_tma_operand(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` naming the stride or the alignment at fault
    unless the bf16 kernels' TMA path can read ``t`` in place
    (:func:`_tma_fault`)."""
    fault = _tma_fault(t)
    if fault is not None:
        raise ValueError(f"{name}: {fault}")


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the bf16 backward's row tensor maps can read it in
    place — :func:`_tma_fault` finds nothing and no dimension longer than 1
    has a stride of 0 (a map steps every row) — else a contiguous copy in a
    fresh, aligned allocation (``contiguous()`` would return a contiguous
    view whose base is off 16 bytes as it is). For the output gradient,
    whose layout autograd chooses (an expanded scalar from
    ``sum().backward()`` has every stride 0), and q."""
    broadcast = any(size > 1 and stride == 0 for size, stride in zip(t.shape, t.stride()))
    if broadcast or _tma_fault(t) is not None:
        return t.clone(memory_format=torch.contiguous_format)
    return t


def dkv_split(blocks: int, rows: int, sms: int) -> int:
    """The CTAs of a thread-block cluster that share one key block's query
    walk in the bf16 dK/dV kernel: ``blocks`` key blocks (B0·H·⌈Lk/128⌉, one
    a CTA), ``rows`` query rows per (b0, h) (B1·Lq), ``sms`` streaming
    multiprocessors. The largest power of two, at most 8 (the portable
    cluster size) and at most one CTA per 64 query rows, that keeps
    blocks·split within one wave of the card: 1 where the key blocks alone
    fill it (the 64² null-text site, 256 blocks), 2 at the 32² site (64
    blocks on 132 SMs)."""
    split = 1
    while (split < _MAX_CLUSTER and blocks * split * 2 <= sms
           and split * 2 * _DKV_ROWS <= rows):
        split *= 2
    return split


def _frame_major_out(q: torch.Tensor) -> torch.Tensor:
    """An output of q's shape (B, F, H, N, D) laid out as (B, F, N, H, D), so
    merging heads afterwards is a view."""
    b, f, h, n, d = q.shape
    return torch.empty((b, f, n, h, d), device=q.device, dtype=q.dtype).transpose(2, 3)


class _FusedFrameAttention(torch.autograd.Function):
    """The kernel forward; the backward is :func:`chunked_frame_attention`'s
    (:func:`_chunked_grads`; JAX: ``_fused_bwd``,
    videop2p_tpu/ops/attention.py:186-197, a VJP through the checkpointed
    chunks)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _fused_launch(q, k, v)

    @staticmethod
    def backward(ctx, grad_out):
        return _chunked_grads(ctx.saved_tensors, ctx.needs_input_grad, grad_out)


def fused_frame_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Frame attention through the CUDA kernel for a CUDA tensor, the chunked
    plain version for a CPU tensor. q, k and v may be strided views whose
    last dimension is contiguous; the output has the memory layout
    (B, F, N, H, D) seen as (B, F, H, N, D), so merging heads afterwards is
    a view. Differentiable: on a CUDA tensor the backward is the chunked
    plain version's, which recomputes one chunk at a time, as the JAX
    package's does through its checkpointed chunks."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return chunked_frame_attention(q, k, v)
    _check_cuda_inputs("fused_frame_attention", q, k, v)
    return _FusedFrameAttention.apply(q, k, v)


def _fused_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, f, h, n, d = q.shape
    if b * h > 65535:
        raise ValueError(f"B·H = {b * h} exceeds the kernel's grid")
    out = _frame_major_out(q)
    scratch = _fwd_scratch(q, b, h, n, d)
    strides = (ctypes.c_longlong * 14)(
        *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], *out.stride()[:4])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, f, h, n, d,
                ctypes.cast(strides, ctypes.c_void_p), float(d ** -0.5),
                None if scratch is None else scratch.data_ptr(), stream)
    count_launch(_add_fused)
    note_kernel("frame_attention_fwd", _SOURCE, (q, k, v), (out,),
                flops=4 * b * f * h * n * n * d, transcendentals=b * f * h * n * n)
    return out


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_chunk: int = 512, residuals: bool = False):
    """Plain version of the flash kernel: softmax(q·kᵀ/√D)·v over q
    (…, Lq, D) and k, v (…, Lk, D) whose leading dimensions broadcast,
    chunked over queries. Scores and softmax in f32; the unnormalized
    probabilities are rounded to v's dtype before the product with v (the
    stock kernel's ``p.astype(v.dtype)``), the row sum is taken in f32, and
    the output is in q's dtype. With ``residuals`` also returns the per-row
    f32 maximum ``m`` of the scaled scores and the sum ``l`` of exp(s − m)
    (…, Lq): the stock forward's ``save_residuals`` outputs."""
    scale = q.shape[-1] ** -0.5
    kt = k.float().transpose(-1, -2)
    vf = v.float()
    outs, ms, ls = [], [], []
    for i in range(0, q.shape[-2], q_chunk):
        s = torch.matmul(q[..., i:i + q_chunk, :].float(), kt) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        outs.append((torch.matmul(p.to(v.dtype).float(), vf) / l).to(q.dtype))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
    out = torch.cat(outs, dim=-2)
    if residuals:
        return out, torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)
    return out


def attention_reference_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, do: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, *, q_chunk: int = 512):
    """Plain version of the flash backward kernels (JAX: the stock
    ``mha_reference_bwd``, flash_attention.py:1615, with the kernels'
    rounding points): from the forward's output ``o``, its residuals ``m``,
    ``l`` (…, Lq) and the output gradient ``do``,

        p  = exp(q·kᵀ·scale − m) / l            (f32)
        dv = Σ_q p.to(do.dtype)ᵀ·do
        ds = (do·vᵀ − Σ_d o·do) · p · scale     (f32)
        dk = Σ_q ds.to(do.dtype)ᵀ·q,   dq = ds.to(k.dtype)·k

    with f32 products of the (rounded) operands, over query chunks. k and v
    may broadcast against q in their leading dimensions; dk and dv are then
    summed back to k's and v's shapes. Returns (dq, dk, dv) in q's, k's and
    v's dtypes."""
    scale = q.shape[-1] ** -0.5
    kf, vf = k.float(), v.float()
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    dk = torch.zeros((*lead, *k.shape[-2:]), dtype=torch.float32, device=q.device)
    dv = torch.zeros((*lead, *v.shape[-2:]), dtype=torch.float32, device=q.device)
    dqs = []
    for i in range(0, q.shape[-2], q_chunk):
        sl = slice(i, i + q_chunk)
        qc, doc = q[..., sl, :], do[..., sl, :]
        s = torch.matmul(qc.float(), kf.transpose(-1, -2)) * scale
        p = torch.exp(s - m[..., sl, None]) / l[..., sl, None]
        di = (o[..., sl, :].float() * doc.float()).sum(-1, keepdim=True)
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), doc.float())
        ds = (torch.matmul(doc.float(), vf.transpose(-1, -2)) - di) * p * scale
        dk += torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), qc.float())
        dqs.append(torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype))
    return (torch.cat(dqs, dim=-2), dk.sum_to_size(k.shape).to(k.dtype),
            dv.sum_to_size(v.shape).to(v.dtype))


def _flash(q5: torch.Tensor, k5: torch.Tensor, v5: torch.Tensor,
           out5: torch.Tensor, m: Optional[torch.Tensor] = None,
           l: Optional[torch.Tensor] = None) -> None:
    """Launch ``csrc/flash_attention.cu`` on (B0, B1, H, L, D) views; k5
    and v5 have a batch stride of 0 over B1 (one K/V batch shared by the
    query batches) or B1 = 1.
    ``m``, ``l``: contiguous f32 (B0, B1, H, Lq) buffers for the per-row
    residuals of the backward, or None."""
    b0, b1, h, lq, d = q5.shape
    lk = k5.shape[3]
    if b0 * h > 65535:
        raise ValueError(f"B·H = {b0 * h} exceeds the kernel's grid")
    scratch = _fwd_scratch(q5, b0, h, lk, d)
    strides = (ctypes.c_longlong * 16)(
        *q5.stride()[:4], *k5.stride()[:4], *v5.stride()[:4], *out5.stride()[:4])
    stream = torch.cuda.current_stream(q5.device).cuda_stream
    _flash_launcher()(q5.data_ptr(), k5.data_ptr(), v5.data_ptr(), out5.data_ptr(),
                      None if m is None else m.data_ptr(),
                      None if l is None else l.data_ptr(),
                      _DTYPES[q5.dtype], b0, b1, h, lq, lk, d,
                      ctypes.cast(strides, ctypes.c_void_p), float(d ** -0.5),
                      None if scratch is None else scratch.data_ptr(), stream)
    count_launch(_add_flash)
    # K/V read once however many query batches share them (stride 0)
    kv = [t[:, :1] if t.stride(1) == 0 else t for t in (k5, v5)]
    rows = b0 * b1 * h * lq * lk
    note_kernel("flash_attention_fwd", _FLASH_SOURCE, (q5, *kv),
                tuple(t for t in (out5, m, l) if t is not None),
                flops=4 * rows * d, transcendentals=rows)


def _flash_bwd(q5, k4, v4, o5, do5, m, l, dq5, dk4, dv4) -> None:
    """Launch the kernels of ``csrc/flash_attention_bwd.cu``, dQ first: q5,
    o5, do5, dq5 are (B0, B1, H, Lq, D) views, k4, v4, dk4, dv4 (B0, H, Lk,
    D) views shared by the B1 query batches, m and l the forward's
    residuals. No two blocks write one K/V row: the dK/dV kernel sums over
    every query of the B1 batches inside one block, or in bf16 inside one
    cluster of :func:`dkv_split` blocks, in a fixed order. In bf16 the dQ
    kernel computes di = Σ_d o·do and hands each row's lse and di·scale to
    the dK/dV kernel through ``rows``; in float32 the dQ launch first runs
    a prep kernel that writes both kernels' TF32 hi/lo tiles (and those
    rows) into ``rows``, a scratch freed after the call."""
    b0, b1, h, lq, d = q5.shape
    lk = k4.shape[2]
    if -(-max(lq, lk) // 64) > 65535:
        raise ValueError(f"lengths {lq}, {lk} exceed the kernels' grid")
    split = 1
    if q5.dtype == torch.bfloat16:
        for name, t in (("q", q5), ("grad_out", do5)):
            check_tma_operand(f"flash backward {name}", t)
        split = dkv_split(b0 * h * -(-lk // _DKV_KEYS), b1 * lq,
                          _sm_count(q5.device.index))
        # per 64-row tile of each (b0, b1, h): 64 lse, then 64 di·scale
        rows = torch.empty(b0 * b1 * h * -(-lq // 64) * 128, device=q5.device,
                           dtype=torch.float32)
    else:
        rows = torch.empty(_flash_bwd_scratch_bytes(b0, b1, h, lq, lk, d),
                           device=q5.device, dtype=torch.uint8)
    strides = (ctypes.c_longlong * 28)(
        *q5.stride()[:4], *o5.stride()[:4], *do5.stride()[:4], *dq5.stride()[:4],
        *k4.stride()[:3], *v4.stride()[:3], *dk4.stride()[:3], *dv4.stride()[:3])
    stream = torch.cuda.current_stream(q5.device).cuda_stream
    common = (q5.data_ptr(), k4.data_ptr(), v4.data_ptr(), o5.data_ptr(), do5.data_ptr(),
              m.data_ptr(), l.data_ptr(), rows.data_ptr())
    shape = (_DTYPES[q5.dtype], b0, b1, h, lq, lk, d,
             ctypes.cast(strides, ctypes.c_void_p), float(d ** -0.5))
    _flash_bwd_launcher("dq")(*common, dq5.data_ptr(), *shape, stream)
    count_launch(_add_flash_bwd_dq)
    # each kernel recomputes the scores: dQ = S, dP, dS·K (6 flops a score
    # and head-dim element); dK/dV = S, dV, dP, dK (8)
    inputs, scores = (q5, k4, v4, o5, do5, m, l), b0 * b1 * h * lq * lk
    note_kernel("flash_attention_bwd_dq", _FLASH_BWD_SOURCE, inputs, (dq5,),
                flops=6 * scores * d, transcendentals=scores)
    _flash_bwd_launcher("dkv")(*common, dk4.data_ptr(), dv4.data_ptr(), *shape, split, stream)
    count_launch(_add_flash_bwd_dkv)
    note_kernel("flash_attention_bwd_dkv", _FLASH_BWD_SOURCE, inputs, (dk4, dv4),
                flops=8 * scores * d, transcendentals=scores)


def _rect_view(x: torch.Tensor) -> torch.Tensor:
    """(B, F, H, N, D) → (B, 1, H, F·N, D): a view for FrameAttention's
    projections and the kernels' outputs, whose frame stride is N times
    their token stride; a copy otherwise."""
    b, f, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, h, f * n, d)[:, None]


def _kv_major(k: torch.Tensor) -> torch.Tensor:
    """An empty tensor of k's shape (B, H, N, D) laid out as (B, N, H, D),
    the layout of FrameAttention's K/V projections."""
    b, h, n, d = k.shape
    return torch.empty((b, n, h, d), device=k.device, dtype=k.dtype).transpose(1, 2)


class _FlashFrameAttention(torch.autograd.Function):
    """The flash kernel forward (with its residuals when a gradient is
    wanted) and the two backward kernels. ``rect`` folds frames into the
    query length; otherwise the frames are a second batch axis whose K/V
    stride is 0. Either way the dK/dV kernel sums over all frames' queries,
    which is the VJP of JAX's K/V broadcast (attention.py:88-89)."""

    @staticmethod
    def forward(ctx, q, k, v, rect: bool, residuals: bool):
        b, f, h, n, d = q.shape
        out = _frame_major_out(q)
        if rect:
            q5, out5 = _rect_view(q), _rect_view(out)
            k5, v5 = k[:, None], v[:, None]
        else:
            q5, out5 = q, out
            k5 = k[:, None].expand(b, f, h, n, d)
            v5 = v[:, None].expand(b, f, h, n, d)
        m = l = None
        if residuals:
            m, l = (torch.empty(q5.shape[:4], device=q.device, dtype=torch.float32)
                    for _ in range(2))
        _flash(q5, k5, v5, out5, m, l)
        if residuals:
            ctx.save_for_backward(q, k, v, out, m, l)
        ctx.rect = rect
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, m, l = ctx.saved_tensors
        if q.dtype == torch.bfloat16:
            # the bf16 kernels read q and grad_out through TMA maps
            q, grad_out = _tma_rows(q), _tma_rows(grad_out)
        elif grad_out.stride(-1) != 1:
            grad_out = grad_out.contiguous()
        dq, dk, dv = _frame_major_out(q), _kv_major(k), _kv_major(v)
        fold = _rect_view if ctx.rect else (lambda x: x)
        _flash_bwd(fold(q), k, v, fold(out), fold(grad_out), m, l, fold(dq), dk, dv)
        return dq, dk, dv, None, None


def _flash_apply(q, k, v, rect: bool) -> torch.Tensor:
    residuals = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return _FlashFrameAttention.apply(q, k, v, rect, residuals)


def flash_frame_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`flash_frame_attention`: K/V broadcast
    over the frame axis (a view, not a copy)."""
    return attention_reference(q, k[:, None], v[:, None])


def flash_rect_frame_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                         v: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`flash_rect_frame_attention`: frames
    folded into the query length."""
    b, f, h, n, d = q.shape
    qr = q.transpose(1, 2).reshape(b, h, f * n, d)
    return attention_reference(qr, k, v).reshape(b, h, f, n, d).transpose(1, 2)


def flash_frame_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Frame attention through the flash kernel with the frame axis as a
    second batch axis (JAX: frames folded into the batch, K/V broadcast per
    frame). Here K/V are not copied: their frame stride is 0, so every frame
    reads frame 0's K/V in place. Differentiable through the flash backward
    kernels. A CPU tensor runs :func:`flash_frame_attention_reference`."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_frame_attention_reference(q, k, v)
    _check_cuda_inputs("flash_frame_attention", q, k, v)
    return _flash_apply(q, k, v, rect=False)


def flash_rect_frame_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """Frame attention through the flash kernel with frames folded into the
    query length: q (B, H, F·N, D) against k, v (B, H, N, D). Softmax is per
    row, so the fold is exact. Differentiable through the flash backward
    kernels. A CPU tensor runs :func:`flash_rect_frame_attention_reference`."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_rect_frame_attention_reference(q, k, v)
    _check_cuda_inputs("flash_rect_frame_attention", q, k, v)
    return _flash_apply(q, k, v, rect=True)


def make_frame_attention_fn(impl: str = "auto", *,
                            min_large_tokens: int = MIN_LARGE_TOKENS,
                            q_chunk: int = 512) -> Callable:
    """The frame-attention implementation by name (JAX:
    ``make_frame_attention_fn``, videop2p_tpu/ops/attention.py:204-262).

      * ``"auto"``, ``"fused"`` — :func:`fused_frame_attention` (the fused
        kernel on a CUDA tensor) where the head dim is at most 128, as in
        JAX, ``"chunked"`` otherwise;
      * ``"flash"``, ``"flash_rect"`` — :func:`flash_frame_attention` /
        :func:`flash_rect_frame_attention` (the flash kernel on a CUDA
        tensor) where JAX's ``flash_ok`` holds (head dim ≤ 128 or a
        multiple of 128), ``"chunked"`` otherwise (SD-1.5's head dims are
        40, 80 and 160). A head dim the kernel does not take (a multiple of
        128 above 128) raises on a CUDA tensor;
      * ``"chunked"`` — :func:`chunked_frame_attention`;
      * ``"dense"`` — :func:`dense_frame_attention`.

    Below ``min_large_tokens`` tokens every name takes the dense path; a CPU
    tensor runs each kernel's plain version. An unknown name raises
    ``ValueError``, as does a q of rank other than 5.
    """
    if impl not in FRAME_ATTENTION_IMPLS:
        raise ValueError(f"unknown frame attention impl: {impl!r}")
    if impl == "dense":
        return dense_frame_attention

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if q.dim() != 5:
            raise ValueError(
                "frame-attention kernels take q of shape (B, F, H, N, D); "
                f"got rank-{q.dim()} {tuple(q.shape)}")
        n, d = q.shape[3], q.shape[4]
        if n < min_large_tokens:
            return dense_frame_attention(q, k, v)
        if impl in ("auto", "fused"):
            # JAX's rule also asks (F·N) % 256 == 0, a limit of its Pallas
            # grid; the CUDA kernel takes ragged lengths and both routes
            # compute one function, so only the head dim decides here
            if d <= _MAX_HEAD_DIM:
                return fused_frame_attention(q, k, v)
            return chunked_frame_attention(q, k, v, q_chunk=q_chunk)
        flash_ok = d <= _MAX_HEAD_DIM or d % 128 == 0
        if impl == "flash_rect" and flash_ok:
            return flash_rect_frame_attention(q, k, v)
        if impl == "flash" and flash_ok:
            return flash_frame_attention(q, k, v)
        return chunked_frame_attention(q, k, v, q_chunk=q_chunk)

    fn.impl = impl
    return fn


frame_attention = make_frame_attention_fn("auto")
