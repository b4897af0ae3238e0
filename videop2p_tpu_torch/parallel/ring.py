"""Ring attention over the frames group (port of
``videop2p_tpu/parallel/ring.py``): each rank holds its query rows and its
K/V block of a sequence split over ``frames``; the K/V blocks rotate around
the ring by NCCL point-to-point sends (``dist.batch_isend_irecv``) while an
online softmax (running max m, denominator l and output o, all float32)
accumulates every block, so no rank ever holds more than two blocks.

The rotation schedules are JAX's, with its hop counts per forward pass (a
hop moves each tensor it carries once; ``obs/comm.py`` counts each send as
one ``collective-permute``):

  * ``"overlap"`` (default) — hop t+1 is posted BEFORE block t computes, so
    the transfer runs under the block's products; n − 1 hops, 2(n − 1)
    sends (K and V);
  * ``"bidir"`` — the local block splits into two sequence halves that
    rotate in opposite directions, half the payload each way; 4(n − 1)
    sends;
  * ``"serial"`` — compute, then send: n hops, the last pair's payload
    unread (kept as the measured baseline, as in JAX); 2n sends.

The backward (:class:`_RingAttention`) is a ring too: the K/V blocks rotate
again, each with float32 dK/dV accumulators that pick up every rank's
contribution as they pass and take one last hop home — the transpose of
JAX's ``ppermute`` chain; nothing is all-gathered. ``"bidir"`` runs its
backward in halves as its forward; ``"serial"`` takes ``"overlap"``'s.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from videop2p_tpu_torch.parallel.mesh import (
    AXIS_FRAMES,
    Mesh,
    frames_slice,
    gather_frames,
    note_collective,
)

__all__ = [
    "RING_VARIANTS",
    "default_ring_variant",
    "ring_attention",
    "ring_attention_sharded",
    "make_ring_temporal_fn",
]

RING_VARIANTS = ("overlap", "bidir", "serial")


def default_ring_variant() -> str:
    """The process-wide default ring schedule: ``VIDEOP2P_RING_VARIANT``
    (one of ``overlap``/``bidir``/``serial``), else ``overlap``."""
    v = os.environ.get("VIDEOP2P_RING_VARIANT", "overlap").strip().lower()
    return v if v in RING_VARIANTS else "overlap"


class _Ring:
    """This rank's place in a ring: the group, its global ranks in order
    and this rank's index."""

    def __init__(self, group, ranks: Sequence[int], index: int):
        self.group, self.ranks, self.index = group, list(ranks), index
        self.n = len(self.ranks)

    def peer(self, step: int) -> int:
        return self.ranks[(self.index + step) % self.n]

    def shift(self, tensors: Sequence[torch.Tensor], step: int) -> Tuple[list, list]:
        """Post the send of each tensor ``step`` places along the ring and
        the receive of its counterpart from ``-step`` places; returns the
        requests and the receive buffers."""
        ops, bufs = [], []
        for t in tensors:
            t = t.contiguous()
            buf = torch.empty_like(t)
            note_collective("collective-permute", t.numel() * t.element_size())
            ops.append(dist.P2POp(dist.isend, t, self.peer(step), self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self.peer(-step), self.group))
            bufs.append(buf)
        return dist.batch_isend_irecv(ops), bufs


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _block_update(q32, k_blk, v_blk, scale, m, l, o):
    """One online-softmax accumulation against a K/V block (exact
    flash-attention rescaling, float32 accumulators; JAX's
    ``_block_update``)."""
    s = torch.matmul(q32, k_blk.float().transpose(-1, -2)) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.matmul(p, v_blk.float())
    return m_new, l, o


def _block_grad(q32, do32, di, lse, k_blk, v_blk, scale):
    """The gradients of one K/V block's share of the attention: (dq part,
    dk, dv), float32."""
    k32, v32 = k_blk.float(), v_blk.float()
    p = torch.exp(torch.matmul(q32, k32.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    ds = p * (dp - di[..., None]) * scale
    return torch.matmul(ds, k32), torch.matmul(ds.transpose(-1, -2), q32), dv


def _halves(t: torch.Tensor):
    half = t.shape[-2] // 2
    return t[..., :half, :], t[..., half:, :]


def _forward(ring: _Ring, q, k, v, scale: float, variant: str):
    n = ring.n
    q32 = q.float()
    m = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    o = torch.zeros(q32.shape, dtype=torch.float32, device=q.device)
    if variant == "serial":
        kb, vb = k, v
        for _ in range(n):
            m, l, o = _block_update(q32, kb, vb, scale, m, l, o)
            reqs, (kb, vb) = ring.shift([kb, vb], 1)
            _wait(reqs)
    elif variant == "overlap":
        kb, vb = k, v
        for t in range(n):
            if t < n - 1:
                reqs, nxt = ring.shift([kb, vb], 1)
            m, l, o = _block_update(q32, kb, vb, scale, m, l, o)
            if t < n - 1:
                _wait(reqs)
                kb, vb = nxt
    else:  # bidir: after t hops this rank holds the A half of block i − t
        # and the B half of block i + t
        (ka, kb), (va, vb) = _halves(k), _halves(v)
        for t in range(n):
            if t < n - 1:
                reqs_a, nxt_a = ring.shift([ka, va], 1)
                reqs_b, nxt_b = ring.shift([kb, vb], -1)
            m, l, o = _block_update(q32, ka, va, scale, m, l, o)
            m, l, o = _block_update(q32, kb, vb, scale, m, l, o)
            if t < n - 1:
                _wait(reqs_a + reqs_b)
                (ka, va), (kb, vb) = nxt_a, nxt_b
    return o / l[..., None], m + torch.log(l)


def _backward_stream(ring: _Ring, q32, do32, di, lse, k, v, scale: float,
                     step: int):
    """One stream of the backward ring: the blocks ``k``/``v`` travel
    ``step`` places a hop with float32 dK/dV accumulators; after the last
    block computes, the accumulators take one more hop home. Returns (dq
    part, dk, dv) of this rank's block."""
    n = ring.n
    dq = torch.zeros_like(q32)
    kb, vb = k, v
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for t in range(n):
        if t < n - 1:
            reqs, nxt = ring.shift([kb, vb], step)
        dq_t, dk_t, dv_t = _block_grad(q32, do32, di, lse, kb, vb, scale)
        dq, dkb, dvb = dq + dq_t, dkb + dk_t, dvb + dv_t
        if t < n - 1:
            reqs_g, (dkb, dvb) = ring.shift([dkb, dvb], step)
            _wait(reqs + reqs_g)
            kb, vb = nxt
    if n > 1:
        reqs, (dkb, dvb) = ring.shift([dkb, dvb], step)
        _wait(reqs)
    return dq, dkb, dvb


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring: _Ring, scale: float, variant: str):
        out, lse = _forward(ring, q, k, v, scale, variant)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.scale, ctx.variant = ring, scale, variant
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring, scale = ctx.ring, ctx.scale
        q32, do32 = q.float(), do.float()
        di = (do32 * out.float()).sum(dim=-1)
        if ctx.variant == "bidir":
            (ka, kb), (va, vb) = _halves(k), _halves(v)
            dqa, dka, dva = _backward_stream(ring, q32, do32, di, lse, ka, va, scale, 1)
            dqb, dkb, dvb = _backward_stream(ring, q32, do32, di, lse, kb, vb, scale, -1)
            dq = dqa + dqb
            dk, dv = torch.cat([dka, dkb], dim=-2), torch.cat([dva, dvb], dim=-2)
        else:
            dq, dk, dv = _backward_stream(ring, q32, do32, di, lse, k, v, scale, 1)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                   axis_name: str = AXIS_FRAMES, scale: Optional[float] = None,
                   variant: Optional[str] = None) -> torch.Tensor:
    """Attention of this rank's query rows against the whole sequence when
    q/k/v are split over ``axis_name`` on their sequence axis (-2): local
    q (..., Sq, D), k/v (..., Sk, D) → the local output (..., Sq, D),
    softmax(QKᵀ·scale)V over the gathered sequence up to float rounding.
    ``variant`` picks the schedule (module docstring; None reads
    :func:`default_ring_variant`). Differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    variant = variant if variant is not None else default_ring_variant()
    if variant not in RING_VARIANTS:
        raise ValueError(f"ring variant {variant!r} not in {RING_VARIANTS}")
    n = mesh.shape[axis_name]
    # a 1-wide ring or a local K/V too small to split degenerates: bidir
    # needs two nonempty sequence halves to rotate
    if variant == "bidir" and (n < 2 or k.shape[-2] < 2):
        variant = "overlap"
    ring = _Ring(mesh.group(axis_name), mesh.ranks[axis_name], mesh.coords[axis_name])
    return _RingAttention.apply(q, k, v, ring, float(scale), variant)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: Mesh, *, axis_name: str = AXIS_FRAMES,
                           seq_axis: int = -2, variant: Optional[str] = None) -> torch.Tensor:
    """:func:`ring_attention` for callers holding the GLOBAL q/k/v (the same
    on every rank): this rank's block of ``seq_axis`` goes around the ring
    and the output is all-gathered back to the global tensor."""
    if seq_axis % q.dim() != q.dim() - 2:
        q, k, v = (t.movedim(seq_axis, -2) for t in (q, k, v))
    local = [frames_slice(t, mesh, dim=-2) for t in (q, k, v)]
    out = ring_attention(*local, mesh, axis_name=axis_name, variant=variant)
    out = gather_frames(out, mesh, dim=-2, axis=axis_name)
    if seq_axis % q.dim() != q.dim() - 2:
        out = out.movedim(-2, seq_axis)
    return out


def make_ring_temporal_fn(mesh: Mesh, *, axis_name: str = AXIS_FRAMES,
                          variant: Optional[str] = None):
    """The temporal attention of the ``temporal_attention_fn`` seam
    (``models/attention.py``): local (q, k, v) of shape (B·N, H, F/sp, D),
    the frame axis split over ``axis_name`` → the ring instead of a gather.
    Uncontrolled passes only (training, the inversion, null-text, plain
    sampling); the controlled sites gather their K/V. ``variant`` pins the
    schedule (None: :func:`default_ring_variant` at call time)."""

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return ring_attention(q, k, v, mesh, axis_name=axis_name, variant=variant)

    fn.mesh, fn.variant = mesh, variant
    return fn

