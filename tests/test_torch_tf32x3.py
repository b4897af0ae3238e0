"""The arithmetic of the float32 attention kernels — the flash backward
(``csrc/flash_attention_bwd_tf32_sm90.cuh``) and the fused / flash forward
(``csrc/frame_attention_tf32_sm90.cuh``) — emulated on the CPU: every
product a·b runs on the TF32 tensor cores as a_hi·b_hi + a_hi·b_lo +
a_lo·b_hi, with a_hi = tf32(a) and a_lo = tf32(a − a_hi), TF32 rounding as
``cvt.rna.tf32.f32`` does it (to nearest, ties away from zero: 10 mantissa
bits), emulated with integer operations on the float32 bits. A TF32 × TF32
product is exact in float32, so each pass here is a float32 product of TF32
values.

The five products of the backward (S, dP, dV, dK, dQ) at B1 F2 H2 N256 D40
with frames folded into the query length, as flash_rect runs them, against
the same backward in float64: 3×TF32 must stay within the kernels' card
limit, 1e-4·max|ref| per gradient, with a margin of ten, and its error must
be at least 100× below one TF32 pass's.

The forward at B1 F2 H2 N256, D40 and D80, frames folded likewise: S and
each key tile's P·V in 3×TF32, the online softmax over key tiles of the
kernel's width, each tile's P·V into a fresh partial that O = O·α + partial
takes, and P·V over the σ-ordered keys (the S accumulator used as P's A
fragment, the Vᵀ tile's keys in the same order), against the JAX package's
``fused_frame_attention`` in interpret mode within 1e-5·max|ref|, one TF32
pass at least 100× worse; its residuals m and l against the port's plain
``attention_reference(..., residuals=True)``.
"""

import jax
import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)

LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value, ties away from zero (cvt.rna)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a·b on the TF32 tensor cores: one pass (hi·hi) or three (the cross
    terms first, then hi·hi), accumulated in float32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if passes == 1:
        return a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def backward(q, k, v, do, mm):
    """The kernels' backward from the forward's lse, with the matrix product
    ``mm``: p = exp2(s·scale·log2e − lse), dS = p·(dP − di)·scale, and dV,
    dK, dQ. Elementwise steps in the inputs' dtype."""
    scale = q.shape[-1] ** -0.5
    s64 = q.double() @ k.double().T * scale
    lse = (torch.logsumexp(s64, dim=-1) * LOG2E).to(q.dtype)
    o = (torch.softmax(s64, dim=-1) @ v.double()).to(q.dtype)
    di = (o * do).sum(-1)
    s = mm(q, k.T)
    p = torch.exp2(s * (scale * LOG2E) - lse[:, None])
    dp = mm(do, v.T)
    ds = p * (dp - di[:, None]) * scale
    return mm(ds, k), mm(ds.T, q), mm(p.T, do)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    b, f, h, n, d = 1, 2, 2, 256, 40
    q, do = (rng.normal(size=(b, h, f * n, d)) for _ in range(2))
    k, v = (rng.normal(size=(b, h, n, d)) for _ in range(2))
    return [torch.from_numpy(x) for x in (q, k, v, do)]


def _errors(case, passes):
    q, k, v, do = case
    errs = []
    for bh in range(q.shape[1]):
        args = [x[0, bh] for x in (q, k, v, do)]
        ref = backward(*args, lambda a, b: a @ b)
        got = backward(*(x.float() for x in args),
                       lambda a, b: matmul_tf32(a, b, passes))
        errs.append([((g.double() - r).abs().max() / r.abs().max()).item()
                     for g, r in zip(got, ref)])
    return np.max(np.array(errs), axis=0)  # dq, dk, dv: max|Δ| / max|ref|


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2),
                      1.0 + 1.5 * ulp, 3.0e-3])
    got = tf32(x)
    assert got.tolist()[:5] == [1.0, 1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF == 0).all()


def test_three_tf32_passes_keep_float32_accuracy(case):
    errs3 = _errors(case, passes=3)
    errs1 = _errors(case, passes=1)
    for name, e3, e1 in zip(("dq", "dk", "dv"), errs3, errs1):
        assert e3 <= 1e-5, (name, e3)  # the card limit 1e-4, with a margin of ten
        assert e1 >= 100 * e3, (name, e1, e3)


# --------------------------------------------------------------- forward

SIGMA = (0, 2, 4, 6, 1, 3, 5, 7)  # fragment position p holds accumulator column SIGMA[p]


def key_tile(d: int) -> int:
    """The forward kernels' keys per streamed tile at head dim d
    (frame_attention_tf32_sm90.cuh, Config::kT)."""
    return 64 if d <= 48 else 32 if d <= 96 else 16


def forward(q, k, v, mm, width):
    """The forward kernels' arithmetic for one (b0, h): q (M, D) against k,
    v (N, D), keys in tiles of ``width`` (the last one padded with masked
    keys), the matrix product ``mm``. Returns the output and the residuals m
    (natural-log units of the scaled scores) and l."""
    scale = q.shape[-1] ** -0.5
    c = scale * LOG2E
    rows, n = q.shape[0], k.shape[0]
    m = torch.full((rows,), -float("inf"))
    l = torch.zeros(rows)
    o = torch.zeros(rows, q.shape[1])
    # fragment position j of a tile holds key 8 (j // 8) + SIGMA[j % 8]
    order = [8 * (j // 8) + SIGMA[j % 8] for j in range(width)]
    for k0 in range(0, n, width):
        keys = min(width, n - k0)
        kt, vt = torch.zeros(width, k.shape[1]), torch.zeros(width, v.shape[1])
        kt[:keys], vt[:keys] = k[k0:k0 + keys], v[k0:k0 + keys]
        s = mm(q, kt.T)
        s[:, keys:] = -float("inf")
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - (m_new * c)[:, None])
        l = l * alpha + p.sum(dim=-1)
        part = mm(p[:, order], vt[order])
        o = o * alpha[:, None] + part
        m = m_new
    return o / l[:, None], m * scale, l


def _forward_case(d):
    rng = np.random.default_rng(12 + d)
    b, f, h, n = 1, 2, 2, 256
    q = rng.normal(size=(b, f, h, n, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _folded(q):
    """(B, F, H, N, D) → (B, H, F·N, D): frames folded into the query length."""
    b, f, h, n, d = q.shape
    return torch.from_numpy(q).transpose(1, 2).reshape(b, h, f * n, d)


@pytest.mark.parametrize("d", [40, 80])
def test_three_tf32_passes_forward_matches_jax_fused(d):
    from videop2p_tpu.ops.attention import fused_frame_attention as jax_fused

    q, k, v = _forward_case(d)
    with jax.default_matmul_precision("highest"):
        ref = np.array(jax.jit(lambda q, k, v: jax_fused(q, k, v, 256, True))(q, k, v))
    b, f, h, n, _ = q.shape
    ref = torch.from_numpy(ref).transpose(1, 2).reshape(b, h, f * n, d)
    qf, kt, vt = _folded(q), torch.from_numpy(k), torch.from_numpy(v)
    errs = {}
    for passes in (3, 1):
        out = torch.stack([
            forward(qf[0, i], kt[0, i], vt[0, i],
                    lambda a, b_: matmul_tf32(a, b_, passes), key_tile(d))[0]
            for i in range(h)])
        errs[passes] = ((out - ref[0]).abs().max() / ref.abs().max()).item()
    assert errs[3] <= 1e-5, errs  # the card limit 1e-4, with a margin of ten
    assert errs[1] >= 100 * errs[3], errs


@pytest.mark.parametrize("d", [40, 80])
def test_three_tf32_passes_forward_residuals_match_plain(d):
    from videop2p_tpu_torch.ops.attention import attention_reference

    q, k, v = _forward_case(d)
    qf, kt, vt = _folded(q), torch.from_numpy(k), torch.from_numpy(v)
    want_o, want_m, want_l = attention_reference(qf, kt, vt, residuals=True)
    for i in range(qf.shape[1]):
        o, m, l = forward(qf[0, i], kt[0, i], vt[0, i],
                          lambda a, b_: matmul_tf32(a, b_, 3), key_tile(d))
        assert (o - want_o[0, i]).abs().max() <= 1e-5 * want_o.abs().max()
        torch.testing.assert_close(m, want_m[0, i], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(l, want_l[0, i], rtol=1e-5, atol=0.0)
