"""The arithmetic of the float32 flash backward kernels
(``csrc/flash_attention_bwd_tf32_sm90.cuh``), emulated on the CPU: every
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
"""

import numpy as np
import pytest
import torch

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
