"""The CUDA kernels of videop2p_tpu_torch against their plain versions, on
an NVIDIA card. Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false.

Gradients: the wrappers are torch.autograd.Functions on a CUDA tensor; the
fused and GroupNorm backward recompute through the plain versions, the
flash backward runs its own kernels.

This file imports neither JAX nor the JAX package, so it runs on a machine
with the card and no JAX: ``python -m pytest --noconftest
tests/test_torch_cuda.py -m cuda -q`` (tests/conftest.py configures JAX).

The plain version runs in float32 on the kernel's own inputs (bf16 inputs
upcast exactly). Tolerances (max |Δ|): float32 1e-4 for attention and 2e-4
for GroupNorm (summation order: online vs one-pass softmax, split vs single
statistics reduction); bfloat16 2^-7·max|ref|, one to two bf16 ulps at the
largest output (the kernels accumulate in f32 and round once on output, at
most half an ulp).
"""

import pytest
import torch

# one intra-op thread a test process, as tests/test_torch_parity.py sets it for
# the other port tests (that module imports JAX, which this file must not)
torch.set_num_threads(1)


def _limit(dtype, ref, f32_tol):
    return f32_tol if dtype == torch.float32 else 2.0 ** -7 * ref.abs().max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_frame_attention_kernel_matches_plain(cuda, dtype):
    from videop2p_tpu_torch.ops import attention as fa

    gen = torch.Generator(device=cuda).manual_seed(0)
    for b, f, h, n, d in ((1, 3, 2, 1000, 40), (2, 2, 2, 1024, 80), (1, 2, 1, 1100, 64)):
        q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).to(dtype).transpose(2, 3)
        k = torch.randn(b, h, n, d, generator=gen, device=cuda).to(dtype)
        v = torch.randn(b, h, n, d, generator=gen, device=cuda).to(dtype)
        before = fa.launch_count()
        out = fa.fused_frame_attention(q, k, v)
        assert fa.launch_count() == before + 1
        ref = fa.chunked_frame_attention(q.float(), k.float(), v.float())
        assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_group_norm_kernel_matches_plain(cuda, dtype):
    """The persistent GroupNorm kernel: launches per call as its plan says,
    a repeat on the same input gives the same bits, and the output is the
    plain version's at a UNet slab, ranges that straddle samples, |mean| =
    8·std (E[x²]−E[x]² cancels: E[x²] is 65 × the variance), a row that is
    not a whole number of 16-byte vectors (C 42, 6 groups), an x 4 or 2
    bytes off 16-byte alignment (both take one channel a thread), and scale
    and bias in x's dtype (as a bf16 model holds them)."""
    from videop2p_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=cuda).manual_seed(0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = ((1, 4096, 320, 32, "silu", 0.5, 0, torch.float32),
             (3, 1000, 96, 32, "none", 0.5, 0, torch.float32),
             (32, 64, 1280, 32, "silu", 0.5, 0, torch.float32),
             (2, 4096, 320, 32, "silu", 8.0, 0, torch.float32),
             (2, 1000, 42, 6, "silu", 0.5, 0, torch.float32),
             (2, 1000, 96, 32, "silu", 0.5, 1, torch.float32),
             (2, 2048, 640, 32, "silu", 0.5, 0, dtype))
    for n, rows, c, groups, act, mean, offset, param_dtype in cases:
        flat = torch.randn(n * rows * c + offset, generator=gen, device=cuda)
        x = (flat * (2 if mean < 1 else 1) + mean).to(dtype)[offset:].view(n, rows, c)
        scale = torch.randn(c, generator=gen, device=cuda).to(param_dtype)
        bias = torch.randn(c, generator=gen, device=cuda).to(param_dtype)
        plan = gn.plan(n, rows, c, dtype, sms, groups, x.data_ptr() % 16 == 0)
        assert plan.vec == (1 if c == 42 or offset else 16 // x.element_size())
        before = gn.launch_count()
        out = gn.fused_group_norm(x, scale, bias, num_groups=groups, act=act)
        assert gn.launch_count() == before + plan.launches == before + 1
        again = gn.fused_group_norm(x, scale, bias, num_groups=groups, act=act)
        assert torch.equal(out, again)
        ref = gn.group_norm_reference(x.float(), scale, bias, num_groups=groups, act=act)
        assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref, 2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wrapper", ["flash_frame_attention", "flash_rect_frame_attention"])
def test_cuda_flash_attention_kernel_matches_plain(cuda, dtype, wrapper):
    """Both wrappers of the flash kernel: ragged lengths, padded (40, 80) and
    unpadded (64) head dims, a head dim below one WMMA tile (8), and the
    head-split views FrameAttention hands the kernel."""
    from videop2p_tpu_torch.ops import attention as fa

    fn = getattr(fa, wrapper)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for b, f, h, n, d in ((1, 3, 2, 1000, 40), (2, 2, 2, 1024, 80), (1, 2, 1, 1100, 64),
                          (2, 2, 3, 70, 8)):
        q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).to(dtype).transpose(2, 3)
        k = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
        v = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
        before = fa.flash_launch_count()
        out = fn(q, k, v)
        assert fa.flash_launch_count() == before + 1
        assert out.shape == q.shape and out.dtype == dtype
        ref = fa.chunked_frame_attention(q.float(), k.float(), v.float())
        assert (out.float() - ref).abs().max().item() <= _limit(dtype, ref, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "flash_rect"])
def test_cuda_flash_dispatch_raises_on_a_head_dim_the_kernel_does_not_take(cuda, impl):
    """JAX's flash_ok sends head dim 256 to the flash wrappers; the kernel
    takes at most 128, so a CUDA tensor raises rather than running the
    plain version."""
    from videop2p_tpu_torch.ops import attention as fa

    q = torch.randn(1, 1, 1, 1024, 256, device=cuda)
    k = torch.randn(1, 1, 1024, 256, device=cuda)
    before = fa.flash_launch_count()
    with pytest.raises(ValueError, match="head dim 256"):
        fa.make_frame_attention_fn(impl)(q, k, k)
    assert fa.flash_launch_count() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
def test_cuda_attention_wrapper_gradients_match_plain(cuda, dtype, wrapper):
    """A wrapper whose inputs require grad returns an output with a grad_fn,
    and its gradients equal the plain version's: the fused kernel's backward
    recomputes through the chunked plain version (so its gradients are the
    plain version's autograd in the same dtype); the flash wrappers' runs
    the dK/dV and dQ kernels, held to the plain backward in float32 (limits
    relative to the largest gradient: float32 1e-4, bfloat16 2^-7)."""
    from videop2p_tpu_torch.ops import attention as fa

    fn = getattr(fa, wrapper)
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, f, h, n, d = 1, 3, 2, 1000, 40
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    do = torch.randn(b, f, h, n, d, generator=gen, device=cuda).to(dtype)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = fa.flash_bwd_launch_counts()
    out = fn(*leaves)
    assert out.grad_fn is not None
    out.backward(do)
    launched = {key: val - before[key] for key, val in fa.flash_bwd_launch_counts().items()}
    assert launched == ({"dkv": 0, "dq": 0} if wrapper == "fused_frame_attention"
                        else {"dkv": 1, "dq": 1})
    if wrapper == "fused_frame_attention":
        ref_leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        fa.chunked_frame_attention(*ref_leaves).backward(do)
        refs = [x.grad.float() for x in ref_leaves]
    else:
        o, m, l = fa.attention_reference(q.float(), k[:, None].float(), v[:, None].float(),
                                         residuals=True)
        dq, dk, dv = fa.attention_reference_bwd(q.float(), k[:, None].float(),
                                                v[:, None].float(), o, do.float(), m, l)
        refs = [dq, dk[:, 0], dv[:, 0]]
    for leaf, ref in zip(leaves, refs):
        tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * ref.abs().max().item()
        assert (leaf.grad.float() - ref).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_group_norm_gradients_match_plain(cuda):
    """The GroupNorm wrapper on a CUDA tensor returns an output with a
    grad_fn, and its gradients in x, scale and bias are the plain version's
    autograd (its backward recomputes through it)."""
    from videop2p_tpu_torch.ops import groupnorm as gn

    gen = torch.Generator(device=cuda).manual_seed(3)
    inputs = [torch.randn(2, 1000, 96, generator=gen, device=cuda),
              torch.randn(96, generator=gen, device=cuda),
              torch.randn(96, generator=gen, device=cuda)]
    g = torch.randn(2, 1000, 96, generator=gen, device=cuda)
    grads = []
    for fn in (gn.fused_group_norm, gn.group_norm_reference):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        out = fn(*leaves, num_groups=32, act="silu")
        assert out.grad_fn is not None
        out.backward(g)
        grads.append([x.grad for x in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
@pytest.mark.parametrize("shape", [(1, 3, 2, 1000, 40), (2, 2, 4, 1100, 64),
                                   (1, 5, 2, 333, 80), (1, 2, 2, 1024, 64),
                                   (1, 2, 2, 1024, 128)])
def test_cuda_bf16_wgmma_kernels_at_tile_edges(cuda, wrapper, shape):
    """The bf16 warpgroup kernels (csrc/frame_attention_sm90.cuh) through
    each wrapper, on the head-split views FrameAttention hands them: query
    lengths F·N and key lengths N off the query tile (192 or 128 rows) and
    the key tile (128 or 64 keys), and head dims 64 and 128 (one and two
    64-column slabs), against the plain version in float32 on the same bf16
    inputs within 2^-7·max|ref|."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).bfloat16().transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    out = getattr(fa, wrapper)(q, k, v)
    ref = fa.chunked_frame_attention(q.float(), k.float(), v.float())
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rect", [True, False])
def test_cuda_flash_residuals_match_plain(cuda, rect):
    """The bf16 flash forward's per-row residuals, the max m of the scaled
    scores and the row sum l that the backward kernels read, against
    attention_reference(..., residuals=True) on the same inputs, within 1e-4
    relative, for the flash_rect fold and the frame-batched layout."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 3, 2, 1000, 40
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).bfloat16().transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    out = fa._frame_major_out(q)
    if rect:
        q5, out5, k5, v5 = fa._rect_view(q), fa._rect_view(out), k[:, None], v[:, None]
    else:
        q5, out5 = q, out
        k5, v5 = k[:, None].expand(b, f, h, n, d), v[:, None].expand(b, f, h, n, d)
    m, l = (torch.empty(q5.shape[:4], device=cuda) for _ in range(2))
    fa._flash(q5, k5, v5, out5, m, l)
    _, m_ref, l_ref = fa.attention_reference(q5.float(), k5.float(), v5.float(),
                                             residuals=True)
    torch.testing.assert_close(m, m_ref, rtol=1e-4, atol=0)
    torch.testing.assert_close(l, l_ref, rtol=1e-4, atol=0)


def _f32_qkv(cuda, shape, seed):
    """float32 q, k, v of ``shape`` (B, F, H, N, D) as the head-split views
    FrameAttention hands the kernels."""
    b, f, h, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).transpose(1, 2)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
@pytest.mark.parametrize("shape", [(1, 3, 2, 333, 16), (1, 3, 2, 1000, 40),
                                   (1, 2, 2, 1000, 64), (1, 5, 2, 333, 80),
                                   (1, 2, 2, 1000, 128)])
def test_cuda_f32_tf32_forward_at_tile_edges_is_deterministic(cuda, wrapper, shape):
    """The float32 3×TF32 forward core (csrc/frame_attention_tf32_sm90.cuh)
    through each wrapper: key lengths off the key tile (64, 32 or 16 keys)
    and query lengths off the 128-row block, head dims 16 to 128, against
    the plain version within 1e-4·max|ref|; a second call gives the same
    bits, and each call launches the kernel once."""
    from videop2p_tpu_torch.ops import attention as fa

    q, k, v = _f32_qkv(cuda, shape, 7)
    counter = fa.launch_count if wrapper == "fused_frame_attention" else fa.flash_launch_count
    before = counter()
    out = getattr(fa, wrapper)(q, k, v)
    again = getattr(fa, wrapper)(q, k, v)
    assert counter() == before + 2
    ref = fa.chunked_frame_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
def test_cuda_f32_forward_takes_any_strides(cuda, wrapper):
    """float32 q, k, v views the bf16 TMA path would refuse — a base 4 bytes
    off 16 and row strides that are not multiples of 16 bytes — run, and
    match the plain version within 1e-4·max|ref|: the float32 core reads
    every operand at any strides with a contiguous last dimension."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 2, 2, 1000, 40
    gen = torch.Generator(device=cuda).manual_seed(8)
    wide = torch.randn(b * f * n * h * (d + 3) + 1, generator=gen, device=cuda)
    q = wide[1:].view(b, f, n, h, d + 3)[..., :d].transpose(2, 3)
    kv = torch.randn(2, b, n, h, d + 1, generator=gen, device=cuda)[..., 1:]
    k, v = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
    assert all(fa._tma_fault(t) is not None for t in (q, k, v))
    out = getattr(fa, wrapper)(q, k, v)
    ref = fa.chunked_frame_attention(q, k, v)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_f32_forward_rows_do_not_depend_on_the_batch(cuda, wrapper, d):
    """Row r of a B = 1 call equals row r of the same inputs inside a B = 3
    call, bit for bit: a row's arithmetic does not depend on where its block
    lies (the cached edit's src_err == 0.0 rests on it)."""
    from videop2p_tpu_torch.ops import attention as fa

    q, k, v = _f32_qkv(cuda, (3, 2, 2, 1000, d), 9)
    fn = getattr(fa, wrapper)
    whole = fn(q, k, v)
    for i in range(3):
        assert torch.equal(fn(q[i:i + 1], k[i:i + 1], v[i:i + 1])[0], whole[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("rect", [True, False])
@pytest.mark.parametrize("d", [40, 80])
def test_cuda_f32_flash_residuals_match_plain(cuda, rect, d):
    """The float32 flash forward's output and per-row residuals m and l (the
    float32 backward reads them) against attention_reference(...,
    residuals=True): the output within 1e-4·max|ref|, m and l within 1e-5
    relative."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n = 1, 3, 2, 1000
    q, k, v = _f32_qkv(cuda, (b, f, h, n, d), 10)
    out = fa._frame_major_out(q)
    if rect:
        q5, out5, k5, v5 = fa._rect_view(q), fa._rect_view(out), k[:, None], v[:, None]
    else:
        q5, out5 = q, out
        k5, v5 = k[:, None].expand(b, f, h, n, d), v[:, None].expand(b, f, h, n, d)
    m, l = (torch.empty(q5.shape[:4], device=cuda) for _ in range(2))
    fa._flash(q5, k5, v5, out5, m, l)
    o_ref, m_ref, l_ref = fa.attention_reference(q5, k5, v5, residuals=True)
    assert (out5 - o_ref).abs().max().item() <= 1e-4 * o_ref.abs().max().item()
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["fused_frame_attention", "flash_frame_attention",
                                     "flash_rect_frame_attention"])
def test_cuda_bf16_kernels_refuse_what_tma_cannot_read(cuda, wrapper):
    """A bf16 q with a head-dim stride other than 1, or whose base address
    is 2 bytes off a 16-byte boundary, raises a ValueError naming the fault
    and launches nothing: no fallback to another kernel, no silent copy."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 2, 2, 1024, 40
    k = torch.randn(b, h, n, d, device=cuda).bfloat16()
    wide = torch.randn(b, f, n, h, 2 * d, device=cuda).bfloat16()
    flat = torch.randn(b * f * n * h * d + 1, device=cuda).bfloat16()
    cases = ((wide[..., ::2].transpose(2, 3), "contiguous last dimension"),
             (flat[1:].view(b, f, n, h, d).transpose(2, 3), "aligned to 16 bytes"))
    for q, message in cases:
        before = (fa.launch_count(), fa.flash_launch_count())
        with pytest.raises(ValueError, match=message):
            getattr(fa, wrapper)(q, k, k)
        assert (fa.launch_count(), fa.flash_launch_count()) == before


def _flash_bwd_case(cuda, wrapper, shape, seed, dtype=torch.bfloat16):
    """Inputs of one flash backward (the head-split views FrameAttention
    hands the kernels) and a function that runs the backward through the
    wrapper, asserting one dK/dV and one dQ launch, and returns (dq, dk,
    dv)."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    do = torch.randn(b, f, h, n, d, generator=gen, device=cuda).to(dtype)

    def grads():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        before = fa.flash_bwd_launch_counts()
        getattr(fa, wrapper)(*leaves).backward(do)
        after = fa.flash_bwd_launch_counts()
        assert {key: after[key] - before[key] for key in after} == {"dkv": 1, "dq": 1}
        return [x.grad for x in leaves]

    return q, k, v, do, grads


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["flash_frame_attention", "flash_rect_frame_attention"])
@pytest.mark.parametrize("shape", [(1, 3, 2, 1000, 40), (2, 2, 4, 1100, 64),
                                   (1, 5, 2, 333, 80), (1, 2, 2, 1024, 128),
                                   (1, 8, 8, 1024, 80)])
def test_cuda_bf16_flash_backward_at_tile_edges_is_deterministic(cuda, wrapper, shape):
    """The bf16 warpgroup backward (csrc/flash_attention_bwd_sm90.cuh)
    through each flash wrapper: query lengths off its query tiles (64 or 32
    rows) and key lengths off its 128-key blocks and 64- or 32-key tiles,
    head dims 40, 64, 80 (one and two 64-column slabs) and 128, and shapes
    whose dK/dV query walk splits over a cluster of 2 to 8 CTAs (all but
    (2, 2, 4, 1100, 64) on a 132-SM card). dq, dk, dv against
    attention_reference_bwd in float32 on the same bf16 inputs within
    2^-7·max|ref|, and a second backward on the same inputs gives the same
    bits (fixed summation order, no atomics)."""
    from videop2p_tpu_torch.ops import attention as fa

    q, k, v, do, grads = _flash_bwd_case(cuda, wrapper, shape, seed=6)
    first, second = grads(), grads()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    o, m, l = fa.attention_reference(q.float(), k[:, None].float(), v[:, None].float(),
                                     residuals=True)
    refs = fa.attention_reference_bwd(q.float(), k[:, None].float(), v[:, None].float(), o,
                                      do.float(), m, l)
    for got, ref in zip(first, (refs[0], refs[1][:, 0], refs[2][:, 0])):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert (got.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("grad", ["sum", "slice of a wider tensor"])
def test_cuda_bf16_flash_backward_takes_a_grad_out_tma_cannot_read(cuda, grad):
    """autograd chooses the output gradient's layout: ``out.sum()`` hands
    the backward an expanded scalar (every stride 0), and a slice of a
    wider tensor has a token stride of 88 bytes. The backward copies either
    into a layout its TMA maps read and matches the plain backward on the
    same gradient."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 3, 2, 1000, 40
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).bfloat16().transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).bfloat16().transpose(1, 2)
    wide = torch.randn(b, f, h, n, d + 4, generator=gen, device=cuda).bfloat16()
    do = torch.ones(b, f, h, n, d, device=cuda).bfloat16() if grad == "sum" else wide[..., :d]
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_rect_frame_attention(*leaves)
    if grad == "sum":
        out.sum().backward()
    else:
        out.backward(do)
    o, m, l = fa.attention_reference(q.float(), k[:, None].float(), v[:, None].float(),
                                     residuals=True)
    refs = fa.attention_reference_bwd(q.float(), k[:, None].float(), v[:, None].float(), o,
                                      do.float(), m, l)
    for leaf, ref in zip(leaves, (refs[0], refs[1][:, 0], refs[2][:, 0])):
        assert (leaf.grad.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["flash_frame_attention", "flash_rect_frame_attention"])
@pytest.mark.parametrize("shape", [(1, 3, 2, 1000, 40), (2, 2, 4, 1100, 64),
                                   (1, 5, 2, 333, 80), (1, 2, 2, 1024, 128),
                                   (1, 8, 8, 1024, 80)])
def test_cuda_f32_flash_backward_at_tile_edges_is_deterministic(cuda, wrapper, shape):
    """The float32 warpgroup backward on the TF32 tensor cores
    (csrc/flash_attention_bwd_tf32_sm90.cuh, 3×TF32 products) through each
    flash wrapper, at the bf16 test's shapes: query and key lengths off its
    32-, 16- and 8-row tiles and its 64- and 128-row blocks, head dims 40,
    64 (the two warpgroups own 64 rows each), 80 and 128 (they share 64
    rows and hand over their sums). dq, dk, dv against
    attention_reference_bwd on the same inputs within 1e-4·max|ref|, and a
    second backward on the same inputs gives the same bits."""
    from videop2p_tpu_torch.ops import attention as fa

    q, k, v, do, grads = _flash_bwd_case(cuda, wrapper, shape, seed=8, dtype=torch.float32)
    first, second = grads(), grads()
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    o, m, l = fa.attention_reference(q, k[:, None], v[:, None], residuals=True)
    refs = fa.attention_reference_bwd(q, k[:, None], v[:, None], o, do, m, l)
    for got, ref in zip(first, (refs[0], refs[1][:, 0], refs[2][:, 0])):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("grad", ["sum", "odd base offset"])
def test_cuda_f32_flash_backward_takes_any_grad_out(cuda, grad):
    """The float32 backward reads the output gradient with plain loads: an
    expanded scalar from ``out.sum()`` (every stride 0) and a view one
    element off an allocation (a base address 4 bytes off 16) both run and
    match the plain backward on the same gradient."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 3, 2, 1000, 40
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).transpose(1, 2)
    flat = torch.randn(b * f * h * n * d + 1, generator=gen, device=cuda)
    do = torch.ones(b, f, h, n, d, device=cuda) if grad == "sum" else \
        flat[1:].view(b, f, h, n, d)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_rect_frame_attention(*leaves)
    if grad == "sum":
        out.sum().backward()
    else:
        out.backward(do)
    o, m, l = fa.attention_reference(q, k[:, None], v[:, None], residuals=True)
    refs = fa.attention_reference_bwd(q, k[:, None], v[:, None], o, do, m, l)
    for leaf, ref in zip(leaves, (refs[0], refs[1][:, 0], refs[2][:, 0])):
        assert (leaf.grad - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_auto_above_head_dim_128_runs_chunked(cuda, dtype):
    """"auto" at (1, 8, 8, 1024, 160), a 1024² input's 32² level: the
    chunked version's output, bit for bit, and no fused launch (JAX's
    dispatch sends head dims above 128 to chunked attention)."""
    from videop2p_tpu_torch.ops import attention as fa

    b, f, h, n, d = 1, 8, 8, 1024, 160
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn(b, f, n, h, d, generator=gen, device=cuda).to(dtype).transpose(2, 3)
    k = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn(b, n, h, d, generator=gen, device=cuda).to(dtype).transpose(1, 2)
    before = fa.launch_count()
    out = fa.make_frame_attention_fn("auto")(q, k, v)
    assert fa.launch_count() == before
    assert torch.equal(out, fa.chunked_frame_attention(q, k, v))
