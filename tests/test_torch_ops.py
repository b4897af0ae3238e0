"""The port's kernel modules (videop2p_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU, and their plain
references.

On the CPU each wrapper runs its plain version, so these tests hold the
plain versions (the oracle of the CUDA kernels) to the TPU kernels' math.
Tolerances, float32: 1e-5 absolute for attention (same math, different
summation order over ≤1024 keys) and 2e-5 for GroupNorm (the order of the
f32 statistics sums over up to 256×64 elements); bfloat16 inputs: both
packages compute in f32 and round once to bf16, so an element may differ by
one bf16 ulp, at most 2^-7 of its value (rtol 2^-7, atol 1e-6).

The CUDA kernels themselves are held to the plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t


def _qkv(seed, b=1, f=2, h=2, n=256, d=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, f, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, n, d)).astype(np.float32))


# --------------------------------------------------------------- attention


def test_plain_frame_attention_matches_jax_fused_kernel():
    """The wrapper's CPU path (chunked plain version, 2 chunks of 512
    queries) against the Pallas kernel in interpret mode."""
    from videop2p_tpu.ops.attention import fused_frame_attention as jax_fused

    from videop2p_tpu_torch.ops.attention import fused_frame_attention

    q, k, v = _qkv(0, f=2, h=1, n=1024, d=8)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda q, k, v: jax_fused(q, k, v, 256, True))(q, k, v)
    got = fused_frame_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-5)


@pytest.mark.parametrize("n", [64, 96])
def test_dense_frame_attention_matches_jax(n):
    from videop2p_tpu.ops.attention import dense_frame_attention as jax_dense

    from videop2p_tpu_torch.ops.attention import (
        chunked_frame_attention,
        dense_frame_attention,
    )

    q, k, v = _qkv(1, b=2, f=3, h=2, n=n, d=8)
    with jax.default_matmul_precision("highest"):
        want = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(np32(dense_frame_attention(t(q), t(k), t(v))),
                               np32(want), atol=1e-5)
    # chunks that do not split N evenly fall back to dense, as in JAX
    np.testing.assert_allclose(
        np32(chunked_frame_attention(t(q), t(k), t(v), q_chunk=64)), np32(want),
        atol=1e-5)


def test_chunked_equals_dense():
    from videop2p_tpu_torch.ops.attention import (
        chunked_frame_attention,
        dense_frame_attention,
    )

    q, k, v = _qkv(2, n=512)
    np.testing.assert_allclose(
        np32(chunked_frame_attention(t(q), t(k), t(v), q_chunk=128)),
        np32(dense_frame_attention(t(q), t(k), t(v))), atol=1e-6)


def test_dispatch_rule(monkeypatch):
    """N < 1024 → dense on every device; N ≥ 1024 → the kernel wrapper, which
    on a CPU tensor runs the chunked plain version and launches nothing."""
    from videop2p_tpu_torch.ops import attention as fa

    calls = []
    for name in ("dense_frame_attention", "chunked_frame_attention"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    fa.reset_launch_count()
    small = [t(a) for a in _qkv(3, n=256)]
    fa.frame_attention(*small)
    assert calls == ["dense_frame_attention"]
    calls.clear()
    large = [t(a) for a in _qkv(3, f=1, h=1, n=1024, d=4)]
    out = fa.frame_attention(*large)
    assert calls[0] == "chunked_frame_attention"
    assert out.shape == large[0].shape
    assert fa.launch_count() == 0


def test_attention_wrapper_rejects_bad_shapes():
    from videop2p_tpu_torch.ops.attention import fused_frame_attention

    q, k, v = (t(a) for a in _qkv(4))
    with pytest.raises(ValueError):
        fused_frame_attention(q[0], k, v)
    with pytest.raises(ValueError):
        fused_frame_attention(q, k[:, :1], v)


# --------------------------------------------------------------- groupnorm


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_plain_group_norm_matches_jax_fused_kernel(eps, act):
    from videop2p_tpu.ops.groupnorm import fused_group_norm as jax_fused

    from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 256, 64)) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=64) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    want = jax_fused(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                     num_groups=8, eps=eps, act=act, interpret=True)
    got = fused_group_norm(t(x), t(scale), t(bias), num_groups=8, eps=eps, act=act)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_group_norm_matches_jax_reference(dtype):
    """Rows that the TPU kernel's gate refuses (not a multiple of 256): the
    port has no gate, and its plain version is ``group_norm_reference``."""
    from videop2p_tpu.ops.groupnorm import group_norm_reference as jax_ref

    from videop2p_tpu_torch.ops.groupnorm import group_norm_reference

    rng = np.random.default_rng(6)
    x = (rng.normal(size=(3, 100, 96)) * 3).astype(np.float32)
    scale = rng.normal(size=96).astype(np.float32)
    bias = rng.normal(size=96).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = t(x).to(getattr(torch, dtype))
    want = jax_ref(jx, jnp.asarray(scale), jnp.asarray(bias), num_groups=32, act="silu")
    got = group_norm_reference(tx, t(scale), t(bias), num_groups=32, act="silu")
    assert got.dtype == tx.dtype
    if dtype == "float32":
        np.testing.assert_allclose(np32(got), np32(want), atol=2e-5)
    else:
        np.testing.assert_allclose(np32(got), np32(want), rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("frame_pooled", [True, False])
def test_tpu_group_norm_module_matches_jax(frame_pooled):
    """TpuGroupNorm on (B, F, H, W, C): statistics pooled over frames, or per
    frame when the frames are folded into the batch first."""
    from videop2p_tpu.models.layers import TpuGroupNorm as JaxGN

    from videop2p_tpu_torch.models.layers import TpuGroupNorm

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 4, 8, 8, 16)) + 1).astype(np.float32)
    if not frame_pooled:
        x = x.reshape(8, 8, 8, 16)
    scale = (rng.normal(size=16) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=16) * 0.1).astype(np.float32)
    jmod = JaxGN(num_groups=4, act="silu", impl="interpret")
    want = jmod.apply({"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
                      jnp.asarray(x))
    port = TpuGroupNorm(16, 4, act="silu")
    port.load_state_dict({"weight": t(scale), "bias": t(bias)})
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-5)


def test_group_norm_wrapper_checks():
    from videop2p_tpu_torch.ops import groupnorm as gn

    x = torch.randn(2, 10, 8)
    ones, zeros = torch.ones(8), torch.zeros(8)
    gn.reset_launch_count()
    np.testing.assert_array_equal(
        np32(gn.fused_group_norm(x, ones, zeros, num_groups=4)),
        np32(gn.group_norm_reference(x, ones, zeros, num_groups=4)))
    assert gn.launch_count() == 0
    with pytest.raises(ValueError):
        gn.fused_group_norm(x, ones, zeros, num_groups=4, act="gelu")
    with pytest.raises(ValueError):
        gn.fused_group_norm(x, ones, zeros, num_groups=3)
    with pytest.raises(ValueError):
        gn.fused_group_norm(x[0], ones, zeros, num_groups=4)


# The 61 GroupNorm sites of one UNet forward at 512² (64² latents, 8 frames):
# (kind, latent side, channels, sites). Resnet norms and conv_norm_out pool
# the frames (N = B, rows = 8·side²); transformer-entry norms are per frame
# (N = 8·B, rows = side²).
_UNET_GN_SITES = (
    ("resnet", 64, 320, 8), ("resnet", 64, 640, 2), ("resnet", 64, 960, 1),
    ("resnet", 32, 320, 1), ("resnet", 32, 640, 6), ("resnet", 32, 960, 1),
    ("resnet", 32, 1280, 1), ("resnet", 32, 1920, 1),
    ("resnet", 16, 640, 1), ("resnet", 16, 1280, 6), ("resnet", 16, 1920, 1),
    ("resnet", 16, 2560, 2),
    ("resnet", 8, 1280, 11), ("resnet", 8, 2560, 3),
    ("transformer", 64, 320, 5), ("transformer", 32, 640, 5),
    ("transformer", 16, 1280, 5), ("transformer", 8, 1280, 1),
)
assert sum(site[-1] for site in _UNET_GN_SITES) == 61
_H100_SMS = 132


def _site_shapes(batch):
    return sorted({(batch, 8 * side * side, c) if kind == "resnet" else (8 * batch, side * side, c)
                   for kind, side, c, _ in _UNET_GN_SITES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shapes", [_site_shapes(1), _site_shapes(2), _site_shapes(3),
                                    _site_shapes(4), [(2, 1000, 96), (2, 7, 64)]],
                         ids=["B1", "B2", "B3", "B4", "ragged"])
def test_plan_covers_every_row_once(dtype, shapes):
    """The GroupNorm kernel's geometry (``plan``) at every UNet site's slab
    on an H100's 132 SMs: every flat row in exactly one block's range, at
    most one block per SM, a block's threads tiling its columns and its
    shared memory within the SM's 232,448 bytes, the scratch exactly what
    the kernel writes and phase 2 reads (one sum and sum of squares per
    sample, slot of a block that holds it, and group), and the rows kept on
    chip summing to min(rows, capacity)."""
    from videop2p_tpu_torch.ops.groupnorm import SMEM_LIMIT, plan

    for n, rows, c in shapes:
        p = plan(n, rows, c, dtype, _H100_SMS)
        itemsize = torch.finfo(dtype).bits // 8
        total, k, groups = n * rows, p.samples_per_block, 32
        starts = [p.row_start(b, total) for b in range(p.grid + 1)]
        assert starts[0] == 0 and starts[-1] == total
        covered = np.zeros(total, np.int64)
        for b in range(p.grid):
            covered[starts[b]:starts[b + 1]] += 1
        assert (covered == 1).all()
        assert p.grid <= _H100_SMS and p.launches == 1
        assert 32 <= p.threads <= 512 and p.threads % 32 == 0
        assert p.vec * itemsize == 16 and c % p.vec == 0  # 16-byte accesses
        cols = c // p.vec
        if p.colsets == 1:
            assert p.lanes * cols <= p.threads
        else:
            assert p.lanes == 1 and p.colsets * p.threads >= cols
        fixed = (2 * p.lanes * c + 2 * k * groups + 2 * (p.threads // 32) * groups) * 4
        slab = -(-p.smem_rows * c * itemsize // 16) * 16
        assert slab + fixed <= p.smem_bytes <= SMEM_LIMIT
        assert -(-p.capacity_rows * c * itemsize // 16) * 16 + fixed <= SMEM_LIMIT
        assert -(-(p.capacity_rows + 1) * c * itemsize // 16) * 16 + fixed > SMEM_LIMIT
        # what the kernel writes: one (sum, sum of squares) per (sample, slot of
        # the block among the blocks that hold it, group); an empty range that
        # starts inside a sample writes zeros to its slot; phase 2 reads slots
        # 0 … nb−1 of every sample
        def block_of(r):
            return ((r + 1) * p.grid - 1) // total

        written, most = set(), 0
        for b in range(p.grid):
            r0, r1 = starts[b], starts[b + 1]
            touched = range(r0 // rows, (r1 - 1) // rows + 1) if r1 > r0 else (
                [r0 // rows] if r0 < total and r0 % rows else [])
            most = max(most, len(touched) if r1 > r0 else 0)
            for m in touched:
                slot = b - block_of(m * rows)
                assert 0 <= slot < p.blocks_per_sample and (m, slot) not in written
                written.add((m, slot))
        assert most == k
        read = {(m, slot) for m in range(n)
                for slot in range(block_of((m + 1) * rows - 1) - block_of(m * rows) + 1)}
        assert read == written
        assert max(slot for _, slot in read) == p.blocks_per_sample - 1
        assert p.scratch_bytes == 16 + n * p.blocks_per_sample * groups * 2 * 4
        on_chip = sum(min(starts[b + 1] - starts[b], p.smem_rows) for b in range(p.grid))
        assert on_chip == min(total, p.grid * p.capacity_rows)


def test_plan_refuses_what_the_kernel_cannot_take():
    """A shape whose per-lane sums and statistics alone overflow a block's
    shared memory raises with the reason; a row that is not a whole number
    of 16-byte vectors, or an x off 16 bytes, takes one channel a thread."""
    from videop2p_tpu_torch.ops.groupnorm import plan

    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 4, 32 * 1000, torch.float32, _H100_SMS)
    with pytest.raises(ValueError, match="groups"):
        plan(1, 4, 100, torch.float32, _H100_SMS)
    assert plan(2, 1000, 42, torch.bfloat16, _H100_SMS, num_groups=6).vec == 1
    assert plan(2, 1000, 42, torch.float32, _H100_SMS, num_groups=6).vec == 1
    assert plan(2, 1000, 96, torch.float32, _H100_SMS, aligned=False).vec == 1
    assert plan(2, 1000, 96, torch.float32, _H100_SMS).vec == 4


def _fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _warp_butterfly(v):
    """A warp's xor-shuffle sum of 32 f32 values, as lane 0 ends it."""
    lanes = np.arange(32)
    for m in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ m]).astype(np.float32)
    return v[0]


def _emulate_group_norm_kernel(x, scale, bias, groups, eps, act, p):
    """csrc/groupnorm.cu's arithmetic in numpy f32, in its order: per block
    of ``p`` and sample touched, each (row lane, channel) sums its rows in
    order (the rows streamed first, then the rows kept on chip; x² by fma),
    then per group the channels' lane-strided sums over row lanes and a warp
    butterfly; per (sample, group) warp w sums the slots w, w + warps, … of
    the blocks that hold the sample, then the warps in order; then a =
    rsqrt(var + eps)·scale, c = bias − mean·a, y = fma(x, a, c), SiLU."""
    n, rows, c = x.shape
    total = n * rows
    xf = x.reshape(total, c).astype(np.float32)
    lanes, cpg, warps = p.lanes, c // groups, p.threads // 32
    starts = [p.row_start(b, total) for b in range(p.grid + 1)]

    def block_of(r):
        return ((r + 1) * p.grid - 1) // total

    partial = np.zeros((n, p.blocks_per_sample, groups, 2), np.float32)
    for b in range(p.grid):
        r0, r1 = starts[b], starts[b + 1]
        on_end = r0 + min(r1 - r0, p.smem_rows)
        for nn in range(r0 // rows, (r1 - 1) // rows + 1 if r1 > r0 else 0):
            s0, s1 = max(r0, nn * rows), min(r1, (nn + 1) * rows)
            acc = np.zeros((2, lanes, c), np.float32)
            for lo, hi in ((max(s0, on_end), s1), (s0, min(s1, on_end))):
                for m in range(0, max(0, hi - lo), lanes):
                    r = lo + m + np.arange(lanes)
                    ok = r < hi
                    v = xf[r[ok]]
                    acc[0, ok] = acc[0, ok] + v
                    acc[1, ok] = _fma32(v, v, acc[1, ok])
            for g in range(groups):
                warp = np.zeros((2, 32), np.float32)
                for cc in range(cpg):
                    for lane in range(lanes):
                        warp[:, cc % 32] = warp[:, cc % 32] + acc[:, lane, g * cpg + cc]
                partial[nn, b - block_of(nn * rows), g] = [_warp_butterfly(w) for w in warp]
    cnt = np.float32(rows) * np.float32(cpg)
    y = np.empty_like(xf)
    for nn in range(n):
        nb = block_of((nn + 1) * rows - 1) - block_of(nn * rows) + 1
        per_warp = np.zeros((warps, groups, 2), np.float32)
        for slot in range(nb):
            per_warp[slot % warps] = per_warp[slot % warps] + partial[nn, slot]
        ss, qq = np.zeros(groups, np.float32), np.zeros(groups, np.float32)
        for w in range(warps):
            ss, qq = ss + per_warp[w, :, 0], qq + per_warp[w, :, 1]
        mean = ss / cnt
        var = qq / cnt - mean * mean
        rstd = (1.0 / np.sqrt(var.astype(np.float64) + eps)).astype(np.float32)
        a = np.repeat(rstd, cpg) * scale
        shift = bias - np.repeat(mean, cpg) * a
        seg = _fma32(xf[nn * rows:(nn + 1) * rows], a, shift)
        if act == "silu":
            seg = (seg / (1.0 + np.exp(-seg.astype(np.float64)))).astype(np.float32)
        y[nn * rows:(nn + 1) * rows] = seg
    return y.reshape(n, rows, c)


@pytest.mark.parametrize("shape,groups,mean,sms", [
    ((2, 256, 64), 8, 0.5, 132),     # a block or two a sample
    ((3, 512, 96), 32, 0.5, 132),    # ranges that straddle samples (K = 2)
    ((2, 1024, 320), 32, 0.5, 132),  # SD-1.5's narrowest width
    ((2, 1024, 320), 32, 0.5, 2),    # ranges past shared memory: rows re-read
    ((2, 512, 64), 8, 30.0, 132),    # |mean| = 30·std: E[x²]−E[x]² cancels
    ((2, 2048, 64), 8, 30.0, 2),
])
def test_group_norm_kernel_summation_order_matches_jax(shape, groups, mean, sms):
    """The CUDA kernel's summation order (emulated in numpy f32 on its
    ``plan``) against JAX's fused_group_norm (interpret mode). Tolerance:
    the file's 2e-5 times the cancellation factor E[x²]/Var[x] of the data
    (1.06 at mean 0.5, std 2; 901 at mean 30, std 1), since the variance is
    E[x²]−E[x]² in f32 in both and its rounding error grows with E[x²]."""
    from videop2p_tpu.ops.groupnorm import fused_group_norm as jax_fused

    from videop2p_tpu_torch.ops.groupnorm import plan

    std = 2.0 if mean < 1 else 1.0
    rng = np.random.default_rng(8)
    x = (rng.normal(size=shape) * std + mean).astype(np.float32)
    scale = (rng.normal(size=shape[2]) * 0.2 + 1).astype(np.float32)
    bias = (rng.normal(size=shape[2]) * 0.1).astype(np.float32)
    p = plan(*shape, torch.float32, sms, groups)
    if sms == 2:
        assert p.smem_rows < shape[0] * shape[1] // 2  # some rows are re-read
    got = _emulate_group_norm_kernel(x, scale, bias, groups, 1e-5, "silu", p)
    want = jax_fused(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                     num_groups=groups, eps=1e-5, act="silu", interpret=True)
    tol = 2e-5 * (1.0 + mean * mean / (std * std))
    np.testing.assert_allclose(got, np32(want), atol=tol)

