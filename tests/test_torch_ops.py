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


def test_stats_chunks_cover_every_row():
    from videop2p_tpu_torch.ops.groupnorm import stats_chunks

    for n, rows in ((1, 8 * 4096), (3, 8 * 4096), (24, 4096), (2, 7), (600, 64)):
        chunks, per = stats_chunks(n, rows)
        assert chunks * per >= rows > (chunks - 1) * per
        assert n * chunks >= min(512, n * rows) // 2
