"""The port of the stock Pallas flash-attention kernel and the frame-attention
dispatch, against the JAX package on the CPU.

``flash_frame_attention`` and ``flash_rect_frame_attention`` run their plain
version here (``attention_reference``); the JAX functions run the stock TPU
kernel itself in interpret mode. The stock kernel takes lengths in multiples
of 128, so the shapes here are. Tolerances: float32 1e-5 (summation order:
one softmax pass against the stock kernel's blocks of 128 keys); bfloat16
2^-7·max|ref| (both round the unnormalized probabilities to bf16 before the
product with v, against different running maxima, and round the output
once: one to two bf16 ulps at the largest output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_parity import np32, t

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b=1, f=2, h=2, n=256, d=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, f, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, n, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("wrapper", ["flash_frame_attention", "flash_rect_frame_attention"])
def test_flash_wrappers_match_the_stock_kernel(wrapper, d, dtype):
    import videop2p_tpu.ops.attention as jax_fa

    import videop2p_tpu_torch.ops.attention as fa

    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(d, d=d)
    with pltpu.force_tpu_interpret_mode(), jax.default_matmul_precision("highest"):
        want = np32(getattr(jax_fa, wrapper)(*(jnp.asarray(a, jdt) for a in (q, k, v))))
    got = getattr(fa, wrapper)(*(t(a).to(tdt) for a in (q, k, v)))
    assert got.dtype == tdt and got.shape == q.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    assert np.abs(np32(got) - want).max() <= tol


def test_attention_reference_is_exact_attention():
    """In float32 the plain version is softmax(q·kᵀ/√D)·v, chunked or not,
    with K/V broadcast over a frame axis."""
    from videop2p_tpu_torch.ops.attention import attention_reference, dense_frame_attention

    q, k, v = (t(a) for a in _qkv(1, b=2, f=3, n=300, d=24))
    want = dense_frame_attention(q, k, v)
    got = attention_reference(q, k[:, None], v[:, None], q_chunk=128)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "fused", "dense", "chunked", "flash", "flash_rect"])
@pytest.mark.parametrize("n,min_large", [(1024, 1024), (256, 64), (256, 1024)])
def test_make_frame_attention_fn_matches_jax(impl, n, min_large):
    """Every implementation name, above and below the dense cutoff, against
    JAX's dispatch on the CPU (where JAX takes chunked for the kernels and
    the module's inline einsum for None)."""
    from videop2p_tpu.ops.attention import dense_frame_attention as jax_dense
    from videop2p_tpu.ops.attention import make_frame_attention_fn as jax_make

    from videop2p_tpu_torch.ops.attention import make_frame_attention_fn

    q, k, v = _qkv(2, f=2, h=1, n=n, d=8)
    jfn = jax_make(impl, min_large_tokens=min_large, q_chunk=128) or jax_dense
    with jax.default_matmul_precision("highest"):
        want = np32(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    fn = make_frame_attention_fn(impl, min_large_tokens=min_large, q_chunk=128)
    np.testing.assert_allclose(np32(fn(t(q), t(k), t(v))), want, atol=1e-5)


def test_dispatch_refuses_what_jax_refuses():
    from videop2p_tpu.ops.attention import make_frame_attention_fn as jax_make

    from videop2p_tpu_torch.ops.attention import make_frame_attention_fn

    for make in (jax_make, make_frame_attention_fn):
        with pytest.raises(ValueError, match="unknown frame attention impl"):
            make("xformers")
    q, k, v = (t(a) for a in _qkv(3, n=1024, d=8))
    for impl in ("auto", "fused", "chunked", "flash", "flash_rect"):
        with pytest.raises(ValueError, match="rank-4"):
            make_frame_attention_fn(impl)(q[0], k, v)


def test_dispatch_routes(monkeypatch):
    """Which version each name takes on a CPU tensor: the flash wrappers
    (their plain version) at N ≥ the cutoff where JAX's flash_ok holds
    (head dim ≤ 128 or a multiple of 128), the fused one where the head dim
    is at most 128, chunked otherwise, dense below the cutoff; nothing
    launches."""
    from videop2p_tpu_torch.ops import attention as fa

    calls = []
    for name in ("dense_frame_attention", "chunked_frame_attention",
                 "fused_frame_attention", "flash_frame_attention",
                 "flash_rect_frame_attention"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    fa.reset_launch_count()
    fa.reset_flash_launch_count()
    routes = {}
    for impl in fa.FRAME_ATTENTION_IMPLS:
        for n, d in ((1024, 8), (1024, 160), (1024, 256), (256, 8)):
            calls.clear()
            fa.make_frame_attention_fn(impl)(*(t(a) for a in _qkv(4, f=1, h=1, n=n, d=d)))
            routes[impl, n, d] = calls[0]
    assert routes["flash", 1024, 8] == "flash_frame_attention"
    assert routes["flash_rect", 1024, 8] == "flash_rect_frame_attention"
    assert routes["flash", 1024, 256] == "flash_frame_attention"
    assert routes["flash_rect", 1024, 256] == "flash_rect_frame_attention"
    assert routes["chunked", 1024, 256] == "chunked_frame_attention"
    for impl in ("auto", "fused"):
        assert routes[impl, 1024, 8] == "fused_frame_attention"
        # JAX sends "fused" to its kernel only at head dims up to 128
        assert routes[impl, 1024, 160] == routes[impl, 1024, 256] == "chunked_frame_attention"
    for impl in ("flash", "flash_rect", "chunked"):
        assert routes[impl, 1024, 160] == "chunked_frame_attention"
    for impl in fa.FRAME_ATTENTION_IMPLS:
        assert routes[impl, 256, 8] == "dense_frame_attention"
    assert fa.launch_count() == fa.flash_launch_count() == 0


@pytest.mark.parametrize("impl", ["auto", "fused"])
@pytest.mark.parametrize("d", [160, 256])
def test_fused_names_above_head_dim_128_take_jax_chunked_route(monkeypatch, impl, d):
    """At a head dim above 128, "auto" and "fused" run chunked_frame_attention
    (JAX's ``d <= 128`` rule, which holds on every backend) and give JAX's
    "fused" output on the same inputs, which there is its chunked version."""
    from videop2p_tpu.ops.attention import make_frame_attention_fn as jax_make

    from videop2p_tpu_torch.ops import attention as fa

    calls = []
    for name in ("fused_frame_attention", "chunked_frame_attention"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    q, k, v = _qkv(7, f=2, h=1, n=1024, d=d)
    with jax.default_matmul_precision("highest"):
        want = np32(jax_make("fused", q_chunk=256)(*(jnp.asarray(a) for a in (q, k, v))))
    got = fa.make_frame_attention_fn(impl, q_chunk=256)(t(q), t(k), t(v))
    assert calls == ["chunked_frame_attention"]
    np.testing.assert_allclose(np32(got), want, atol=1e-5)


def test_flash_wrappers_check_their_inputs():
    from videop2p_tpu_torch.ops import attention as fa

    q, k, v = (t(a) for a in _qkv(5, n=128, d=8))
    for fn in (fa.flash_frame_attention, fa.flash_rect_frame_attention):
        with pytest.raises(ValueError):
            fn(q[0], k, v)
        with pytest.raises(ValueError):
            fn(q, k[:, :1], v)
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            fn(q.to("meta"), k.to("meta"), v.to("meta"))


def test_unet_frame_attention_config_threads_to_every_site():
    """``UNet3DConfig.frame_attention`` reaches every FrameAttention; at
    1024-token sites (32² latents) each implementation gives the dense
    result on the CPU."""
    from videop2p_tpu_torch.models.attention import FrameAttention
    from videop2p_tpu_torch.models.convert import init_weights
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig

    rng = np.random.default_rng(6)
    sample = t(rng.normal(size=(1, 2, 32, 32, 4)))
    text = t(rng.normal(size=(1, 77, 16)))
    outs = {}
    for impl in ("dense", "auto", "flash", "flash_rect"):
        unet = init_weights(UNet3DConditionModel(UNet3DConfig.tiny(frame_attention=impl)), 0)
        sites = [m for m in unet.modules() if isinstance(m, FrameAttention)]
        assert sites and all(m.attention_fn.__name__ == ("dense_frame_attention"
                             if impl == "dense" else "fn") for m in sites)
        with torch.no_grad():
            outs[impl] = np32(unet.eval()(sample, 500, text))
    for impl in ("auto", "flash", "flash_rect"):
        np.testing.assert_allclose(outs[impl], outs["dense"], atol=1e-5)
