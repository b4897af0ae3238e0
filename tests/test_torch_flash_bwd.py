"""The backward passes of the port's kernels against the JAX package on the CPU.

On the CPU every wrapper runs its plain version, and autograd differentiates it.
The JAX side runs the Pallas kernels in interpret mode: ``jax.vjp`` of
``flash_frame_attention`` / ``flash_rect_frame_attention`` runs the stock
backward kernels themselves (``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``), those of ``fused_frame_attention`` and
``fused_group_norm`` their ``custom_vjp`` rules, which recompute through the
plain JAX versions. The stock kernel takes lengths in multiples of 128, so
the flash shapes here are.

Tolerances (max |Δ|): float32 1e-5·max(1, max|ref|) (summation order only;
a probe read ~2e-6 against dense attention; GroupNorm's scale and bias
gradients are sums over a thousand rows, of magnitude ~50, hence relative
above 1); bfloat16 2^-7·max|ref| (both sides round p and dS to bf16 before
their products, against maxima and sums that differ in the last bits, and
round each gradient once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_parity import np32, t

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WRAPPERS = ["flash_frame_attention", "flash_rect_frame_attention"]


def _inputs(seed, b=1, f=2, h=2, n=256, d=40):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, f, h, n, d), (b, h, n, d), (b, h, n, d), (b, f, h, n, d)))


def _jax_vjp(fn, q, k, v, do, jdt):
    """Output and (dq, dk, dv) of ``fn`` at float32 matmul precision."""
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
        return (np32(out),) + tuple(np32(g) for g in vjp(jnp.asarray(do, jdt)))


def _torch_grads(fn, q, k, v, do, tdt):
    leaves = [t(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(t(do).to(tdt))
    return (np32(out),) + tuple(np32(x.grad) for x in leaves)


def _close(got, want, dtype):
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        tol = 1e-5 * max(1.0, scale) if dtype == "float32" else 2.0 ** -7 * scale
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol, (np.abs(g - w).max(), tol)


def _fold(x):
    """(B, F, H, N, D) → (B, H, F·N, D), flash_rect's layout."""
    b, f, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, h, f * n, d)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_flash_wrapper_gradients_match_the_stock_backward(wrapper, dtype):
    """Autograd through each flash wrapper (its plain version here) against
    jax.vjp of the JAX wrapper, which runs the stock backward kernels."""
    import videop2p_tpu.ops.attention as jax_fa

    import videop2p_tpu_torch.ops.attention as fa

    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(3)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_vjp(getattr(jax_fa, wrapper), q, k, v, do, jdt)
    got = _torch_grads(getattr(fa, wrapper), q, k, v, do, tdt)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_attention_reference_bwd_matches_the_stock_backward(wrapper, dtype):
    """The plain backward, from the plain forward's output and residuals, in
    each wrapper's layout: K/V broadcast over the frames (dK/dV summed over
    them) or frames folded into the query length."""
    import videop2p_tpu.ops.attention as jax_fa

    from videop2p_tpu_torch.ops.attention import attention_reference, attention_reference_bwd

    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(4, d=80)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_vjp(getattr(jax_fa, wrapper), q, k, v, do, jdt)
    qt, kt, vt, dot = (t(a).to(tdt) for a in (q, k, v, do))
    if wrapper == "flash_frame_attention":
        kt, vt = kt[:, None], vt[:, None]
    else:
        qt, dot = _fold(qt), _fold(dot)
    o, m, l = attention_reference(qt, kt, vt, q_chunk=96, residuals=True)
    assert m.dtype == l.dtype == torch.float32 and m.shape == qt.shape[:-1]
    dq, dk, dv = attention_reference_bwd(qt, kt, vt, o, dot, m, l, q_chunk=96)
    assert dq.dtype == dk.dtype == dv.dtype == tdt
    if wrapper == "flash_frame_attention":
        dk, dv = dk[:, 0], dv[:, 0]
    else:
        b, f, h, n, d = q.shape
        dq = dq.reshape(b, h, f, n, d).transpose(1, 2)
    _close([np32(x) for x in (dq, dk, dv)], want[1:], dtype)


def test_attention_reference_bwd_is_the_gradient_of_attention_reference():
    """In float32 (no rounding points) the plain backward is autograd's
    gradient of the plain forward, ragged lengths and chunking included."""
    from videop2p_tpu_torch.ops.attention import attention_reference, attention_reference_bwd

    rng = np.random.default_rng(5)
    q, do = (t(rng.normal(size=(2, 3, 2, 150, 24))) for _ in range(2))
    k, v = (t(rng.normal(size=(2, 1, 2, 70, 24))) for _ in range(2))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = attention_reference(*leaves, q_chunk=64)
    out.backward(do)
    o, m, l = attention_reference(q, k, v, q_chunk=64, residuals=True)
    torch.testing.assert_close(o, out.detach(), rtol=0, atol=0)
    got = attention_reference_bwd(q, k, v, o, do, m, l, q_chunk=64)
    for g, leaf in zip(got, leaves):
        assert g.shape == leaf.shape
        torch.testing.assert_close(g, leaf.grad, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 2, 512, 40), (1, 2, 1, 1024, 80)])
def test_fused_frame_attention_gradients_match_jax(shape):
    """The fused wrapper's gradients against jax.vjp of the Pallas kernel in
    interpret mode, whose rule recomputes through chunked attention."""
    import videop2p_tpu.ops.attention as jax_fa

    from videop2p_tpu_torch.ops.attention import fused_frame_attention

    q, k, v, do = _inputs(6, *shape)
    want = _jax_vjp(lambda a, b, c: jax_fa.fused_frame_attention(a, b, c, 256, True),
                    q, k, v, do, jnp.float32)
    got = _torch_grads(fused_frame_attention, q, k, v, do, torch.float32)
    _close(got, want, "float32")


@pytest.mark.parametrize("act", ["none", "silu"])
def test_fused_group_norm_gradients_match_jax(act):
    """The GroupNorm wrapper's gradients in x, scale and bias against
    jax.vjp of the Pallas kernel in interpret mode (its rule recomputes
    through group_norm_reference)."""
    from videop2p_tpu.ops.groupnorm import fused_group_norm as jax_gn

    from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 512, 64)) * 2 + 0.5).astype(np.float32)
    scale, bias = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=x.shape).astype(np.float32)
    kw = dict(num_groups=8, eps=1e-5, act=act)
    want = _jax_vjp(lambda a, b, c: jax_gn(a, b, c, interpret=True, **kw),
                    x, scale, bias, g, jnp.float32)
    got = _torch_grads(lambda a, b, c: fused_group_norm(a, b, c, **kw),
                       x, scale, bias, g, torch.float32)
    _close(got, want, "float32")


def test_chunked_frame_attention_backward_holds_one_chunk():
    """Under autograd chunked_frame_attention saves only its inputs and its
    backward recomputes one query chunk at a time (the memory bound of JAX's
    ``jax.checkpoint`` per chunk): at B1 F2 H2 N2048 D40 the tensors saved
    for the backward stay below the dense f32 probability tensor (67.1 MB;
    autograd through the plain chunks saves every chunk's softmax, 140.8
    MB), and the gradients match jax.vjp of JAX's chunked version."""
    import videop2p_tpu.ops.attention as jax_fa

    from videop2p_tpu_torch.ops.attention import chunked_frame_attention

    shape = (1, 2, 2, 2048, 40)
    q, k, v, do = _inputs(8, *shape)
    dense_probs = 4 * shape[1] * shape[2] * shape[3] * shape[3]
    saved = []

    def pack(x):
        saved.append(x.numel() * x.element_size())
        return x

    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = chunked_frame_attention(*leaves)
    assert 0 < sum(saved) < dense_probs, (sum(saved), dense_probs)
    out.backward(t(do))
    with torch.no_grad():
        np.testing.assert_array_equal(np32(out), np32(chunked_frame_attention(
            *(t(a) for a in (q, k, v)))))
    want = _jax_vjp(jax_fa.chunked_frame_attention, q, k, v, do, jnp.float32)
    _close([np32(out)] + [np32(x.grad) for x in leaves], want, "float32")


def test_fused_backward_rule_takes_the_chunked_gradients_chunk_by_chunk():
    """The backward of chunked_frame_attention and of the fused kernel on
    the card, ``_chunked_grads`` (here on CPU tensors): one query chunk
    recomputed at a time, against jax.vjp of JAX's chunked version, and
    None for an input that needs none."""
    import videop2p_tpu.ops.attention as jax_fa

    from videop2p_tpu_torch.ops.attention import _chunked_grads

    q, k, v, do = _inputs(9, 1, 2, 2, 2048, 40)
    want = _jax_vjp(jax_fa.chunked_frame_attention, q, k, v, do, jnp.float32)
    got = _chunked_grads([t(a) for a in (q, k, v)], (True, True, True), t(do))
    _close([np32(x) for x in got], want[1:], "float32")
    dq, dk, dv = _chunked_grads([t(a) for a in (q, k, v)], (True, False, True), t(do))
    assert dk is None
    _close([np32(dq), np32(dv)], [want[1], want[3]], "float32")
