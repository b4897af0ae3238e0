"""The port's null-text optimization against the JAX package's, on the CPU with
identical tiny-UNet weights, trajectory and embeddings.

JAX runs at float32 matmul precision ("highest"). Adam turns small gradient
differences into steps of about lr·sign(g), so the optimization is held by
its per-step final losses and inner-step counts, with the embeddings only
bounded, and the backward by one value-and-gradient at a tight tolerance.

Tolerances: one loss and its gradient 1e-5 relative (summation order of the
UNet forward and backward; measured ~1e-6); final losses in float32 1e-4
relative (measured ≤ 4.4e-6 over 3 outer × 3 inner steps) and inner steps
exactly; the embeddings within 2·lr_0 = 0.02 (an element whose gradient
sits at 0 may step either way; measured ≤ 1.8e-4); "mixed" precision, where
both packages run a bf16 clone of the UNet and round differently, final
losses within 5e-2 relative (measured ≤ 2.3e-2); Adam against optax 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t, tiny_unet_pair

STEPS = 3
SHAPE = (1, 2, 8, 8, 4)
LOSS_RTOL = 1e-4
MIXED_LOSS_RTOL = 5e-2
EMB_BOUND = 2 * 1e-2


@pytest.fixture(scope="module")
def setup():
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import ddim_inversion as jax_invert
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn

    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn

    jmodel, variables, pmodel = tiny_unet_pair(seed=4, frames=SHAPE[1])
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    cond = rng.normal(size=(1, 77, 16)).astype(np.float32)
    uncond = rng.normal(size=(1, 77, 16)).astype(np.float32)
    jfn, jsched = jax_unet_fn(jmodel), JaxDDIM.create_sd()
    with jax.default_matmul_precision("highest"):
        traj = np.asarray(jax.jit(lambda p, x, c: jax_invert(
            jfn, p, jsched, x, c, num_inference_steps=STEPS))(variables, x0, cond))
    return dict(jmodel=jmodel, jfn=jfn, params=variables, jsched=jsched, pmodel=pmodel,
                pfn=make_unet_fn(pmodel), psched=DDIMScheduler.create_sd(), traj=traj,
                cond=cond, uncond=uncond)


def test_null_text_loss_and_gradient_match_jax(setup):
    """One value-and-gradient of the first outer step's loss in the
    embedding: the backward through the whole UNet."""
    s = setup
    ts = int(s["jsched"].timesteps(STEPS)[0])
    x_t, x_prev = s["traj"][-1], s["traj"][-2]

    def jax_loss(u):
        eps_c, _ = s["jfn"](s["params"], x_t, ts, s["cond"], None)
        eps_u, _ = s["jfn"](s["params"], x_t, ts, u, None)
        eps = eps_u + 7.5 * (jax.lax.stop_gradient(eps_c) - eps_u)
        rec = s["jsched"].prev_step(eps, ts, x_t, STEPS)
        return jnp.mean((rec - x_prev) ** 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(s["uncond"]))

    with torch.no_grad():
        eps_c = s["pfn"](t(x_t), ts, t(s["cond"]), None, store=False)[0]
    leaf = t(s["uncond"]).requires_grad_(True)
    eps_u = s["pfn"](t(x_t), ts, leaf, None, store=False)[0]
    rec = s["psched"].prev_step(eps_u + 7.5 * (eps_c - eps_u), ts, t(x_t), STEPS)
    loss = torch.mean((rec - t(x_prev)) ** 2)
    (grad,) = torch.autograd.grad(loss, leaf)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    scale = np.abs(np.asarray(want_grad)).max()
    assert scale > 0
    assert np.abs(np32(grad) - np.asarray(want_grad)).max() <= 1e-5 * scale


def test_adam_update_matches_optax():
    """The written-out Adam against optax.adam(1.0), its update scaled by a
    per-step lr, for six steps from a fresh state."""
    import optax

    from videop2p_tpu_torch.pipelines.inversion import adam_update

    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(3, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * 10 ** -k for k in range(6)]
    opt = optax.adam(1.0)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp, tstate = t(p0), None
    for i, g in enumerate(grads):
        lr = 1e-2 * (1 - i / 100)
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: lr * u, updates))
        tp, tstate = adam_update(tp, t(g), tstate, lr)
        np.testing.assert_allclose(np32(tp), np.asarray(jp), rtol=0, atol=1e-6)
    assert tstate[2] == len(grads)


@pytest.mark.parametrize("kw", [
    dict(num_inner_steps=3),
    dict(num_inner_steps=3, epsilon=7.8),  # early stop after one step at step 0
    dict(num_inner_steps=2, early_stop=False),
    dict(num_inner_steps=3, null_text_mode="amortized"),
    dict(num_inner_steps=3, null_text_precision="mixed"),
], ids=["optimize", "early_stop", "fixed_work", "amortized", "mixed"])
def test_null_text_optimization_matches_jax(setup, kw):
    from videop2p_tpu.pipelines.inversion import null_text_optimization as jax_null_text

    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    jfn, pfn = s["jfn"], s["pfn"]
    mixed = kw.get("null_text_precision") == "mixed"
    if mixed:
        from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn

        jfn = jax_unet_fn(s["jmodel"].clone(dtype=jnp.bfloat16))
        pfn = make_unet_fn(copy.deepcopy(s["pmodel"]).to(torch.bfloat16))
    with jax.default_matmul_precision("highest"):
        want = jax_null_text(jfn, s["params"], s["jsched"], s["traj"], s["cond"],
                             s["uncond"], num_inference_steps=STEPS, return_losses=True,
                             return_inner_steps=True, **kw)
    got = null_text_optimization(pfn, s["psched"], t(s["traj"]), t(s["cond"]),
                                 t(s["uncond"]), num_inference_steps=STEPS,
                                 return_losses=True, return_inner_steps=True, **kw)
    emb, losses, inner = got
    assert emb.shape == (STEPS, 1, 77, 16) and emb.dtype == torch.float32
    assert losses.shape == (STEPS,) and inner.dtype == torch.int32
    np.testing.assert_array_equal(inner.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[1]),
                               rtol=MIXED_LOSS_RTOL if mixed else LOSS_RTOL)
    if not mixed:
        assert np.abs(np32(emb) - np.asarray(want[0])).max() <= EMB_BOUND
    # the parameters are frozen only for the run
    assert all(p.requires_grad for p in s["pmodel"].parameters())


def test_null_text_refuses_what_is_not_ported(setup):
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    args = (s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]), t(s["uncond"]))
    with pytest.raises(ValueError, match="null_text_mode"):
        null_text_optimization(*args, num_inference_steps=STEPS, null_text_mode="joint")
    with pytest.raises(ValueError, match="hybrid_inner_steps"):
        null_text_optimization(*args, num_inference_steps=STEPS, null_text_mode="hybrid",
                               hybrid_inner_steps=0)
    with pytest.raises(ValueError, match="null_text_precision"):
        null_text_optimization(*args, num_inference_steps=STEPS, null_text_precision="bf16")


def test_null_text_needs_the_unet_module(setup):
    """The UNet is frozen through the module that ``make_unet_fn`` records:
    a bare callable is refused rather than run with its weights' gradients
    kept."""
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    bare = lambda *a, **kw: s["pfn"](*a, **kw)  # noqa: E731
    with pytest.raises(TypeError, match="make_unet_fn"):
        null_text_optimization(bare, s["psched"], t(s["traj"]), t(s["cond"]),
                               t(s["uncond"]), num_inference_steps=STEPS)
