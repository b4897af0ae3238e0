"""The port's official mode against the JAX package's, on the CPU with
identical tiny-UNet weights, trajectory, embeddings and controller (refine
with equalizer and LocalBlend): the full-CFG edit with injected null-text
embeddings, its η > 0 form fed JAX's own noise, and ``official_edit`` (the
null-text optimization, then the full-CFG edit) end to end; plus the CLI's
official mode.

Tolerances: the full-CFG edit 2e-4 absolute (float32 through 3 controlled
steps; guidance 7.5 amplifies the UNet's summation-order differences, ~1e-6,
about tenfold, as in the live slice test); ``official_edit`` final losses
1e-4 relative and inner steps exactly, its edited latents 2e-3 absolute
(each package edits with its own optimized embeddings, which differ by
~2e-4 after Adam; measured 6.7e-5).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t, tiny_unet_pair

STEPS = 3
SHAPE = (1, 2, 8, 8, 4)
PROMPTS = ["a rabbit is jumping on the grass",
           "a origami rabbit is jumping on the grass"]
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.8,
            self_replace_steps=0.5, blend_words=(("rabbit",), ("rabbit",)),
            equalizer_params={"words": ["origami"], "values": [2]})


@pytest.fixture(scope="module")
def setup():
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import ddim_inversion as jax_invert
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    jmodel, variables, pmodel = tiny_unet_pair(seed=6, frames=SHAPE[1])
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=SHAPE).astype(np.float32)
    cond = rng.normal(size=(2, 77, 16)).astype(np.float32)
    uncond = rng.normal(size=(77, 16)).astype(np.float32)
    jfn, jsched = jax_unet_fn(jmodel), JaxDDIM.create_sd()
    with jax.default_matmul_precision("highest"):
        traj = np.asarray(jax.jit(lambda p, x, c: jax_invert(
            jfn, p, jsched, x, c, num_inference_steps=STEPS))(variables, x0, cond[:1]))
    return dict(jfn=jfn, params=variables, jsched=jsched,
                jctx=jax_make(PROMPTS, JaxTok(), STEPS, **CTRL),
                pfn=make_unet_fn(pmodel), psched=DDIMScheduler.create_sd(),
                pctx=make_controller(PROMPTS, WordTokenizer(), STEPS, **CTRL),
                traj=traj, cond=cond, uncond=uncond,
                null=rng.normal(size=(STEPS, 1, 77, 16)).astype(np.float32))


def _jax_edit(s, **kw):
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    with jax.default_matmul_precision("highest"):
        return np32(jax.jit(lambda p, x, n: jax_edit(
            s["jfn"], p, s["jsched"], x, s["cond"], s["uncond"],
            num_inference_steps=STEPS, ctx=s["jctx"], source_uses_cfg=True,
            null_uncond_embeddings=n, **kw))(s["params"], s["traj"][-1], s["null"]))


def test_full_cfg_edit_with_null_text_embeddings_matches_jax(setup):
    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    want = _jax_edit(s)
    got = edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]),
                      t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"],
                      source_uses_cfg=True, null_uncond_embeddings=t(s["null"]))
    np.testing.assert_allclose(np32(got), want, atol=2e-4)
    # the injected embeddings reach the source stream: without them it differs
    plain = edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]),
                        t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"])
    assert np.abs(np32(plain[0]) - np32(got[0])).max() > 1e-3


def test_full_cfg_edit_with_eta_matches_jax_on_its_noise(setup):
    """η > 0: JAX draws its variance noise from its key, one split per step;
    the port takes the same draws as ``variance_noise``."""
    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    key = jax.random.key(5)
    want = _jax_edit(s, eta=0.7, key=key)
    noise = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        noise.append(np32(jax.random.normal(sub, (2,) + SHAPE[1:], jnp.float32)))
    got = edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]),
                      t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"],
                      eta=0.7, variance_noise=t(np.stack(noise)),
                      null_uncond_embeddings=t(s["null"]))
    np.testing.assert_allclose(np32(got), want, atol=2e-4)
    # a torch.Generator draws its own noise, reproducibly
    runs = [edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]),
                        t(s["uncond"]), num_inference_steps=STEPS, eta=0.7,
                        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="variance_noise must have shape"):
        edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=STEPS, eta=0.7, variance_noise=t(noise[0]))
    with pytest.raises(ValueError, match="needs a generator or variance_noise"):
        edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=STEPS, eta=0.7)


def test_null_text_embedding_shapes_are_checked(setup):
    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    args = (s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]), t(s["uncond"]))
    with pytest.raises(ValueError, match="must have shape"):
        edit_sample(*args, num_inference_steps=STEPS,
                    null_uncond_embeddings=t(s["null"][:2]))
    with pytest.raises(ValueError, match="batch-1 source stream"):
        edit_sample(*args, num_inference_steps=STEPS,
                    null_uncond_embeddings=t(np.concatenate([s["null"]] * 2, axis=1)))


def test_official_edit_matches_jax(setup):
    from videop2p_tpu.pipelines.sampling import official_edit as jax_official

    from videop2p_tpu_torch.pipelines import official_edit

    s = setup
    with jax.default_matmul_precision("highest"):
        want, want_stats = jax_official(
            s["jfn"], s["params"], s["jsched"], jnp.asarray(s["traj"]), s["cond"],
            s["uncond"], num_inference_steps=STEPS, ctx=s["jctx"], num_inner_steps=2,
            donate=False, return_null_stats=True)
    got, stats = official_edit(s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]),
                               t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"],
                               num_inner_steps=2)
    np.testing.assert_array_equal(stats["inner_steps"].numpy(),
                                  np.asarray(want_stats["inner_steps"]))
    np.testing.assert_allclose(stats["final_loss"].numpy(),
                               np.asarray(want_stats["final_loss"]), rtol=1e-4)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-3)


def test_official_edit_mixed_runs_the_null_text_on_a_bf16_clone(setup):
    """``null_text_precision="mixed"`` on a float32 UNet: the null-text phase
    runs on a bf16 clone of its module (the same numbers as handing
    ``null_text_optimization`` that clone), the edit on the float32 UNet,
    whose weights stay float32; ``phase`` wraps the two phases in order."""
    import copy

    from videop2p_tpu_torch.pipelines import edit_sample, make_unet_fn, official_edit
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    entered = []

    def phase(name):
        entered.append(name)
        return contextlib.nullcontext()

    got, stats = official_edit(s["pfn"], s["psched"], t(s["traj"]), t(s["cond"]),
                               t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"],
                               num_inner_steps=2, null_text_precision="mixed", phase=phase)
    assert entered == ["null_text_optimization", "edit_sample"]
    assert all(p.dtype == torch.float32 for p in s["pfn"].module.parameters())
    clone = make_unet_fn(copy.deepcopy(s["pfn"].module).to(torch.bfloat16))
    null_seq, losses, inner = null_text_optimization(
        clone, s["psched"], t(s["traj"]), t(s["cond"][:1]), t(s["uncond"][None]),
        num_inference_steps=STEPS, num_inner_steps=2, null_text_precision="mixed",
        return_losses=True, return_inner_steps=True)
    torch.testing.assert_close(stats["final_loss"], losses, rtol=0, atol=0)
    torch.testing.assert_close(stats["inner_steps"], inner, rtol=0, atol=0)
    want = edit_sample(s["pfn"], s["psched"], t(s["traj"][-1]), t(s["cond"]),
                       t(s["uncond"]), num_inference_steps=STEPS, ctx=s["pctx"],
                       null_uncond_embeddings=null_seq)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cli_runs_official_mode():
    """``main(fast=False)`` runs inversion → null-text → full-CFG edit →
    decode and reports the null-text record; "hybrid" takes 3 inner steps
    an outer step."""
    from videop2p_tpu_torch.cli.run_videop2p import main

    from tests.test_torch_slice import RABBIT

    frames = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, fast=False, device="cpu", tiny=True, video_len=2,
              num_ddim_steps=2, frames=frames, save_gifs=False, num_inner_steps=2)
    out = main(**kw)
    assert out["mode"] == "official" and out["cached_maps"] is None
    assert list(out["timings"])[-4:] == ["ddim_inversion", "null_text_optimization",
                                         "edit_sample", "vae_decode"]
    stats = out["null_text"]
    assert stats["inner_steps"].tolist() == [2, 2]
    assert stats["final_loss"].shape == (2,) and torch.isfinite(stats["final_loss"]).all()
    assert out["videos"].shape == (2, 2, 16, 16, 3) and torch.isfinite(out["videos"]).all()
    amortized = main(**kw, null_text_mode="amortized")
    assert amortized["null_text"]["inner_steps"].tolist() == [0, 0]
    hybrid = main(**kw, null_text_mode="hybrid")
    assert hybrid["null_text"]["inner_steps"].tolist() == [3, 3]
    assert torch.isfinite(hybrid["videos"]).all()


def test_cli_eta_is_seeded_and_fast_mode_takes_the_live_source():
    """``eta`` > 0: the edit's noise comes from a generator seeded with
    ``seed`` (two runs agree exactly, and differ from the η = 0 edit); fast
    mode then runs the live-source edit (the cached replay is
    deterministic), as the JAX CLI does; official mode takes η too."""
    from videop2p_tpu_torch.cli.run_videop2p import main

    from tests.test_torch_slice import RABBIT

    frames = np.random.default_rng(3).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, fast=True, device="cpu", tiny=True, video_len=2,
              num_ddim_steps=2, frames=frames, save_gifs=False)
    runs = [main(**kw, eta=0.5) for _ in range(2)]
    assert [r["mode"] for r in runs] == ["live"] * 2
    assert all(r["cached_maps"] is None for r in runs)
    torch.testing.assert_close(runs[0]["latents"], runs[1]["latents"], rtol=0, atol=0)
    deterministic = main(**kw, live_source=True)
    assert (runs[0]["latents"] - deterministic["latents"]).abs().max() > 1e-3
    official = main(**dict(kw, fast=False), eta=0.5, num_inner_steps=1)
    assert official["mode"] == "official"
    assert torch.isfinite(official["latents"]).all()
