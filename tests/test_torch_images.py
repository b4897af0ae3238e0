"""The port's still-image helpers (``utils/images.py``) and sweep CLI
(``cli/sweep.py``) against the JAX package's, on the CPU.

Tolerances: the PIL compositing exactly; decoded images within one uint8
level (the float images agree to ~1e-5, and a value next to a level's edge
may round either way); the sampled latents 2e-4 (the live edit's limit in
``tests/test_torch_surface.py``); the sweep's argvs exactly, module names
and ``--device`` aside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t, tiny_unet_pair
from tests.test_torch_vae_clip import _vae_pair


def test_compositing_matches_jax(tmp_path):
    from videop2p_tpu.utils import images as jax_images

    from videop2p_tpu_torch.utils import images

    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (20, 24, 3), dtype=np.uint8) for _ in range(3)]
    np.testing.assert_array_equal(images.text_under_image(imgs[0], "origami"),
                                  jax_images.text_under_image(imgs[0], "origami"))
    for rows in (1, 2):
        got = images.view_images(imgs, num_rows=rows, save_path=str(tmp_path / "g.png"))
        want = jax_images.view_images(imgs, num_rows=rows)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert (tmp_path / "g.png").exists()
    np.testing.assert_array_equal(np.asarray(images.view_images(imgs[0])),
                                  np.asarray(jax_images.view_images(imgs[0])))


def _close_uint8(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_latent_decoders_match_jax():
    from videop2p_tpu.utils import images as jax_images

    from videop2p_tpu_torch.utils import images

    jvae, variables, pvae = _vae_pair(2)
    rng = np.random.default_rng(1)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_images.latent2image(jvae, variables, z)
    _close_uint8(images.latent2image(pvae, t(z)), want)
    video = rng.normal(size=(1, 5, 8, 8, 4)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax_images.latent2image_video(jvae, variables, video, chunk=2)
    got = images.latent2image_video(pvae, t(video), chunk=2)
    assert got.shape == (5, 16, 16, 3)
    _close_uint8(got, want)


def test_init_latent():
    from videop2p_tpu_torch.utils.images import init_latent

    gen = torch.Generator().manual_seed(0)
    latent, latents = init_latent(None, 3, height=64, width=32, generator=gen)
    assert latent.shape == (1, 8, 4, 4) and latents.shape == (3, 8, 4, 4)
    assert torch.equal(latents[2], latent[0])
    same, _ = init_latent(latent, 2)
    assert same is latent
    with pytest.raises(ValueError, match="generator"):
        init_latent(None, 2)


@pytest.mark.parametrize("kind", ["stable", "ldm"])
def test_text2image_matches_jax(kind):
    """One controlled text → image run of each package from the same
    latent, prompts' embeddings and weights (the refine controller with its
    equalizer, 3 steps, the tiny VAE's ÷2 latents)."""
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.utils import images as jax_images
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from tests.test_torch_cached import CTRL, PROMPTS

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils import images
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    steps = 3
    ctrl = {k: v for k, v in CTRL.items() if k != "blend_words"}
    jmodel, params, pmodel = tiny_unet_pair(seed=2, frames=1)
    jvae, vparams, pvae = _vae_pair(3)
    rng = np.random.default_rng(2)
    latent = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    cond = rng.normal(size=(2, 77, 16)).astype(np.float32)
    uncond = rng.normal(size=(77, 16)).astype(np.float32)
    kw = dict(num_inference_steps=steps, height=16, width=16, vae_scale_factor=2)
    jctx = jax_make(PROMPTS, JaxTok(), steps, **ctrl)
    ctx = make_controller(PROMPTS, WordTokenizer(), steps, **ctrl)
    jdecode = lambda z: jnp.tanh(z[..., :3])  # noqa: E731
    with jax.default_matmul_precision("highest"):
        if kind == "stable":
            want, _ = jax_images.text2image_stable(
                jax_unet_fn(jmodel), params, JaxDDIM.create_sd(), jvae, vparams, cond,
                uncond, ctx=jctx, latent=jnp.asarray(latent), **kw)
        else:
            want, _ = jax_images.text2image_ldm(
                jax_unet_fn(jmodel), params, JaxDDIM.create_sd(), jdecode, cond, uncond,
                ctx=jctx, latent=jnp.asarray(latent), **kw)
    with torch.no_grad():
        if kind == "stable":
            got, got_latent = images.text2image_stable(
                make_unet_fn(pmodel), DDIMScheduler.create_sd(), pvae, t(cond), t(uncond),
                ctx=ctx, latent=t(latent), **kw)
        else:
            got, got_latent = images.text2image_ldm(
                make_unet_fn(pmodel), DDIMScheduler.create_sd(),
                lambda z: torch.tanh(z[..., :3]), t(cond), t(uncond), ctx=ctx,
                latent=t(latent), **kw)
    assert got.shape == (2, 16 if kind == "stable" else 8, 16 if kind == "stable" else 8, 3)
    np.testing.assert_array_equal(np32(got_latent), latent)
    _close_uint8(got, np.asarray(want))


@pytest.mark.parametrize("fast, inv_store", [(False, None), (True, "inv_store")])
def test_sweep_cells_are_jax_s(fast, inv_store):
    from videop2p_tpu.cli.sweep import cell_commands as jax_cells

    from videop2p_tpu_torch.cli.sweep import cell_commands

    kw = dict(decay_rate=0.3, eta=0.1, dependent_weight=0.2, window_size=4,
              ar_sample=True, ar_coeff=0.1, num_frames=8, fast=fast, dependent_p2p=True,
              extra=["--tiny"], inv_store=inv_store)
    want = jax_cells("t.yaml", "p.yaml", **kw)
    got = cell_commands("t.yaml", "p.yaml", **kw)
    modules = {"videop2p_tpu.cli.run_tuning": "videop2p_tpu_torch.cli.run_tuning",
               "videop2p_tpu.cli.run_videop2p": "videop2p_tpu_torch.cli.run_videop2p"}
    assert got == [[modules.get(a, a) for a in argv] for argv in want]
    on_cpu = cell_commands("t.yaml", "p.yaml", **kw, device="cpu")
    for argv, plain in zip(on_cpu, got):
        i = argv.index("--device")
        assert argv[i + 1] == "cpu" and argv[:i] + argv[i + 2:] == plain


def test_sweep_dry_run(capsys):
    from videop2p_tpu_torch.cli.sweep import main

    assert main(["--dry_run", "--decay_rates", "0.1", "0.3", "--device", "cpu",
                 "--tiny"]) == 0
    out = capsys.readouterr().out
    assert out.count("videop2p_tpu_torch.cli.run_tuning") == 2
    assert out.count("videop2p_tpu_torch.cli.run_videop2p") == 2
    assert "--inv_store inv_store" in out and "--device cpu" in out


@pytest.mark.parametrize("frames, size", [(8, 64), (2, 16), (3, 33)])
def test_gif_bytes_are_pils_rgb_gif(tmp_path, frames, size):
    """``save_video_gif`` makes each frame's palette in a thread pool: its
    file is the one PIL writes from the RGB frames, byte for byte."""
    from PIL import Image

    from videop2p_tpu_torch.utils.video_io import save_video_gif, to_uint8

    video = np.random.default_rng(size).random((frames, size, size, 3)).astype(np.float32)
    ours = save_video_gif(video, str(tmp_path / "ours.gif"))
    rgb = [Image.fromarray(f) for f in to_uint8(video)]
    rgb[0].save(tmp_path / "pil.gif", format="GIF", save_all=True, append_images=rgb[1:],
                duration=250, loop=0)
    assert open(ours, "rb").read() == (tmp_path / "pil.gif").read_bytes()
