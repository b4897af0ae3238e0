"""The slice end to end: the live-source fast edit through the JAX package's
``ProgramSet`` and through the port's ``cli.run_videop2p.main``, on the same
tiny random weights, frames and prompts, for 2 DDIM steps; the cached-source
default of ``main``; plus the port's isolation from JAX and its CLI's
refusals.

Tolerance 2e-4 absolute on the edited latents and the decoded video: float32
on both sides, through 2 inversion and 2 controlled edit steps (guidance
7.5 amplifies the UNet's summation-order differences, ~1e-6, by about 10).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RABBIT = dict(
    pretrained_model_path="./outputs/rabbit-jump",
    image_path="./data/rabbit",
    prompt="a rabbit is jumping on the grass",
    prompts=["a rabbit is jumping on the grass",
             "a origami rabbit is jumping on the grass"],
    blend_word=["rabbit", "rabbit"],
    eq_params={"words": ["origami"], "values": [2]},
    save_name="origami",
    is_word_swap=False,
    # wide enough that 2 steps keep the cross edit active
    cross_replace_steps=0.8,
    self_replace_steps=0.5,
    # every run a fresh one: no inversion persisted between the tests' runs
    reuse_inversion=False,
)
STEPS = 2


def test_live_source_fast_edit_matches_jax():
    from videop2p_tpu.cli.common import build_models
    from videop2p_tpu.pipelines import ddim_inversion as jax_invert
    from videop2p_tpu.pipelines import edit_sample as jax_edit
    from videop2p_tpu.serve.programs import MASK_TH, ProgramSet, ProgramSpec

    from videop2p_tpu_torch.cli.run_videop2p import ModelBundle, main
    from videop2p_tpu_torch.models import (
        AutoencoderKL,
        CLIPTextConfig,
        CLIPTextEncoder,
        UNet3DConditionModel,
        UNet3DConfig,
        VAEConfig,
    )
    from videop2p_tpu_torch.models.convert import state_dict_from_jax

    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        jbundle = build_models(None, dtype=jnp.float32, tiny=True, seed=0)
    # the JAX init zeroes the temporal output projection: make it non-zero
    # so the temporal edit shows in the output
    jbundle.unet_params = {"params": perturb(jbundle.unet_params["params"], 11)}
    ps = ProgramSet(ProgramSpec(tiny=True, width=16, video_len=2, steps=STEPS),
                    bundle=jbundle)
    frames = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)

    with jax.default_matmul_precision("highest"):
        latents = ps.encode(ps.frames_to_video(frames), jax.random.key(0))
        cond_src = ps.encode_prompts([RABBIT["prompt"]])
        cond_all = ps.encode_prompts(RABBIT["prompts"])
        uncond = ps.encode_prompts([""])[0]
        ctx = ps.controller(
            RABBIT["prompts"], is_word_swap=False,
            cross_replace_steps=RABBIT["cross_replace_steps"],
            self_replace_steps=RABBIT["self_replace_steps"],
            blend_word=RABBIT["blend_word"], eq_params=RABBIT["eq_params"],
            mask_th=MASK_TH)
        params = jbundle.unet_params
        traj = jax.jit(lambda p, x, c: jax_invert(
            ps.unet_fn, p, ps.scheduler, x, c, num_inference_steps=STEPS))(
                params, latents, cond_src)
        want = jax.jit(lambda p, x, c, u: jax_edit(
            ps.unet_fn, p, ps.scheduler, x, c, u, num_inference_steps=STEPS,
            guidance_scale=7.5, ctx=ctx, source_uses_cfg=False))(
                params, traj[-1], cond_all, uncond)
        want_video = ps.decode(want)

    sds = state_dict_from_jax(jbundle.unet_params, jbundle.vae_params,
                              jbundle.text_params)
    unet = UNet3DConditionModel(UNet3DConfig.tiny(cross_attention_dim=16))
    vae = AutoencoderKL(VAEConfig.tiny())
    text = CLIPTextEncoder(CLIPTextConfig.tiny())
    for mod, key in ((unet, "unet"), (vae, "vae"), (text, "text_encoder")):
        mod.load_state_dict(sds[key], strict=True)
        mod.eval()
    out = main(**RABBIT, fast=True, live_source=True, device="cpu", tiny=True,
               video_len=2, num_ddim_steps=STEPS, frames=frames, save_gifs=False,
               bundle=ModelBundle(unet=unet, vae=vae, text_encoder=text))

    np.testing.assert_allclose(np32(out["x_t"][0]), np32(traj[-1][0]), atol=2e-4)
    np.testing.assert_allclose(np32(out["latents"]), np32(want), atol=2e-4)
    assert out["videos"].shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(np32(out["videos"]), np32(want_video), atol=2e-4)
    # the edit stream moved away from the source reconstruction
    assert np.abs(np32(out["latents"][1] - out["latents"][0])).max() > 1e-3


def test_port_imports_nothing_of_jax():
    """Import every module of the port, and load chip_smoke.py without
    running its main, in a fresh interpreter: neither jax nor any module of
    videop2p_tpu may be loaded."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import videop2p_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "for n in names: importlib.import_module(n)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "assert callable(smoke.main)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m in ('flax', 'optax') or m == 'videop2p_tpu'\n"
        "             or m.startswith('videop2p_tpu.'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_refuses_what_is_not_ported(tmp_path):
    """A device mesh (``--mesh``) that is not the world raises; a checkpoint
    directory that does not load (a ``unet/`` without its config) raises
    too: random weights must not silently replace it."""
    from videop2p_tpu_torch.cli.run_videop2p import main

    kw = dict(RABBIT, device="cpu", tiny=True, video_len=2, num_ddim_steps=2,
              frames=np.zeros((2, 16, 16, 3), np.uint8), save_gifs=False)
    # a mesh is ported: in one process a 2-rank mesh raises, naming torchrun
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        main(**kw, fast=False, mesh="1,2,1")
    (tmp_path / "unet").mkdir()
    kw["pretrained_model_path"] = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="config.json"):
        main(**kw, fast=True, live_source=True)
    with pytest.raises(FileNotFoundError, match="config.json"):
        main(**kw, fast=True)


def test_cli_fast_default_runs_the_cached_edit(monkeypatch):
    """``main(fast=True)`` takes the cached-source path: stream 0 of the
    edit is the inversion's x_0 bit for bit (src_err == 0.0), and the edit
    stream moves away from it. Under a budget its maps do not fit, it falls
    back to the live-source edit, as ``--live_source`` runs it."""
    from videop2p_tpu_torch.cli import run_videop2p
    from videop2p_tpu_torch.cli.run_videop2p import main

    frames = np.random.default_rng(2).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, fast=True, device="cpu", tiny=True, video_len=2,
              num_ddim_steps=3, frames=frames, save_gifs=False)
    out = main(**kw)
    assert out["mode"] == "cached" and out["cached_maps"]["fits"]
    assert out["cached_maps"]["temporal_maps_dtype"] == "bfloat16"
    assert "cached_invert_edit" in out["timings"]
    assert (out["latents"][0] - out["x_0"][0]).abs().max().item() == 0.0
    assert (out["latents"][1] - out["latents"][0]).abs().max().item() > 1e-3
    assert out["videos"].shape == (2, 2, 16, 16, 3)
    assert torch.isfinite(out["videos"]).all()
    live = main(**kw, live_source=True)
    monkeypatch.setattr(run_videop2p, "CACHED_MAPS_BUDGET_GB", 0.0)
    fallback = main(**kw)
    assert fallback["mode"] == live["mode"] == "live"
    assert not fallback["cached_maps"]["fits"] and live["cached_maps"] is None
    torch.testing.assert_close(fallback["latents"], live["latents"], rtol=0, atol=0)


def test_cli_runs_on_cuda_unless_asked_for_the_cpu():
    from videop2p_tpu_torch.cli.run_videop2p import main

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    kw = dict(RABBIT, fast=True, live_source=True, tiny=True, video_len=2,
              num_ddim_steps=2, frames=np.zeros((2, 16, 16, 3), np.uint8),
              save_gifs=False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(**kw)


def test_cli_reads_the_cached_maps_budget_override(monkeypatch):
    """``VIDEOP2P_CACHED_MAPS_BUDGET_GB`` sets the budget that the CLI hands
    to ``choose_cached_maps`` and records in the decision, as in the JAX
    CLI; a budget of 0 forces the live-source fallback."""
    from videop2p_tpu_torch.cli import run_videop2p
    from videop2p_tpu_torch.cli.run_videop2p import main

    budgets = []
    real = run_videop2p.choose_cached_maps
    monkeypatch.setattr(run_videop2p, "choose_cached_maps",
                        lambda fn, budget_gb, **kw: budgets.append(budget_gb)
                        or real(fn, budget_gb=budget_gb, **kw))
    frames = np.random.default_rng(2).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, fast=True, device="cpu", tiny=True, video_len=2,
              num_ddim_steps=2, frames=frames, save_gifs=False)
    monkeypatch.setenv("VIDEOP2P_CACHED_MAPS_BUDGET_GB", "0.25")
    out = main(**kw)
    assert budgets == [0.25] and out["cached_maps"]["budget_gib"] == 0.25
    assert out["mode"] == "cached"
    monkeypatch.setenv("VIDEOP2P_CACHED_MAPS_BUDGET_GB", "0")
    out = main(**kw)
    assert budgets == [0.25, 0.0] and out["cached_maps"]["budget_gib"] == 0.0
    assert out["mode"] == "live" and not out["cached_maps"]["fits"]
