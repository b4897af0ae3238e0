"""The port's CLI against the JAX CLI's contract: the dependent flags, the
checkpoint-path suffix and its resolution, the results directory, the frame
loader, and an edit from a checkpoint directory (tiny models on the CPU).

All checks are exact: flags, paths, loaded frames, and an edit from a
checkpoint directory against the same edit from the same weights in memory
(bit for bit: the same float32 arithmetic on both sides).
"""

import argparse
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parity import tiny_unet_pair
from tests.test_torch_slice import RABBIT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEP = dict(dependent=True, decay_rate=0.3, window_size=4, ar_sample=True, ar_coeff=0.1,
           dependent_weights=0.2)


def test_dependent_flags_match_jax():
    from videop2p_tpu.cli.common import add_dependent_args as jax_add

    from videop2p_tpu_torch.cli.common import add_dependent_args

    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_dependent_args(ours)
    jax_add(theirs)
    assert vars(ours.parse_args([])) == vars(theirs.parse_args([]))
    argv = ["--dependent", "--ar_sample", "--decay_rate", "0.3", "--window_size", "4",
            "--ar_coeff", "0.2", "--loss_sig", "--num_frames", "8", "--eta", "0.1",
            "--dependent_weights", "0.2"]
    assert vars(ours.parse_args(argv)) == vars(theirs.parse_args(argv))


GRID = [dict(dependent=d, decay_rate=dr, window_size=ws, ar_sample=ar, ar_coeff=ac,
             eta=e, dependent_weights=dw)
        for d, dr, ws, ar, ac, e, dw in itertools.product(
            (False, True), (0.1, 0.3), (4, 60), (False, True), (0.1,), (0.0, 0.1),
            (0.0, 0.2))]


@pytest.mark.parametrize("layout", ["suffixed", "base", "neither"])
def test_suffix_and_resolution_match_jax(tmp_path, layout):
    from videop2p_tpu.cli.common import dependent_suffix as jax_suffix
    from videop2p_tpu.cli.common import resolve_pipeline_dir as jax_resolve

    from videop2p_tpu_torch.cli.common import dependent_suffix, resolve_pipeline_dir

    base = str(tmp_path / "rabbit-jump")
    for kw in GRID:
        assert dependent_suffix(**kw) == jax_suffix(**kw)
        if layout == "suffixed":
            os.makedirs(base + dependent_suffix(**kw) + "/unet", exist_ok=True)
        elif layout == "base":
            os.makedirs(base, exist_ok=True)
            open(base + "/model_index.json", "w").close()
        got = resolve_pipeline_dir(base, **kw)
        assert got == jax_resolve(base, **kw)
        assert got == (base if layout == "base" else base + dependent_suffix(**kw))


def _tiny_kw(tmp_path, **extra):
    frames = np.random.default_rng(5).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    return dict(RABBIT, pretrained_model_path=str(tmp_path / "rabbit-jump"), device="cpu",
                tiny=True, video_len=4, num_ddim_steps=2, frames=frames, **extra)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "official"])
def test_main_with_dependent_p2p_writes_where_jax_writes(tmp_path, fast):
    """``--dependent_p2p`` in both modes: the GIFs land in JAX's results
    directory; the cached edit still replays x_0 exactly; the blend moves
    the edit."""
    from videop2p_tpu.cli.common import resolve_pipeline_dir as jax_resolve

    from videop2p_tpu_torch.cli.run_videop2p import main

    kw = _tiny_kw(tmp_path, fast=fast, num_inner_steps=1)
    want_dir = os.path.join(jax_resolve(kw["pretrained_model_path"], eta=0.0, **DEP),
                            "results_dpTrue")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        out = main(**kw, dependent_p2p=True, **DEP)
    assert out["output_dir"] == want_dir
    suffix = "_fast" if fast else ""
    assert out["gifs"] == (os.path.join(want_dir, f"inversion{suffix}.gif"),
                           os.path.join(want_dir, f"origami{suffix}.gif"))
    assert all(os.path.isfile(p) for p in out["gifs"])
    assert out["mode"] == ("cached" if fast else "official")
    if fast:
        assert (out["latents"][0] - out["x_0"][0]).abs().max().item() == 0.0
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        plain = main(**kw, save_gifs=False)
    assert plain["output_dir"].endswith("rabbit-jump_dependentFalse_dr0.1_ws60_arFalse_"
                                        "ac0.1_eta0.0_dw0.0/results_dpFalse")
    assert (out["latents"] - plain["latents"]).abs().max() > 1e-4


def test_main_raises_where_jax_raises(tmp_path):
    """A window that does not divide the frames; ``eta`` > 0 with
    ``--dependent`` alone builds the sampler too."""
    from videop2p_tpu_torch.cli.run_videop2p import main

    kw = _tiny_kw(tmp_path, fast=True, save_gifs=False)
    with pytest.raises(ValueError, match="divisible"):
        main(**dict(kw, frames=np.zeros((3, 16, 16, 3), np.uint8), video_len=3),
             dependent_p2p=True, **dict(DEP, window_size=2))
    with pytest.raises(ValueError, match="divisible"):
        main(**kw, **dict(DEP, window_size=3), eta=0.1)


def test_cli_module_runs_the_dependent_flags(tmp_path):
    """``python -m videop2p_tpu_torch.cli.run_videop2p`` with the dependent
    flags, ``--fast --live_source --eta 0.1`` on the CPU at tiny size."""
    cfg = tmp_path / "p2p.yaml"
    cfg.write_text(open(os.path.join(REPO, "configs", "rabbit-jump-p2p.yaml")).read()
                   .replace("./outputs/rabbit-jump", str(tmp_path / "rabbit-jump"))
                   + "\nvideo_len: 8\n")
    argv = [sys.executable, "-m", "videop2p_tpu_torch.cli.run_videop2p", "--config",
            str(cfg), "--fast", "--live_source", "--tiny", "--device", "cpu", "--steps", "2",
            "--dependent", "--dependent_p2p", "--decay_rate", "0.3", "--window_size", "4",
            "--ar_sample", "--ar_coeff", "0.1", "--dependent_weights", "0.2", "--eta", "0.1",
            "--no_reuse_inversion"]
    res = subprocess.run(argv, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out_dir = tmp_path / ("rabbit-jump_dependentTrue_dr0.3_ws4_arTrue_ac0.1_eta0.1_dw0.2"
                          "/results_dpTrue")
    assert sorted(os.listdir(out_dir)) == ["inversion_fast.gif", "origami_fast.gif"]


def test_frame_loader_matches_jax(tmp_path):
    """Trailing-digit order (``f_2`` before ``f_10``), ``.bmp`` and
    ``.webp`` frames, edge crops, center crop, resize."""
    from PIL import Image
    from videop2p_tpu.data.dataset import load_frame_sequence as jax_load

    from videop2p_tpu_torch.data.dataset import _numeric_sort, load_frame_sequence

    rng = np.random.default_rng(0)
    for name in ("f_10.png", "f_2.png", "f_3.bmp", "f_1.webp", "intro.jpg"):
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)).save(
            tmp_path / name)
    (tmp_path / "notes.txt").write_text("not a frame")
    names = os.listdir(tmp_path)
    assert _numeric_sort(names)[:4] == ["f_1.webp", "f_2.png", "f_3.bmp", "f_10.png"]
    for kw in (dict(), dict(left=3, right=5, top=2, bottom=1), dict(num_frames=3)):
        got, want = load_frame_sequence(str(tmp_path), 16, **kw), jax_load(str(tmp_path), 16, **kw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_main_on_a_jax_checkpoint_equals_the_in_memory_run(tmp_path):
    """A tuned tiny checkpoint written by JAX's ``save_pipeline`` (the UNet
    and a scheduler config with ``steps_offset`` 1) under the suffixed
    directory: ``main`` resolves and loads it, backfills the VAE and text
    encoder with the seeded random init, and edits exactly as the same run
    from the same weights in memory."""
    from videop2p_tpu.models import UNet3DConfig
    from videop2p_tpu.models.pipeline_io import save_pipeline as jax_save

    from tests.test_torch_pipeline_io import SCHED
    from videop2p_tpu_torch.cli.common import dependent_suffix
    from videop2p_tpu_torch.cli.run_videop2p import ModelBundle, build_models, main

    _, variables, pmodel = tiny_unet_pair(seed=11, frames=4)
    kw = _tiny_kw(tmp_path, fast=True, save_gifs=False)
    ckpt = kw["pretrained_model_path"] + dependent_suffix(eta=0.0, **DEP)
    jax_save(ckpt, UNet3DConfig.tiny(), variables, scheduler_config=SCHED)
    with pytest.warns(UserWarning, match="backfilling"):
        got = main(**kw, dependent_p2p=True, **DEP)
    assert got["checkpoint_dir"] == ckpt
    assert got["output_dir"] == os.path.join(ckpt, "results_dpTrue")
    rand = build_models(tiny=True, device="cpu", seed=0)
    bundle = ModelBundle(unet=pmodel, vae=rand.vae, text_encoder=rand.text_encoder,
                         scheduler_config=SCHED)
    want = main(**kw, bundle=bundle, dependent_p2p=True, **DEP)
    for key in ("latents", "x_0", "x_t", "videos"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    default = main(**kw, bundle=ModelBundle(unet=pmodel, vae=rand.vae,
                                            text_encoder=rand.text_encoder),
                   dependent_p2p=True, **DEP)
    assert (default["latents"] - want["latents"]).abs().max() > 0  # the scheduler mattered


def test_dataset_and_gif_writers_match_jax(tmp_path):
    """``SingleVideoDataset`` (start, stride, resize to [-1, 1]) and the GIF
    writers (``to_uint8``, ``make_grid``, ``save_video_gif``,
    ``save_videos_grid``) against the JAX package's, byte for byte."""
    import imageio.v3 as iio
    from PIL import Image
    from videop2p_tpu.data.dataset import SingleVideoDataset as JaxDataset
    from videop2p_tpu.utils import video_io as jax_video_io

    from videop2p_tpu_torch.data.dataset import SingleVideoDataset
    from videop2p_tpu_torch.utils import video_io

    rng = np.random.default_rng(1)
    clip = tmp_path / "clip"
    clip.mkdir()
    for i in range(1, 6):
        Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
            clip / f"{i}.png")
    kw = dict(video_path=str(clip), prompt="a rabbit", width=16, height=12,
              n_sample_frames=2, sample_start_idx=1, sample_frame_rate=2)
    got, want = SingleVideoDataset(**kw).load(), JaxDataset(**kw).load()
    assert got.dtype == np.float32 and len(SingleVideoDataset(**kw)) == 1
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="exceed"):
        SingleVideoDataset(**dict(kw, n_sample_frames=3)).load()
    videos = rng.random((3, 2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(video_io.to_uint8(videos), jax_video_io.to_uint8(videos))
    np.testing.assert_array_equal(video_io.make_grid(video_io.to_uint8(videos[:, 0]), 2),
                                  jax_video_io.make_grid(jax_video_io.to_uint8(videos[:, 0]), 2))
    for name, ours, theirs in (
            ("one.gif", lambda p: video_io.save_video_gif(videos[0], p),
             lambda p: jax_video_io.save_video_gif(videos[0], p)),
            ("grid.gif", lambda p: video_io.save_videos_grid(videos, p),
             lambda p: jax_video_io.save_videos_grid(videos, p))):
        a, b = ours(str(tmp_path / "ours" / name)), theirs(str(tmp_path / "jax" / name))
        np.testing.assert_array_equal(iio.imread(a), iio.imread(b))
