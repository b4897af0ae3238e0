"""The port's Stage-1 CLI against the JAX CLI's contract, both at tiny size on
the CPU in float32 for 4 steps (checkpoint at 2, validation at 4): the
suffixed output directory and its artifacts, and the export loading in
JAX's ``load_pipeline`` and in the port's Stage 2. Preemption and resume
are ``tests/test_torch_resume.py``.

All checks are exact: names, configs, keys, shapes and tensors. The two
packages' losses differ (each draws its own noise), so values are compared
only where both hold the same tensors: the port's export as JAX reads it.
"""

import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(root, name, **over):
    cfg = dict(
        pretrained_model_path=str(root / "no_checkpoint"),
        output_dir=str(root / name / "rabbit-jump"),
        train_data={"video_path": os.path.join(REPO, "data", "rabbit"),
                    "prompt": "a rabbit is jumping on the grass",
                    "n_sample_frames": 2, "width": 16, "height": 16},
        validation_data={"prompts": ["a origami rabbit is jumping on the grass"],
                         "num_inv_steps": 2, "num_inference_steps": 2,
                         "guidance_scale": 12.5},
        max_train_steps=4, checkpointing_steps=2, validation_steps=4, log_every=2,
        steps_per_call=2, tiny=True, mixed_precision="no", seed=0,
        gradient_checkpointing=False, dependent=True, decay_rate=0.3, window_size=4,
        ar_sample=True, ar_coeff=0.1, dependent_weights=0.2,
    )
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One tuning run of each package from the same config."""
    from videop2p_tpu.cli import run_tuning as jax_tuning

    from videop2p_tpu_torch.cli import run_tuning

    root = tmp_path_factory.mktemp("tune")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        port = run_tuning.main(**_cfg(root, "port"), device="cpu")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        jax = jax_tuning.main(**_cfg(root, "jax"), program_analysis=False)
    return {"port": port, "jax": jax, "root": root}


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def test_artifacts_match_jax(runs):
    port, jax = runs["port"], runs["jax"]
    assert os.path.basename(port) == os.path.basename(jax)
    assert port.endswith("rabbit-jump_dependentTrue_dr0.3_ws4_arTrue_ac0.1_eta0.0_dw0.2")
    for name in ("config.json", "metrics.jsonl", "model_index.json",
                 "inv_latents/ddim_latent-4.npy", "samples/sample-4.gif",
                 "unet/config.json", "unet/diffusion_pytorch_model.safetensors",
                 "scheduler/scheduler_config.json"):
        assert os.path.isfile(os.path.join(port, name)), name
        assert os.path.isfile(os.path.join(jax, name)), name
    for step in (2, 4):
        assert os.path.isdir(os.path.join(port, f"checkpoint-{step}"))
        assert os.path.isdir(os.path.join(jax, f"checkpoint-{step}"))
    assert _read_json(port, "unet", "config.json") == _read_json(jax, "unet", "config.json")
    assert (_read_json(port, "scheduler", "scheduler_config.json")
            == _read_json(jax, "scheduler", "scheduler_config.json"))
    index_p, index_j = _read_json(port, "model_index.json"), _read_json(jax, "model_index.json")
    assert sorted(index_p) == sorted(index_j)
    assert index_p["unet"] == ["videop2p_tpu_torch", "UNet3DConditionModel"]
    cfg_p, cfg_j = _read_json(port, "config.json"), _read_json(jax, "config.json")
    assert cfg_p["output_dir"] == port and cfg_j["output_dir"] == jax
    assert set(cfg_p) - {"device"} <= set(cfg_j)

    def metrics(top):
        with open(os.path.join(top, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    mp, mj = metrics(port), metrics(jax)
    assert [sorted(r) for r in mp] == [sorted(r) for r in mj]
    assert [r["step"] for r in mp] == [1, 2, 3, 4]
    assert [r["lr"] for r in mp] == [r["lr"] for r in mj]
    assert all(np.isfinite(r["train_loss"]) for r in mp)
    inv_p = np.load(os.path.join(port, "inv_latents", "ddim_latent-4.npy"))
    inv_j = np.load(os.path.join(jax, "inv_latents", "ddim_latent-4.npy"))
    assert inv_p.shape == inv_j.shape and inv_p.dtype == inv_j.dtype == np.float32


def test_port_export_loads_in_jax_and_in_stage_2(runs):
    """JAX's ``load_pipeline`` reads the port's tuned UNet tensors exactly;
    the port's ``run_videop2p`` edits from the directory (random VAE and
    text encoder backfilled: a random-init Stage 1 writes only the UNet)."""
    from videop2p_tpu.models.pipeline_io import load_pipeline as jax_load

    from videop2p_tpu_torch.cli.run_videop2p import main as edit
    from videop2p_tpu_torch.models import convert
    from tests.test_torch_slice import RABBIT

    port = runs["port"]
    exported = convert.read_safetensors(
        os.path.join(port, "unet", "diffusion_pytorch_model.safetensors"))
    assert all(v.dtype == torch.float32 for v in exported.values())
    loaded = jax_load(port)
    back = convert.unet_state_dict_from_jax(loaded.unet_params)
    assert sorted(back) == sorted(exported)
    for name, tensor in exported.items():
        assert torch.equal(back[name], tensor), name

    frames = np.random.default_rng(5).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    kw = dict(RABBIT, pretrained_model_path=os.path.dirname(port) + "/rabbit-jump",
              device="cpu", tiny=True, video_len=2, num_ddim_steps=2, frames=frames,
              fast=True, save_gifs=False)
    with pytest.warns(UserWarning, match="backfilling"):
        got = edit(**kw, dependent=True, decay_rate=0.3, window_size=4, ar_sample=True,
                   ar_coeff=0.1, dependent_weights=0.2)
    assert got["checkpoint_dir"] == port
    assert torch.isfinite(got["latents"]).all()
    assert (got["latents"][0] - got["x_0"][0]).abs().max().item() == 0.0
