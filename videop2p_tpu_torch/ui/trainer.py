"""The UI's training and editing launcher (port of
``videop2p_tpu/ui/trainer.py``).

The UI never imports the model stacks: it writes a merged YAML config into
an experiment directory and launches the port's CLI entry points
(``videop2p_tpu_torch.cli.run_tuning`` / ``run_videop2p``) as
subprocesses, so a crashed run cannot take the demo process down and the
artifacts flow through the experiments directory. The config dicts are the
JAX package's. PyYAML is imported where a config is written.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import re
import subprocess
import sys
from typing import Dict, List, Optional

__all__ = ["Trainer", "find_exp_dirs", "save_model_card"]

TUNING_MODULE = "videop2p_tpu_torch.cli.run_tuning"
EDITING_MODULE = "videop2p_tpu_torch.cli.run_videop2p"


def _slugify(name: str) -> str:
    name = re.sub(r"[^a-zA-Z0-9._-]+", "-", name.strip().lower())
    return re.sub(r"-+", "-", name).strip("-") or "exp"


def _write_yaml(cfg: Dict, path: pathlib.Path) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)


def find_exp_dirs(root: str = "experiments") -> List[str]:
    """Experiment directories that hold a finished pipeline
    (``model_index.json``), newest first."""
    rootp = pathlib.Path(root)
    if not rootp.is_dir():
        return []
    dirs = [p.parent for p in rootp.glob("**/model_index.json")]
    dirs.sort(key=lambda p: p.stat().st_mtime, reverse=True)
    return [str(p) for p in dirs]


def save_model_card(save_dir: str, *, base_model: str, training_prompt: str,
                    test_prompt: str = "", sample_gif: Optional[str] = None) -> str:
    """Write a README model card into an experiment directory."""
    image_block = f"![sample]({sample_gif})\n" if sample_gif else ""
    card = f"""---
license: creativeml-openrail-m
base_model: {base_model}
tags:
- video-p2p
- text-to-video
- cuda
---
# Video-P2P (H100) — {os.path.basename(save_dir)}

One-shot video tuning + prompt-to-prompt editing checkpoint.

- base model: `{base_model}`
- training prompt: `{training_prompt}`
- test prompt: `{test_prompt}`

{image_block}"""
    path = os.path.join(save_dir, "README.md")
    os.makedirs(save_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(card)
    return path


class Trainer:
    """Builds configs and launches the CLI entry points."""

    def __init__(self, experiments_dir: str = "experiments",
                 checkpoint_dir: str = "checkpoints"):
        self.experiments_dir = pathlib.Path(experiments_dir)
        self.checkpoint_dir = pathlib.Path(checkpoint_dir)
        self.experiments_dir.mkdir(exist_ok=True)
        self.checkpoint_dir.mkdir(exist_ok=True)

    def resolve_base_model(self, base_model_id: str) -> str:
        """A local checkpoint path for a model id: under ``checkpoint_dir``
        first, then the id itself as a directory, then a
        ``huggingface_hub`` snapshot where the package and a network are
        there; else the local path, where the CLIs build random-init
        models, so the demo stays drivable offline."""
        local = self.checkpoint_dir / base_model_id
        if local.is_dir():
            return local.as_posix()
        if os.path.isdir(base_model_id):
            return base_model_id
        try:
            import huggingface_hub

            return huggingface_hub.snapshot_download(base_model_id)
        except Exception:  # noqa: BLE001 — no package or no network
            return local.as_posix()

    def build_tune_config(self, *, video_path: str, training_prompt: str,
                          validation_prompt: str, base_model: str, output_dir: str,
                          resolution: int = 512, n_sample_frames: int = 8,
                          n_steps: int = 300, learning_rate: float = 3.5e-5,
                          gradient_accumulation: int = 1, seed: int = 0,
                          mixed_precision: str = "bf16", checkpointing_steps: int = 1000,
                          validation_steps: int = 100) -> Dict:
        """The merged Stage-1 config."""
        return {
            "pretrained_model_path": self.resolve_base_model(base_model),
            "output_dir": output_dir,
            "train_data": {
                "video_path": video_path,
                "prompt": training_prompt,
                "n_sample_frames": n_sample_frames,
                "width": resolution,
                "height": resolution,
                "sample_start_idx": 0,
                "sample_frame_rate": 1,
            },
            "validation_data": {
                "prompts": [validation_prompt],
                "video_length": n_sample_frames,
                "width": resolution,
                "height": resolution,
                "num_inference_steps": 50,
                "guidance_scale": 7.5,
                "use_inv_latent": True,
                "num_inv_steps": 50,
            },
            "learning_rate": learning_rate,
            "gradient_accumulation_steps": gradient_accumulation,
            "train_batch_size": 1,
            "max_train_steps": n_steps,
            "checkpointing_steps": checkpointing_steps,
            "validation_steps": validation_steps,
            "trainable_modules": ["attn1.to_q", "attn2.to_q", "attn_temp"],
            "seed": seed,
            "mixed_precision": mixed_precision,
            "gradient_checkpointing": True,
        }

    def build_p2p_config(self, *, output_dir: str, video_path: str, training_prompt: str,
                         editing_prompt: str, blend_word_src: str = "",
                         blend_word_tgt: str = "", eq_word: str = "", eq_value: float = 2.0,
                         cross_replace_steps: float = 0.2, self_replace_steps: float = 0.5,
                         save_name: str = "edit", video_len: int = 8) -> Dict:
        """The Stage-2 config; word swap when the two prompts have the same
        length, as the reference's UI infers it."""
        cfg = {
            "pretrained_model_path": output_dir,
            "image_path": video_path,
            "prompt": training_prompt,
            "prompts": [training_prompt, editing_prompt],
            "save_name": _slugify(save_name),
            "is_word_swap": len(editing_prompt) == len(training_prompt),
            "cross_replace_steps": cross_replace_steps,
            "self_replace_steps": self_replace_steps,
            "video_len": video_len,
        }
        if blend_word_src and blend_word_tgt:
            cfg["blend_word"] = [blend_word_src, blend_word_tgt]
        if eq_word:
            cfg["eq_params"] = {"words": [eq_word], "values": [float(eq_value)]}
        return cfg

    def _launch(self, module: str, config_path: str, extra_flags: List[str]) -> int:
        cmd = [sys.executable, "-m", module, "--config", config_path] + extra_flags
        print("[ui]", " ".join(cmd))
        return subprocess.call(cmd)

    def run(self, *, output_model_name: str = "", extra_flags: Optional[List[str]] = None,
            **kwargs) -> str:
        """Stage 1: write the config, launch the tuning CLI, write a model
        card. Returns the experiment directory."""
        if not output_model_name:
            output_model_name = datetime.datetime.now().strftime(
                "video-p2p-%Y-%m-%d-%H-%M-%S")
        exp_dir = self.experiments_dir / _slugify(output_model_name)
        exp_dir.mkdir(parents=True, exist_ok=True)
        cfg = self.build_tune_config(output_dir=exp_dir.as_posix(), **kwargs)
        config_path = exp_dir / "train_config.yaml"
        _write_yaml(cfg, config_path)
        ret = self._launch(TUNING_MODULE, config_path.as_posix(), extra_flags or [])
        if ret != 0:
            raise RuntimeError(f"tuning failed with exit code {ret}")
        save_model_card(exp_dir.as_posix(), base_model=cfg["pretrained_model_path"],
                        training_prompt=kwargs.get("training_prompt", ""),
                        test_prompt=kwargs.get("validation_prompt", ""))
        return exp_dir.as_posix()

    def run_p2p(self, *, fast: bool = True, extra_flags: Optional[List[str]] = None,
                engine_url: Optional[str] = None, **kwargs) -> str:
        """Stage 2 against a finished experiment directory; returns it. With
        ``engine_url`` (or ``VIDEOP2P_SERVE_URL``) naming a healthy
        ``cli/serve.py`` engine the edit is served by it; an absent or
        unhealthy engine, or a failed request, falls back to the
        subprocess CLI."""
        exp_dir = pathlib.Path(kwargs["output_dir"])
        cfg = self.build_p2p_config(**kwargs)
        config_path = exp_dir / "p2p_config.yaml"
        _write_yaml(cfg, config_path)
        engine_url = engine_url or os.environ.get("VIDEOP2P_SERVE_URL")
        if engine_url:
            from videop2p_tpu_torch.ui.inference import edit_via_engine

            if edit_via_engine(engine_url, cfg) is not None:
                return exp_dir.as_posix()
        flags = list(extra_flags or [])
        if fast:
            flags.append("--fast")
        ret = self._launch(EDITING_MODULE, config_path.as_posix(), flags)
        if ret != 0:
            raise RuntimeError(f"editing failed with exit code {ret}")
        return exp_dir.as_posix()
