"""Diffusers-layout pipeline directories: the Stage-1 → Stage-2 contract (port
of ``videop2p_tpu/models/pipeline_io.py``).

Stage 1 ends by writing its tuned pipeline; Stage 2 loads that directory as
``pretrained_model_path``. The layout::

    <dir>/
      model_index.json
      unet/          config.json + diffusion_pytorch_model.safetensors
      vae/           config.json + diffusion_pytorch_model.safetensors
      text_encoder/  config.json + model.safetensors
      tokenizer/     (CLIP BPE files, copied through, never rewritten)
      scheduler/     scheduler_config.json

A diffusers SD-1.x dump (a 2-D UNet: its temporal parameters keep the
port's init) or a tuned 3-D one loads here; what :func:`save_pipeline`
writes loads in the JAX package and in the reference. Weights cross through
:mod:`videop2p_tpu_torch.models.convert`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from videop2p_tpu_torch.models import convert
from videop2p_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
from videop2p_tpu_torch.models.vae import AutoencoderKL, VAEConfig

__all__ = ["LoadedPipeline", "load_pipeline", "save_pipeline", "unet_config_from_diffusers"]

_WEIGHT_NAMES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def _find_weights(subdir: str) -> str:
    for name in _WEIGHT_NAMES:
        p = os.path.join(subdir, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no weights file ({', '.join(_WEIGHT_NAMES)}) in {subdir!r}")


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class LoadedPipeline:
    """The loaded models (VAE and text encoder None where the directory has
    none), the tokenizer directory (None without one), the scheduler config
    ({} without one) and the UNet's inflation report (``kept_init``: the
    temporal parameters a 2-D checkpoint lacks, which keep the port's init;
    ``unused``)."""

    unet: UNet3DConditionModel
    vae: Optional[AutoencoderKL]
    text_encoder: Optional[CLIPTextEncoder]
    tokenizer_dir: Optional[str]
    scheduler_config: Dict[str, Any]
    inflation_report: Dict[str, list]


def unet_config_from_diffusers(cfg: Mapping[str, Any], **overrides) -> UNet3DConfig:
    """A diffusers UNet2D/3D ``config.json`` as :class:`UNet3DConfig` (2-D
    block types become their 3-D counterparts)."""
    def threed(name: str) -> str:
        return name.replace("2D", "3D")

    head_dim = cfg.get("attention_head_dim", 8)
    kw = dict(
        sample_size=cfg.get("sample_size", 64),
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        down_block_types=tuple(threed(b) for b in cfg["down_block_types"]),
        up_block_types=tuple(threed(b) for b in cfg["up_block_types"]),
        block_out_channels=tuple(cfg["block_out_channels"]),
        layers_per_block=cfg.get("layers_per_block", 2),
        attention_head_dim=tuple(head_dim) if isinstance(head_dim, (list, tuple)) else head_dim,
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
    )
    kw.update(overrides)
    return UNet3DConfig(**kw)


def _build(module_cls, cfg, device, seed: int, path: str, to_port, **kw):
    """``module_cls(cfg)`` on ``device`` with the port's seeded init, then the
    weights of ``path`` copied in (one host read, one copy a tensor).
    Returns (module, report)."""
    with torch.device(device):
        module = module_cls(cfg)
    convert.init_weights(module, seed)
    report = convert.load_weights(module, to_port(convert.load_state_dict(path)), **kw)
    return module, report


def load_pipeline(path: str, *, dtype: torch.dtype = torch.float32, device="cuda",
                  frame_attention: str = "auto", gradient_checkpointing: bool = False,
                  seed: int = 0) -> LoadedPipeline:
    """Load a diffusers-layout checkpoint directory onto ``device`` in
    ``dtype``, the UNet with ``frame_attention`` and
    ``gradient_checkpointing``. A 2-D UNet inflates: its
    temporal parameters keep the port's init (``seed``), whose temporal
    output projection is zero, so the inflated model equals its 2-D self;
    any other missing or unused key raises."""
    device = torch.device(device)
    unet_dir = os.path.join(path, "unet")
    ucfg = unet_config_from_diffusers(_read_json(os.path.join(unet_dir, "config.json")),
                                      frame_attention=frame_attention,
                                      gradient_checkpointing=gradient_checkpointing)
    unet, report = _build(UNet3DConditionModel, ucfg, device, seed, _find_weights(unet_dir),
                          dict, keep_init=convert.is_temporal_key)
    unet = unet.to(dtype).eval()

    vae = None
    vae_dir = os.path.join(path, "vae")
    if os.path.isdir(vae_dir):
        raw = _read_json(os.path.join(vae_dir, "config.json"))
        vcfg = VAEConfig(
            in_channels=raw.get("in_channels", 3),
            out_channels=raw.get("out_channels", 3),
            latent_channels=raw.get("latent_channels", 4),
            block_out_channels=tuple(raw.get("block_out_channels", (128, 256, 512, 512))),
            layers_per_block=raw.get("layers_per_block", 2),
            norm_num_groups=raw.get("norm_num_groups", 32),
            scaling_factor=raw.get("scaling_factor", 0.18215),
        )
        vae, _ = _build(AutoencoderKL, vcfg, device, seed + 1, _find_weights(vae_dir),
                        convert.vae_state_dict_from_diffusers)
        vae = vae.to(dtype).eval()

    text_encoder = None
    te_dir = os.path.join(path, "text_encoder")
    if os.path.isdir(te_dir):
        raw = _read_json(os.path.join(te_dir, "config.json"))
        tcfg = CLIPTextConfig(
            vocab_size=raw.get("vocab_size", 49408),
            hidden_size=raw.get("hidden_size", 768),
            intermediate_size=raw.get("intermediate_size", 3072),
            num_hidden_layers=raw.get("num_hidden_layers", 12),
            num_attention_heads=raw.get("num_attention_heads", 12),
            max_position_embeddings=raw.get("max_position_embeddings", 77),
            layer_norm_eps=raw.get("layer_norm_eps", 1e-5),
        )
        text_encoder, _ = _build(CLIPTextEncoder, tcfg, device, seed + 2,
                                 _find_weights(te_dir), convert.clip_state_dict_from_transformers)
        text_encoder = text_encoder.to(dtype).eval()

    tok_dir = os.path.join(path, "tokenizer")
    sched_path = os.path.join(path, "scheduler", "scheduler_config.json")
    return LoadedPipeline(
        unet=unet, vae=vae, text_encoder=text_encoder,
        tokenizer_dir=tok_dir if os.path.isdir(tok_dir) else None,
        scheduler_config=_read_json(sched_path) if os.path.exists(sched_path) else {},
        inflation_report=report)


def save_pipeline(path: str, unet_config: UNet3DConfig,
                  unet_state_dict: Mapping[str, torch.Tensor], *,
                  source_dir: Optional[str] = None,
                  scheduler_config: Optional[Dict[str, Any]] = None) -> int:
    """Write a diffusers-layout pipeline directory: the UNet's weights and
    ``config.json``, the scheduler config, the frozen parts (``vae``,
    ``text_encoder``, ``tokenizer``, ``scheduler``) copied through from
    ``source_dir`` when given (tuning never touches them, so only the UNet
    is written), and ``model_index.json``. Returns the UNet's bytes."""
    unet_dir = os.path.join(path, "unet")
    os.makedirs(unet_dir, exist_ok=True)
    nbytes = convert.save_safetensors(
        unet_state_dict, os.path.join(unet_dir, "diffusion_pytorch_model.safetensors"))
    cfg = unet_config
    head_dim = cfg.attention_head_dim
    with open(os.path.join(unet_dir, "config.json"), "w") as f:
        json.dump({
            "_class_name": "UNet3DConditionModel",
            "sample_size": cfg.sample_size,
            "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels,
            "down_block_types": list(cfg.down_block_types),
            "up_block_types": list(cfg.up_block_types),
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block,
            "attention_head_dim": list(head_dim) if isinstance(head_dim, tuple) else head_dim,
            "cross_attention_dim": cfg.cross_attention_dim,
            "norm_num_groups": cfg.norm_num_groups,
            "flip_sin_to_cos": cfg.flip_sin_to_cos,
            "freq_shift": cfg.freq_shift,
        }, f, indent=2)
    if scheduler_config:
        sdir = os.path.join(path, "scheduler")
        os.makedirs(sdir, exist_ok=True)
        with open(os.path.join(sdir, "scheduler_config.json"), "w") as f:
            json.dump(scheduler_config, f, indent=2)
    if source_dir:
        for sub in ("vae", "text_encoder", "tokenizer", "scheduler"):
            src, dst = os.path.join(source_dir, sub), os.path.join(path, sub)
            if os.path.isdir(src) and not os.path.isdir(dst):
                shutil.copytree(src, dst)
    index = {
        "_class_name": "TuneAVideoPipeline",
        "unet": ["videop2p_tpu_torch", "UNet3DConditionModel"],
        "vae": ["diffusers", "AutoencoderKL"],
        "text_encoder": ["transformers", "CLIPTextModel"],
        "tokenizer": ["transformers", "CLIPTokenizer"],
        "scheduler": ["diffusers", "DDIMScheduler"],
    }
    with open(os.path.join(path, "model_index.json"), "w") as f:
        json.dump(index, f, indent=2)
    return nbytes
