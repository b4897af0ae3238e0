"""What both CLI stages share: the models (``ModelBundle``, ``build_models``,
``encode_prompts``), the fork's dependent-noise flags, the Stage-1 ↔ Stage-2
checkpoint-path contract and the config reader (the port's own copy of
those of ``videop2p_tpu/cli/common.py``).

Stage 1 writes its tuned pipeline to ``<path><suffix>``, the suffix spelling
out the dependent-noise settings; Stage 2, given the same flags, resolves the
same directory and writes its results under it.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import torch

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from videop2p_tpu_torch.models.convert import init_weights
from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
from videop2p_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from videop2p_tpu_torch.utils.tokenizers import WordTokenizer, load_tokenizer

__all__ = ["ModelBundle", "build_models", "encode_prompts", "add_dependent_args",
           "add_unported_args", "dependent_suffix", "resolve_pipeline_dir", "load_config",
           "deterministic_convolutions", "make_run_ledger"]


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN held to its deterministic algorithms inside the block. A
    convolution's backward may otherwise sum with atomics in an order that
    changes from run to run: Stage 1 runs under it so that a resumed run
    repeats an uninterrupted one bit for bit, and Stage 2's null-text phase
    so that two official runs of one clip give the same bits."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def load_config(path: str) -> Dict[str, Any]:
    """A YAML config as a dict (needs PyYAML)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def add_dependent_args(parser: argparse.ArgumentParser) -> None:
    """The fork's flags, with the JAX CLI's defaults. Stage 2 parses
    ``--loss_sig`` and ``--num_frames`` and does not use them (the sampler
    takes the clip's frame count)."""
    parser.add_argument("--dependent", default=False, action="store_true")
    parser.add_argument("--ar_sample", default=False, action="store_true")
    parser.add_argument("--decay_rate", default=0.1, type=float)
    parser.add_argument("--window_size", default=60, type=int)
    parser.add_argument("--ar_coeff", default=0.1, type=float)
    parser.add_argument("--loss_sig", default=False, action="store_true")
    parser.add_argument("--num_frames", default=60, type=int)
    parser.add_argument("--eta", default=0.0, type=float)
    parser.add_argument("--dependent_weights", default=0.0, type=float)


# the JAX run CLIs' observability flags (``add_obs_args``), not ported yet.
# ``--incidents`` is ported for the serving CLIs (serve, router, stream); on
# the run CLIs JAX arms it through the run ledger that ``--ledger`` names
# (``make_run_ledger``'s default path), which comes with the rest of obs/
OBS_FLAGS = ("--telemetry", "--ledger", "--no_program_analysis", "--device_telemetry",
             "--latency", "--trace_analysis", "--attn_maps", "--quality", "--report",
             "--incidents")


class _NotPorted(argparse.Action):
    """A JAX CLI flag the port does not take yet: using it is an error
    naming the ROADMAP item that ports it."""

    def __init__(self, option_strings, dest, item: str = "", **kwargs):
        self.item = item
        super().__init__(option_strings, dest, nargs="?", **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported on this CLI (ROADMAP Queue 1 "
                     f"item {self.item})")


def add_unported_args(parser: argparse.ArgumentParser) -> None:
    """The JAX run CLIs' observability flags, each refused with the ROADMAP
    item that ports it: item 14's step 3, the rest of ``obs/``. ``--incidents``
    is among them: the serving CLIs take it, but a run CLI arms it through
    the run ledger of ``--ledger``, which that step ports."""
    for flag in OBS_FLAGS:
        item = ("14, step 3: a run CLI arms the incident plane through the run ledger "
                "of --ledger" if flag == "--incidents" else "14, step 3")
        parser.add_argument(flag, action=_NotPorted, item=item,
                            help=f"observability: not ported on this CLI (ROADMAP Queue 1 "
                                 f"item {item})")


def dependent_suffix(*, dependent: bool, decay_rate: float, window_size: int,
                     ar_sample: bool, ar_coeff: float, eta: float,
                     dependent_weights: float) -> str:
    """The checkpoint directory's suffix: every setting in its Python
    ``str`` spelling, e.g. ``_dependentTrue_dr0.3_ws4_arTrue_ac0.1_eta0.0_dw0.2``."""
    return "_dependent{d}_dr{dr}_ws{ws}_ar{ar}_ac{ac}_eta{e}_dw{dw}".format(
        d=dependent, dr=decay_rate, ws=window_size, ar=ar_sample, ac=ar_coeff,
        e=eta, dw=dependent_weights)


def _is_pipeline_dir(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "unet")) or os.path.isfile(
        os.path.join(path, "model_index.json"))


def resolve_pipeline_dir(base_path: str, **suffix_kwargs) -> str:
    """The checkpoint directory for ``base_path`` and the settings of
    :func:`dependent_suffix`: the suffixed directory when it holds a
    pipeline, else ``base_path`` when it does (a caller that already holds
    the suffixed directory), else the suffixed directory (loading then finds
    no checkpoint and says so)."""
    suffixed = base_path + dependent_suffix(**suffix_kwargs)
    if _is_pipeline_dir(suffixed):
        return suffixed
    if _is_pipeline_dir(base_path):
        if suffixed != base_path:
            print(f"[resolve_pipeline_dir] {base_path!r} is already a pipeline "
                  "dir — not appending the dependent suffix")
        return base_path
    return suffixed


@dataclass
class ModelBundle:
    """The three models of the edit, their tokenizer, the checkpoint's
    scheduler config (empty: the SD scheduler) and the checkpoint directory
    they were loaded from (None: random init)."""

    unet: UNet3DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    tokenizer: Any = field(default_factory=WordTokenizer)
    scheduler_config: Dict[str, Any] = field(default_factory=dict)
    source_dir: Optional[str] = None

    def make_scheduler(self) -> DDIMScheduler:
        if self.scheduler_config:
            return DDIMScheduler.from_config(self.scheduler_config)
        return DDIMScheduler.create_sd()


def _random_models(ucfg: UNet3DConfig, vcfg: VAEConfig, ccfg: CLIPTextConfig, *,
                   dtype: torch.dtype, device, seed: int, need=(True, True, True)) -> list:
    """Seeded random-init UNet, VAE and text encoder on ``device`` (seeds
    ``seed``, ``seed + 1``, ``seed + 2``; None where ``need`` is False)."""
    out = []
    for i, (cls, cfg) in enumerate(((UNet3DConditionModel, ucfg), (AutoencoderKL, vcfg),
                                    (CLIPTextEncoder, ccfg))):
        model = None
        if need[i]:
            with torch.device(device):
                model = init_weights(cls(cfg), seed + i).to(dtype).eval()
        out.append(model)
    return out


def build_models(pretrained_model_path: Optional[str] = None, *, tiny: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0,
                 frame_attention: str = "auto",
                 gradient_checkpointing: bool = False) -> ModelBundle:
    """The models, on ``device``. A ``pretrained_model_path`` holding a
    ``unet/`` is a diffusers-layout checkpoint: it loads
    (``models/pipeline_io.py``) with its tokenizer and scheduler config; a
    VAE or text encoder it lacks is random-init (a Stage-1 run from random
    weights saves only the UNet), with a warning. Otherwise seeded random
    init, the SD-1.5 shapes (``UNet3DConfig.sd15()``) or the tiny test
    shapes, with a warning when a path was given. The weights depend on
    ``seed`` only; ``frame_attention`` picks the UNet's frame-attention
    implementation (``UNet3DConfig.frame_attention``: "auto", "flash_rect",
    "flash", "chunked" or "dense"), ``gradient_checkpointing`` its
    block-level recompute (Stage 1)."""
    if pretrained_model_path is not None and os.path.isdir(
            os.path.join(pretrained_model_path, "unet")):
        from videop2p_tpu_torch.models.pipeline_io import load_pipeline

        loaded = load_pipeline(pretrained_model_path, dtype=dtype, device=device,
                               frame_attention=frame_attention,
                               gradient_checkpointing=gradient_checkpointing, seed=seed)
        if loaded.inflation_report["kept_init"]:
            print(f"[build_models] inflated 2D checkpoint: "
                  f"{len(loaded.inflation_report['kept_init'])} temporal params keep init")
        vae, text = loaded.vae, loaded.text_encoder
        if vae is None or text is None:
            missing = "/".join(name for name, m in (("vae", vae), ("text_encoder", text))
                               if m is None)
            warnings.warn(f"checkpoint {pretrained_model_path!r} has no {missing} — "
                          "backfilling with RANDOM-INIT components", stacklevel=2)
            ucfg = loaded.unet.config
            small = ucfg.block_out_channels[0] < 64  # a tiny-shaped checkpoint
            vcfg = VAEConfig.tiny() if small else VAEConfig()
            ccfg = (CLIPTextConfig.tiny(hidden_size=ucfg.cross_attention_dim) if small
                    else CLIPTextConfig())
            _, new_vae, new_text = _random_models(
                ucfg, vcfg, ccfg, dtype=dtype, device=device, seed=seed,
                need=(False, vae is None, text is None))
            vae, text = vae or new_vae, text or new_text
        return ModelBundle(unet=loaded.unet, vae=vae, text_encoder=text,
                           tokenizer=load_tokenizer(pretrained_model_path),
                           scheduler_config=loaded.scheduler_config,
                           source_dir=pretrained_model_path)
    if pretrained_model_path is not None:
        warnings.warn(f"no checkpoint at {pretrained_model_path!r} — building RANDOM-INIT "
                      "models (smoke/benchmark mode; outputs will be noise)", stacklevel=2)
    ccfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig()
    unet_kw = dict(frame_attention=frame_attention,
                   gradient_checkpointing=gradient_checkpointing)
    ucfg = (UNet3DConfig.tiny(cross_attention_dim=ccfg.hidden_size, **unet_kw) if tiny
            else UNet3DConfig.sd15(**unet_kw))
    vcfg = VAEConfig.tiny() if tiny else VAEConfig()
    unet, vae, text = _random_models(ucfg, vcfg, ccfg, dtype=dtype, device=device, seed=seed)
    return ModelBundle(unet=unet, vae=vae, text_encoder=text)


@torch.no_grad()
def encode_prompts(bundle: ModelBundle, prompts: Sequence[str], device) -> torch.Tensor:
    """(P, 77, D) text embeddings."""
    ids = torch.tensor([bundle.tokenizer.encode_padded(p) for p in prompts],
                       dtype=torch.long, device=device)
    return bundle.text_encoder(ids)


def make_run_ledger(path: str, *, meta: Optional[Dict[str, Any]] = None, device=None):
    """The activated :class:`~videop2p_tpu_torch.obs.RunLedger` at ``path``,
    with execute timing on and scoped to this ledger (the subset of the JAX
    CLIs' wiring that the serving engine calls)."""
    from videop2p_tpu_torch.obs import RunLedger

    return RunLedger(path, meta={"latency": True, **(meta or {})}, latency=True,
                     device=device).activate()
