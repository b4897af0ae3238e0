"""Stage-1 one-shot tuning entry point (port of ``videop2p_tpu/cli/run_tuning.py``).

Flow: the clip's frames (``data/dataset.py:SingleVideoDataset``) → VAE
encode (a posterior draw) → CLIP text encode → ``max_train_steps`` steps of
``train/tuner.py:train_steps`` on the trainable subset (``attn1.to_q``,
``attn2.to_q``, ``attn_temp``), with the UNet's frame attention "chunked"
(as JAX's tuner builds it: no frame-attention kernel on this path) and its
GroupNorm the CUDA kernel. Every ``log_every`` steps the losses go to
``metrics.jsonl``; every ``checkpointing_steps`` a checkpoint to
``checkpoint-<step>``; every ``validation_steps`` (and at the end) a DDIM
inversion of the training latents (``inv_latents/ddim_latent-<step>.npy``)
and one sample per validation prompt from it (``samples/sample-<step>.gif``).
It ends by writing the diffusers-layout pipeline directory that
``run_videop2p`` loads, its scheduler the DDIM one with ``steps_offset`` 1.

``mixed_precision`` "bf16" (or "fp16", which maps to it) keeps float32
weights and Adam state and runs the UNet in bfloat16
(``UNet3DConditionModel.compute_dtype``), as JAX's flax layers do: the
export is float32, the frozen weights leave bit for bit as they came.
``gradient_checkpointing`` recomputes each UNet block in the backward.
``output_dir`` takes the Stage-1 suffix of the dependent-noise flags.
SIGTERM or SIGINT stops the run at the next chunk boundary with a
checkpoint; ``resume_from_checkpoint: latest`` continues it with the same
bits as an uninterrupted run. ``steps_per_call`` sets how often the losses
are synchronised to the host.

``--distill_steps N`` then consistency-distils the few-step student from
the tuned pipeline (:func:`run_distillation`, ``train/distill.py``) and
writes it to ``<pipeline_dir>/student/checkpoint-<N>``.

Not ported: ``mesh`` (multi-GPU, ROADMAP Queue 1 item 13); it raises.

Run:  python -m videop2p_tpu_torch.cli.run_tuning --config configs/rabbit-jump-tune.yaml
      [--dependent --decay_rate 0.3 --window_size 4 --ar_sample ...] [--device cpu] [--tiny]
      [--distill_steps N [--distill_grid 50] [--distill_lr 1e-4] [--distill_ema 0.95]
                         [--distill_boundary_weight 1.0]]

then Stage 2 on its output:
      python -m videop2p_tpu_torch.cli.run_videop2p --config configs/rabbit-jump-p2p.yaml
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from videop2p_tpu_torch.cli.common import (
    add_dependent_args,
    add_unported_args,
    build_models,
    dependent_suffix,
    deterministic_convolutions,
    encode_prompts,
    load_config,
)
from videop2p_tpu_torch.core import DDIMScheduler, DDPMScheduler, DependentNoiseSampler
from videop2p_tpu_torch.data import SingleVideoDataset
from videop2p_tpu_torch.models.pipeline_io import save_pipeline
from videop2p_tpu_torch.models.vae import decode_video, encode_video
from videop2p_tpu_torch.pipelines.inversion import ddim_inversion
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn
from videop2p_tpu_torch.train import (
    DEFAULT_TRAINABLE,
    DistillConfig,
    DistillState,
    TrainState,
    TuneConfig,
    init_time_head,
    latest_checkpoint,
    make_distill_optimizer,
    make_lr_schedule,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    save_student,
    train_steps,
)
# the loop under another name: run_distillation's argument is distill_steps
from videop2p_tpu_torch.train import distill_steps as distill_loop
from videop2p_tpu_torch.utils.metrics import MetricsLogger
from videop2p_tpu_torch.utils.profiling import phase_timer
from videop2p_tpu_torch.utils.video_io import save_videos_grid

__all__ = ["main", "run_distillation", "deterministic_convolutions"]

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16, "no": torch.float32}
# the scheduler config of the exported pipeline (JAX's, and the reference's)
_EXPORT_SCHEDULER_CONFIG = {
    "_class_name": "DDIMScheduler",
    "beta_start": 0.00085,
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "clip_sample": False,
    "set_alpha_to_one": False,
    "steps_offset": 1,
}

# SIGTERM/SIGINT set this event; the training loop checks it at every chunk
# boundary, saves a checkpoint there and returns
_PREEMPT_EVENT = threading.Event()


def _preempt_handler(signum, frame):
    _PREEMPT_EVENT.set()


def _install_preempt_handlers():
    """Install SIGTERM/SIGINT → checkpoint-then-exit; returns a callable that
    restores the previous handlers. Off the main thread (where the signal
    API refuses) it installs nothing."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _preempt_handler)
        except (ValueError, OSError):
            continue

    def _restore():
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                continue
    return _restore


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(
    pretrained_model_path: str,
    output_dir: str,
    train_data: Dict[str, Any],
    validation_data: Dict[str, Any],
    learning_rate: float = 3e-5,
    train_batch_size: int = 1,
    max_train_steps: int = 500,
    checkpointing_steps: int = 1000,
    validation_steps: int = 500,
    trainable_modules=DEFAULT_TRAINABLE,
    seed: Optional[int] = None,
    mixed_precision: str = "fp16",
    gradient_checkpointing: bool = True,
    gradient_accumulation_steps: int = 1,
    max_grad_norm: float = 1.0,
    lr_scheduler: str = "constant",
    lr_warmup_steps: int = 0,
    scale_lr: bool = False,
    resume_from_checkpoint: Optional[str] = None,
    prediction_type: str = "epsilon",
    dependent: bool = False,
    num_frames: int = 60,
    decay_rate: float = 0.1,
    window_size: int = 60,
    ar_sample: bool = False,
    ar_coeff: float = 0.1,
    eta: float = 0.0,
    dependent_weights: float = 0.0,
    mesh: Optional[str] = None,
    tiny: bool = False,
    log_every: int = 50,
    steps_per_call: int = 100,
    device: str = "cuda",
    **unused,
) -> str:
    """Tune, validate and export; returns the (suffixed) output directory.
    The arguments are the YAML config's keys and the dependent flags."""
    del unused
    if mesh:
        raise NotImplementedError(
            f"mesh {mesh!r}: multi-GPU tuning is not ported (ROADMAP Queue 1 item 13)")
    if mixed_precision not in _DTYPES:
        raise ValueError(f"mixed_precision must be one of {sorted(_DTYPES)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    # full float32 products and convolutions (cuDNN's default for float32
    # convolutions is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_frames = int(train_data.get("n_sample_frames", 8))
    output_dir = output_dir + dependent_suffix(
        dependent=dependent, decay_rate=decay_rate, window_size=window_size,
        ar_sample=ar_sample, ar_coeff=ar_coeff, eta=eta,
        dependent_weights=dependent_weights)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump({k: v for k, v in locals().items()
                   if isinstance(v, (str, int, float, bool, dict, list, tuple, type(None)))},
                  f, indent=2, default=str)
    run_seed = seed if seed is not None else 0

    sampler = None
    if dependent:
        if num_frames != n_frames:
            print(f"[tune] dependent sampler uses the clip's {n_frames} frames "
                  f"(--num_frames {num_frames} would not match the data)")
        sampler = DependentNoiseSampler.create(
            num_frames=n_frames, decay_rate=decay_rate,
            window_size=min(window_size, n_frames), ar_sample=ar_sample,
            ar_coeff=ar_coeff, device=device)

    # float32 weights (what the optimizer updates and the export writes);
    # the UNet computes in `dtype`, the frozen VAE and text encoder run in it
    dtype = _DTYPES[mixed_precision]
    bundle = build_models(pretrained_model_path, dtype=torch.float32, device=device,
                          frame_attention="chunked",
                          gradient_checkpointing=gradient_checkpointing, tiny=tiny,
                          seed=run_seed)
    if dtype != torch.float32:
        bundle.unet.compute_dtype = dtype
        bundle.vae.to(dtype)
        bundle.text_encoder.to(dtype)

    latents, text_emb = _clip_latents(bundle, train_data, run_seed, device)

    tune_cfg = TuneConfig(
        learning_rate=learning_rate, scale_lr=scale_lr, lr_scheduler=lr_scheduler,
        lr_warmup_steps=lr_warmup_steps, max_train_steps=max_train_steps,
        max_grad_norm=max_grad_norm,
        gradient_accumulation_steps=gradient_accumulation_steps,
        trainable_modules=tuple(trainable_modules), train_batch_size=train_batch_size)
    tx = make_optimizer(tune_cfg)
    state = TrainState.create(bundle.unet, tx, tune_cfg.trainable_modules)

    first_step = 0
    if resume_from_checkpoint:
        path = (latest_checkpoint(output_dir) if resume_from_checkpoint == "latest"
                else resume_from_checkpoint)
        if path:
            restore_checkpoint(path, state, seed=run_seed)
            first_step = state.step
            print(f"[tune] resumed from {path} at step {first_step}")

    noise_sched = DDPMScheduler.create_sd(prediction_type=prediction_type)
    unet_fn = make_unet_fn(bundle.unet)
    lr_schedule = make_lr_schedule(tune_cfg)
    metrics = MetricsLogger(output_dir)
    losses: List[torch.Tensor] = []

    def flush_losses(next_step: int) -> float:
        # one device → host copy for the whole buffer
        flat = torch.cat(losses).cpu().numpy()
        start = next_step - len(flat)
        for j, value in enumerate(flat):
            metrics.log(start + j + 1, {"train_loss": float(value),
                                        "lr": float(lr_schedule(start + j))})
        losses.clear()
        return float(flat[-1])

    # chunks end on every log / checkpoint / validation boundary; a cadence
    # of 0 or None turns that feature off. steps_per_call is rounded down to
    # divide the cadences' gcd where that keeps a chunk of at least 5 steps
    # (JAX's rule: there, each chunk length is a compiled program)
    steps_per_call = max(int(steps_per_call), 1)
    cadences = [p for p in (log_every, checkpointing_steps, validation_steps) if p and p > 0]
    g = math.gcd(*cadences) if cadences else steps_per_call
    if g > 1 and steps_per_call % g and g % steps_per_call:
        aligned = math.gcd(steps_per_call, g)
        if aligned >= 5:
            print(f"[tune] steps_per_call {steps_per_call} → {aligned} to align with "
                  f"the log/checkpoint/validation cadences (gcd {g})")
            steps_per_call = aligned
    t0 = time.perf_counter()
    i = first_step
    preempted = False
    restore_signals = _install_preempt_handlers()
    try:
        with deterministic_convolutions():
            while i < max_train_steps:
                nxt = min([max_train_steps, i + steps_per_call]
                          + [(i // p + 1) * p for p in cadences])
                _, chunk = train_steps(unet_fn, tx, state, noise_sched, latents, text_emb,
                                       run_seed, num_steps=nxt - i,
                                       dependent_sampler=sampler)
                losses.append(chunk)
                first_chunk = i == first_step
                i = nxt
                if _PREEMPT_EVENT.is_set():
                    preempted = True
                    break
                if (log_every and i % log_every == 0) or i == max_train_steps or first_chunk:
                    loss = flush_losses(i)
                    rate = (i - first_step) / max(time.perf_counter() - t0, 1e-9)
                    print(f"[tune] step {i}/{max_train_steps} loss={loss:.4f} "
                          f"({rate:.2f} it/s)")
                if checkpointing_steps and i % checkpointing_steps == 0:
                    save_checkpoint(output_dir, state, i, seed=run_seed)
                if (validation_steps and i % validation_steps == 0) or i == max_train_steps:
                    _validate(bundle, latents, validation_data, output_dir, i,
                              dependent_weights=dependent_weights, sampler=sampler,
                              text_emb=text_emb, seed=run_seed, device=device)
    finally:
        restore_signals()
    if preempted:
        if losses:
            flush_losses(i)
        metrics.close()
        ckpt_path = save_checkpoint(output_dir, state, i, seed=run_seed)
        print(f"[tune] preempted at step {i}: checkpoint saved to {ckpt_path}; "
              "resume with resume_from_checkpoint: latest")
        return output_dir
    if losses:
        flush_losses(max_train_steps)
    metrics.close()

    with phase_timer("export"):
        nbytes = save_pipeline(output_dir, bundle.unet.config, state.params,
                               source_dir=bundle.source_dir,
                               scheduler_config=dict(_EXPORT_SCHEDULER_CONFIG))
    print(f"[tune] saved pipeline to {output_dir} (unet {nbytes} bytes)")
    return output_dir


def _clip_latents(bundle, train_data: Dict[str, Any], seed: int,
                  device: torch.device) -> tuple:
    """The clip's latents (1, F, h, w, C), a VAE posterior draw seeded from
    ``seed``, and its prompt's text embedding (1, 77, D)."""
    ds = SingleVideoDataset(
        video_path=train_data["video_path"],
        prompt=train_data["prompt"],
        width=int(train_data.get("width", 512)),
        height=int(train_data.get("height", 512)),
        n_sample_frames=int(train_data.get("n_sample_frames", 8)),
        sample_start_idx=int(train_data.get("sample_start_idx", 0)),
        sample_frame_rate=int(train_data.get("sample_frame_rate", 1)),
    )
    video = torch.as_tensor(ds.load(), device=device)[None]  # (1, F, H, W, 3)
    with torch.no_grad(), phase_timer("vae_encode"):
        latents = encode_video(bundle.vae, video,
                               torch.Generator(device).manual_seed(seed)).float()
        _sync(device)
    return latents, encode_prompts(bundle, [train_data["prompt"]], device)


def run_distillation(pipeline_dir: str, train_data: Dict[str, Any], *, distill_steps: int,
                     distill_grid: int = 50, distill_lr: float = 1e-4,
                     distill_ema: float = 0.95, distill_boundary_weight: float = 1.0,
                     tiny: bool = False, seed: Optional[int] = None,
                     steps_per_call: int = 50, device: str = "cuda") -> str:
    """Consistency-distil the few-step student from a tuned pipeline
    directory (``train/distill.py``): its UNet, built in float32 with
    "chunked" frame attention as Stage 1's, is the frozen teacher; the
    student trains Stage 1's parameter subset and the time head on the
    latents of the clip Stage 1 tuned on. Prints a ``[distill] step i/N``
    line every ``steps_per_call`` steps and at the end, and writes the
    student to ``<pipeline_dir>/student/checkpoint-<distill_steps>``;
    returns that path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_seed = seed if seed is not None else 0
    bundle = build_models(pipeline_dir, dtype=torch.float32, device=device,
                          frame_attention="chunked", tiny=tiny, seed=run_seed)
    latents, text_emb = _clip_latents(bundle, train_data, run_seed, device)
    cfg = DistillConfig(learning_rate=distill_lr, max_train_steps=distill_steps,
                        distill_grid=distill_grid, ema_decay=distill_ema,
                        boundary_weight=distill_boundary_weight)
    tx = make_distill_optimizer(cfg)
    head = init_time_head(torch.Generator(device).manual_seed(run_seed + 1),
                          bundle.unet.config)
    state = DistillState.create(bundle.unet, head, tx, cfg.trainable_modules)
    sched = bundle.make_scheduler()  # the DDIM grid the student walks
    unet_fn = make_unet_fn(bundle.unet)
    steps_per_call = max(int(steps_per_call), 1)
    i, t0 = 0, time.perf_counter()
    with deterministic_convolutions(), phase_timer("distill_steps"):
        while i < distill_steps:
            n = min(steps_per_call, distill_steps - i)
            _, losses = distill_loop(unet_fn, tx, state, sched, latents, text_emb, run_seed,
                                     num_steps=n, cfg=cfg)
            i += n
            loss = float(losses[-1])
            rate = i / max(time.perf_counter() - t0, 1e-9)
            print(f"[distill] step {i}/{distill_steps} loss={loss:.5f} ({rate:.2f} it/s)")
    path = save_student(os.path.join(pipeline_dir, "student"), state, i)
    print(f"[distill] saved student to {path}")
    return path


def _validate(bundle, latents: torch.Tensor, validation_data: Dict[str, Any],
              output_dir: str, step: int, *, dependent_weights: float,
              sampler: Optional[DependentNoiseSampler], text_emb: torch.Tensor,
              seed: int, device: torch.device) -> None:
    """DDIM-invert the training latents (blended with the dependent noise at
    ``dependent_weights``), store x_T, sample each validation prompt from it
    at ``guidance_scale`` and write the samples as one GIF grid (skipped
    with a note without imageio)."""
    num_inv = int(validation_data.get("num_inv_steps", 50))
    num_steps = int(validation_data.get("num_inference_steps", 50))
    guidance = float(validation_data.get("guidance_scale", 12.5))
    use_inv = bool(validation_data.get("use_inv_latent", True))
    prompts: List[str] = list(validation_data.get("prompts", []))
    unet_fn = make_unet_fn(bundle.unet)
    sched = DDIMScheduler.create_sd()
    gen = torch.Generator(device).manual_seed(seed)
    videos = []
    with torch.no_grad(), phase_timer("validation"):
        if use_inv:
            x_t = ddim_inversion(
                unet_fn, sched, latents, text_emb, num_inference_steps=num_inv,
                dependent_weight=dependent_weights,
                dependent_sampler=sampler if dependent_weights > 0 else None,
                generator=gen)[-1]
            inv_dir = os.path.join(output_dir, "inv_latents")
            os.makedirs(inv_dir, exist_ok=True)
            np.save(os.path.join(inv_dir, f"ddim_latent-{step}.npy"), x_t.cpu().numpy())
        else:
            x_t = torch.randn(latents.shape, generator=gen, device=device)
        uncond = encode_prompts(bundle, [""], device)[0]
        for prompt in prompts:
            cond = encode_prompts(bundle, [prompt], device)
            out = edit_sample(unet_fn, sched, x_t, cond, uncond,
                              num_inference_steps=num_steps, guidance_scale=guidance)
            frames = decode_video(bundle.vae, out).float()
            videos.append(((frames + 1) / 2)[0].cpu().numpy())
        _sync(device)
    if videos:
        try:
            import imageio  # noqa: F401
        except ImportError:
            print("[tune] imageio is not installed: no validation GIF written")
            return
        path = save_videos_grid(np.stack(videos),
                                os.path.join(output_dir, "samples", f"sample-{step}.gif"))
        print(f"[tune] validation saved {path}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--tiny", action="store_true",
                        help="random-init tiny models (smoke mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--distill_steps", type=int, default=0,
                        help="consistency-distillation steps to run after tuning "
                             "(0 = off); writes the few-step student to "
                             "<output_dir>/student/checkpoint-<N>")
    parser.add_argument("--distill_grid", type=int, default=50,
                        help="DDIM grid points the self-consistency chain walks "
                             "(the teacher's solver discretization)")
    parser.add_argument("--distill_lr", type=float, default=1e-4,
                        help="student learning rate (Stage 1's clipped AdamW)")
    parser.add_argument("--distill_ema", type=float, default=0.95,
                        help="EMA decay of the consistency target network")
    parser.add_argument("--distill_boundary_weight", type=float, default=1.0,
                        help="loss weight of the boundary term (final grid point, "
                             "target = the data x0)")
    add_dependent_args(parser)
    add_unported_args(parser)
    args = parser.parse_args()
    cfg = load_config(args.config)
    out_dir = main(**cfg, tiny=args.tiny, device=args.device,
                   dependent=args.dependent, num_frames=args.num_frames,
                   decay_rate=args.decay_rate, window_size=args.window_size,
                   ar_sample=args.ar_sample, ar_coeff=args.ar_coeff, eta=args.eta,
                   dependent_weights=args.dependent_weights)
    if args.distill_steps > 0:
        run_distillation(out_dir, cfg["train_data"], distill_steps=args.distill_steps,
                         distill_grid=args.distill_grid, distill_lr=args.distill_lr,
                         distill_ema=args.distill_ema,
                         distill_boundary_weight=args.distill_boundary_weight,
                         tiny=args.tiny, seed=cfg.get("seed"), device=args.device)
