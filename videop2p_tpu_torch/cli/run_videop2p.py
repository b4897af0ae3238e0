"""Stage-2 attention-controlled editing entry point (port of
``videop2p_tpu/cli/run_videop2p.py``).

Flow: frames → VAE encode (posterior mean) → CLIP text encode → controller
(refine or replace, equalizer, LocalBlend) → the edit → VAE decode → GIFs of
the reconstruction and the edit. The edit is one of:

  * official mode (no ``--fast``, the reference's): a DDIM inversion, then
    ``pipelines/sampling.py:official_edit``: null-text optimization of the
    source stream's uncond embedding (a backward through the UNet per inner
    step), then the controlled edit in the full CFG layout with those
    embeddings injected;
  * ``--fast``: by default the cached-source fast edit
    (``pipelines/fast.py:cached_fast_edit``): a DDIM inversion that
    captures the source stream's attention maps, then a controlled edit of
    the P − 1 edit streams only, stream 0 replaying the inversion exactly.
    It falls back to the live-source edit, as the JAX package does, when
    the captured maps exceed the budget;
  * ``--fast --live_source``: a plain DDIM inversion, then one
    ``edit_sample`` with the fast CFG layout (the source stream in the
    batch, replaying its cond-only prediction). ``--eta`` > 0 (stochastic
    DDIM steps, noise seeded from ``--seed``) takes this path in fast mode,
    as the JAX CLI does: the cached replay is deterministic.

The fork's dependent noise (``--dependent_p2p`` with ``--decay_rate``,
``--window_size``, ``--ar_sample``, ``--ar_coeff``, ``--dependent_weights``):
every UNet prediction of the inversion and of null-text optimization is
blended with frame-correlated noise (``core/noise.py``), and with ``--eta``
> 0 the edit's step noise is drawn from the same sampler.

The checkpoint is ``pretrained_model_path`` with the Stage-1 suffix of the
dependent settings appended (``cli/common.py:resolve_pipeline_dir``): a
diffusers-layout directory loads (``models/pipeline_io.py``), its scheduler
from its ``scheduler_config.json``; without one the models are random-init
at SD-1.5 width (seeded), with a warning. The GIFs go to
``<checkpoint>/results_dp{dependent_p2p}``, as the JAX CLI writes them.

Run:  python -m videop2p_tpu_torch.cli.run_videop2p \\
          --config configs/rabbit-jump-p2p.yaml [--fast [--live_source]] \\
          [--dependent --dependent_p2p --decay_rate 0.3 --window_size 4 \\
           --ar_sample --ar_coeff 0.1 --dependent_weights 0.2] [--eta 0.1]

The run is on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from videop2p_tpu_torch.cli.common import (
    ModelBundle,
    add_dependent_args,
    build_models,
    encode_prompts,
    load_config,
    resolve_pipeline_dir,
)
from videop2p_tpu_torch.control.controllers import make_controller
from videop2p_tpu_torch.core.noise import DependentNoiseSampler
from videop2p_tpu_torch.data.dataset import load_frame_sequence
from videop2p_tpu_torch.models.vae import decode_video, encode_video
from videop2p_tpu_torch.pipelines.cached import capture_windows
from videop2p_tpu_torch.pipelines.fast import (
    CACHED_MAPS_BUDGET_GB,
    cached_fast_edit,
    capture_bytes,
    choose_cached_maps,
)
from videop2p_tpu_torch.pipelines.inversion import (
    NULL_TEXT_PRECISIONS,
    check_null_text_options,
    ddim_inversion,
)
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn, official_edit
from videop2p_tpu_torch.utils.video_io import save_video_gif

__all__ = ["ModelBundle", "build_models", "encode_prompts", "main",
           "NUM_DDIM_STEPS", "GUIDANCE_SCALE", "MASK_TH"]

NUM_DDIM_STEPS = 50
GUIDANCE_SCALE = 7.5
MASK_TH = (0.3, 0.3)
_DTYPES = {"fp32": torch.float32, "no": torch.float32,
           "bf16": torch.bfloat16, "fp16": torch.bfloat16}


@contextlib.contextmanager
def _phase(name: str, timings: Dict[str, float], device: torch.device,
           peaks: Dict[str, float]):
    """Wall time of a phase, synchronised with the card on both ends, and on
    the card the phase's peak allocated memory in GiB."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peaks[name] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    timings[name] = time.perf_counter() - t0


def main(
    pretrained_model_path: str,
    image_path: str,
    prompt: str,
    prompts: Sequence[str],
    save_name: str,
    is_word_swap: bool,
    eq_params: Optional[Dict] = None,
    blend_word: Optional[Sequence[str]] = None,
    cross_replace_steps: float = 0.2,
    self_replace_steps: float = 0.5,
    video_len: int = 8,
    fast: bool = False,
    live_source: bool = False,
    mixed_precision: str = "fp32",
    device: str = "cuda",
    width: int = 512,
    tiny: bool = False,
    seed: int = 0,
    num_ddim_steps: int = NUM_DDIM_STEPS,
    frames: Optional[np.ndarray] = None,
    bundle: Optional[ModelBundle] = None,
    save_gifs: bool = True,
    num_inner_steps: int = 10,
    null_text_precision: str = "fp32",
    null_text_mode: str = "optimize",
    eta: float = 0.0,
    dependent: bool = False,
    dependent_p2p: bool = False,
    num_frames: int = 60,
    decay_rate: float = 0.1,
    window_size: int = 60,
    ar_sample: bool = False,
    ar_coeff: float = 0.1,
    dependent_weights: float = 0.0,
    **unused,
) -> Dict[str, Any]:
    """Run the edit: official mode unless ``fast``; with ``fast`` the
    cached-source edit, or the live-source one with ``live_source``.
    ``frames`` (F, H, W, 3) uint8 replaces loading ``image_path``; ``bundle``
    replaces the models of the checkpoint directory (its modules must
    already be on ``device``; its scheduler config sets the scheduler).
    ``num_inner_steps``, ``null_text_precision`` ("fp32" or "mixed": the
    null-text forwards and backward on a bf16 clone of the UNet) and
    ``null_text_mode`` ("optimize" or "amortized") set official mode's
    null-text optimization. ``eta`` > 0 makes the edit's DDIM steps
    stochastic (in fast mode it takes the live-source edit).

    The dependent noise, as the JAX CLI: a sampler over the clip's
    ``video_len`` frames in windows of ``min(window_size, video_len)``
    (``decay_rate``, ``ar_sample``, ``ar_coeff``) when ``dependent_p2p``, or
    ``dependent`` with ``eta`` > 0; with ``dependent_p2p`` the inversion's
    and null-text's predictions are blended with it at weight
    ``dependent_weights``, and an ``eta`` > 0 edit draws its step noise from
    it. ``num_frames`` is the Stage-1 flag, unused here. The checkpoint
    directory is ``pretrained_model_path`` resolved with those settings'
    suffix (``cli/common.py:resolve_pipeline_dir``). One generator a phase
    (inversion, null-text, edit) on ``device``, seeded from ``seed``.

    Returns the edited latents (stream 0 the source's reconstruction), the
    inversion's ``x_0`` and ``x_t``, the decoded videos (2, F, H, W, 3) in
    [0, 1], the mode run (``"official"``, ``"cached"`` or ``"live"``), the
    cached-maps decision, the null-text record (official mode:
    ``final_loss`` and ``inner_steps`` per outer step, else None), the phase
    times in seconds, each phase's peak memory on the card, the checkpoint
    directory, the results directory and the GIF paths written."""
    del unused, num_frames
    if mixed_precision not in _DTYPES:
        raise ValueError(f"mixed_precision must be one of {sorted(_DTYPES)}")
    if not fast:
        check_null_text_options(null_text_precision, null_text_mode)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    # full float32 products and convolutions (cuDNN's default for float32
    # convolutions is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = _DTYPES[mixed_precision]
    if tiny and width == 512:
        # the tiny VAE downsamples 2x: keep latents at the tiny UNet's 8x8
        width = 16
    pretrained_model_path = resolve_pipeline_dir(
        pretrained_model_path, dependent=dependent, decay_rate=decay_rate,
        window_size=window_size, ar_sample=ar_sample, ar_coeff=ar_coeff, eta=eta,
        dependent_weights=dependent_weights)
    output_dir = os.path.join(pretrained_model_path, f"results_dp{dependent_p2p}")
    sampler = None
    if dependent_p2p or (dependent and eta > 0):
        sampler = DependentNoiseSampler.create(
            num_frames=video_len, decay_rate=decay_rate,
            window_size=min(window_size, video_len), ar_sample=ar_sample,
            ar_coeff=ar_coeff, device=device)
    dep_w = dependent_weights if dependent_p2p else 0.0
    # the walks draw from it only at a weight > 0, the edit only at η > 0
    p2p_sampler = sampler if dependent_p2p else None
    gens = {name: torch.Generator(device).manual_seed(seed + k)
            for k, name in enumerate(("edit", "inversion", "null_text"))}
    timings: Dict[str, float] = {}
    peaks: Dict[str, float] = {}

    if bundle is None:
        with _phase("build_models", timings, device, peaks):
            bundle = build_models(pretrained_model_path, tiny=tiny, dtype=dtype,
                                  device=device, seed=seed)
    unet_fn = make_unet_fn(bundle.unet)
    sched = bundle.make_scheduler()
    if frames is None:
        frames = load_frame_sequence(image_path, size=width, num_frames=video_len)
    video = torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                            device=device)[None] / 127.5 - 1.0

    with torch.no_grad():
        with _phase("vae_encode", timings, device, peaks):
            latents = encode_video(bundle.vae, video).float()
        with _phase("text_encode", timings, device, peaks):
            cond_src = encode_prompts(bundle, [prompt], device)
            cond_all = encode_prompts(bundle, list(prompts), device)
            uncond = encode_prompts(bundle, [""], device)[0]
        blend_words = ((blend_word[0],), (blend_word[1],)) if blend_word else None
        ctx = make_controller(
            list(prompts), bundle.tokenizer, num_ddim_steps,
            is_replace_controller=bool(is_word_swap),
            cross_replace_steps=cross_replace_steps,
            self_replace_steps=self_replace_steps, blend_words=blend_words,
            equalizer_params=dict(eq_params) if eq_params else None,
            mask_th=MASK_TH, device=device)
        mode, decision, null_stats = "live", None, None
        if not fast:
            mode = "official"
        elif not live_source and eta == 0:
            # outside these windows the gates multiply the base maps out, so
            # nothing else is captured
            cross_len, self_window = capture_windows(ctx, num_ddim_steps)
            # the JAX CLI's override of the budget
            budget_gb = float(os.environ.get("VIDEOP2P_CACHED_MAPS_BUDGET_GB",
                                             CACHED_MAPS_BUDGET_GB))
            fits, tm_dtype, map_gb = choose_cached_maps(
                lambda dt: capture_bytes(
                    bundle.unet, latents.shape, cond_src.shape[-2],
                    cross_len=cross_len, self_window=self_window,
                    temporal_maps_dtype=dt),
                budget_gb=budget_gb)
            stored = "bfloat16" if tm_dtype is None else str(tm_dtype).replace("torch.", "")
            decision = {"fits": fits, "gib": map_gb, "budget_gib": budget_gb,
                        "temporal_maps_dtype": stored, "cross_len": cross_len,
                        "self_window": self_window}
            if fits:
                mode = "cached"
                print(f"[p2p] cached-source fast mode: cross window {cross_len} "
                      f"steps, self window {self_window}, maps {map_gb:.2f} GiB "
                      f"(budget {budget_gb:.1f} GiB), temporal maps "
                      f"stored {stored}")
            else:
                print(f"[p2p] cached-source maps need {map_gb:.1f} GiB even with "
                      f"1-byte temporal maps (> budget {budget_gb:.1f} "
                      "GiB) — falling back to the live source stream")
        if mode == "cached":
            with _phase("cached_invert_edit", timings, device, peaks):
                trajectory, edited = cached_fast_edit(
                    unet_fn, sched, latents, cond_src, cond_all, uncond, ctx,
                    num_inference_steps=num_ddim_steps,
                    guidance_scale=GUIDANCE_SCALE, cross_len=cross_len,
                    self_window=self_window, temporal_maps_dtype=tm_dtype,
                    dependent_weight=dep_w, dependent_sampler=p2p_sampler,
                    generator=gens["inversion"])
        else:
            with _phase("ddim_inversion", timings, device, peaks):
                trajectory = ddim_inversion(unet_fn, sched, latents, cond_src,
                                            num_inference_steps=num_ddim_steps,
                                            dependent_weight=dep_w,
                                            dependent_sampler=p2p_sampler,
                                            generator=gens["inversion"])
            if mode == "official":
                edited, null_stats = official_edit(
                    unet_fn, sched, trajectory, cond_all, uncond,
                    num_inference_steps=num_ddim_steps, guidance_scale=GUIDANCE_SCALE,
                    ctx=ctx, num_inner_steps=num_inner_steps,
                    null_text_precision=null_text_precision,
                    null_text_mode=null_text_mode, eta=eta, generator=gens["edit"],
                    dependent_weight=dep_w,
                    dependent_sampler=p2p_sampler,
                    null_text_generator=gens["null_text"], source_embedding=cond_src,
                    phase=lambda name: _phase(name, timings, device, peaks))
                print(f"[p2p] null-text ({null_text_mode}/{null_text_precision}): "
                      f"{int(null_stats['inner_steps'].sum())} inner Adam steps across "
                      f"{num_ddim_steps} outer steps, final loss "
                      f"{float(null_stats['final_loss'][-1]):.3e}")
            else:
                with _phase("edit_sample", timings, device, peaks):
                    edited = edit_sample(unet_fn, sched, trajectory[-1], cond_all, uncond,
                                         num_inference_steps=num_ddim_steps,
                                         guidance_scale=GUIDANCE_SCALE, ctx=ctx,
                                         source_uses_cfg=False, eta=eta,
                                         generator=gens["edit"],
                                         dependent_sampler=p2p_sampler)
        with _phase("vae_decode", timings, device, peaks):
            videos = (decode_video(bundle.vae, edited).float() + 1.0) / 2.0

    gifs = _write_gifs(videos, output_dir, save_name, fast) if save_gifs else ()
    print("[p2p] phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
    return {"latents": edited, "x_0": trajectory[0], "x_t": trajectory[-1],
            "videos": videos, "mode": mode, "cached_maps": decision,
            "null_text": null_stats, "timings": timings, "peak_gib": peaks,
            "checkpoint_dir": pretrained_model_path, "output_dir": output_dir,
            "gifs": gifs}


def _write_gifs(videos: torch.Tensor, output_dir: str, save_name: str, fast: bool):
    """GIFs of the reconstruction and the edit, 4 fps, under ``output_dir``
    (names suffixed ``_fast`` in fast mode, as the JAX CLI's); skipped with
    a note when imageio is not installed."""
    try:
        import imageio.v3  # noqa: F401
    except ImportError:
        print("[p2p] imageio is not installed: no GIF written")
        return ()
    frames = (videos.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    suffix = "_fast" if fast else ""
    paths = (os.path.join(output_dir, f"inversion{suffix}.gif"),
             os.path.join(output_dir, f"{save_name}{suffix}.gif"))
    for video, path in zip(frames, paths):
        save_video_gif(video, path)
    print(f"[p2p] wrote {paths[0]} and {paths[1]}")
    return paths


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="./configs/rabbit-jump-p2p.yaml")
    parser.add_argument("--fast", action="store_true",
                        help="the fast edit (default: official mode, null-text "
                             "optimization and the full-CFG edit)")
    parser.add_argument("--dependent_p2p", default=False, action="store_true",
                        help="blend the inversion's and null-text's predictions "
                             "with frame-correlated noise (--dependent_weights), "
                             "and draw an --eta > 0 edit's noise from it")
    parser.add_argument("--live_source", action="store_true",
                        help="keep the live source stream in fast mode "
                             "(default: the cached-source edit)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions of "
                             "the kernels")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=sorted(_DTYPES),
                        help="model compute dtype (default fp32)")
    parser.add_argument("--tiny", action="store_true",
                        help="random-init tiny models (smoke mode)")
    parser.add_argument("--steps", type=int, default=NUM_DDIM_STEPS,
                        help="DDIM steps of the inversion and of the edit")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_inner_steps", type=int, default=None,
                        help="official mode: inner Adam steps per outer step "
                             "(default 10, the reference's)")
    # defaults are None so that a config file's value wins when a flag is
    # unset (the JAX CLI's add_null_text_args)
    parser.add_argument("--null_text_precision", type=str, default=None,
                        choices=list(NULL_TEXT_PRECISIONS),
                        help="official mode: fp32 (default) or mixed (bf16 UNet "
                             "forwards and backward; scheduler, Adam and loss in "
                             "fp32)")
    parser.add_argument("--null_text_mode", type=str, default=None,
                        choices=["optimize", "amortized"],
                        help="official mode: optimize (default, the reference's "
                             "inner Adam loop) or amortized (uncond := cond, one "
                             "forward per outer step)")
    # --dependent, --ar_sample, --decay_rate, --window_size, --ar_coeff,
    # --loss_sig, --num_frames, --eta (the edit's DDIM η, default 0; > 0
    # draws its noise from --seed) and --dependent_weights
    add_dependent_args(parser)
    args = parser.parse_args()
    cfg = load_config(args.config)
    for key in ("mixed_precision", "num_inner_steps", "null_text_precision",
                "null_text_mode"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    main(**cfg, fast=args.fast, live_source=args.live_source, device=args.device,
         tiny=args.tiny, seed=args.seed, num_ddim_steps=args.steps,
         dependent=args.dependent, dependent_p2p=args.dependent_p2p,
         num_frames=args.num_frames, decay_rate=args.decay_rate,
         window_size=args.window_size, ar_sample=args.ar_sample,
         ar_coeff=args.ar_coeff, eta=args.eta,
         dependent_weights=args.dependent_weights)
