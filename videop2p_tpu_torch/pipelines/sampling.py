"""The attention-controlled denoising loop (port of ``make_unet_fn``,
``edit_sample`` and ``_edit_sample_cached``,
``videop2p_tpu/pipelines/sampling.py:135-827``).

A Python loop over the DDIM steps in the fast CFG layout: the batch puts
U = P − 1 uncond streams ahead of the P cond streams (the source stream
replays its cond-only prediction, so its uncond forward is not run); the
controller sees every cross/temporal
site through :class:`AttnControl`; LocalBlend runs after each scheduler step
on the running sum of the blend-site maps. Latents and scheduler math stay
float32. The pipeline works in latent space only.

With a ``cached_source`` the source stream leaves the batch: its latents
replay the inversion trajectory and its maps come from the capture
(:mod:`videop2p_tpu_torch.pipelines.cached`), so only the E = P − 1 edit
streams run the UNet, behind their E uncond streams.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from videop2p_tpu_torch.control.controllers import ControlContext
from videop2p_tpu_torch.control.local_blend import local_blend
from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.models.attention import AttnControl
from videop2p_tpu_torch.pipelines.cached import CachedSource
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["edit_sample", "make_unet_fn", "UNetFn"]

# (sample, t, text, control, *, store) -> (eps, store or None)
UNetFn = Callable[..., Tuple[torch.Tensor, Optional[dict]]]


def make_unet_fn(model) -> UNetFn:
    """Adapter from the UNet module to the pipelines' callable contract:
    ``fn(sample, t, text, control=None, *, store=True)`` returns
    ``(eps, store)``, the store being the dict of head-mean maps of the
    controlled sites (None when ``store=False``)."""

    def fn(sample, t, text, control=None, *, store: bool = True):
        maps = {} if store else None
        return model(sample, t, text, control, maps), maps

    return fn


@torch.no_grad()
def edit_sample(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                cond_embeddings: torch.Tensor, uncond_embeddings: torch.Tensor, *,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                ctx: Optional[ControlContext] = None,
                cached_source: Optional[CachedSource] = None) -> torch.Tensor:
    """Run the controlled denoise; returns final latents (P, F, h, w, C).

    ``latents``: x_T, (1, F, h, w, C) (shared by all streams) or (P, …);
    ``cond_embeddings`` (P, L, D), source prompt first; ``uncond_embeddings``
    (L, D) or (1, L, D). This is the JAX ``edit_sample`` with
    ``source_uses_cfg=False`` (the ``--fast`` layout) and η = 0.
    ``cached_source``: the cached-source mode; its capture must cover
    ``num_inference_steps`` steps, and stream 0 of the output is its x_0."""
    if cond_embeddings.dim() != 3:
        raise NotImplementedError(
            "per-frame ('multi') conditioning is not ported yet; see ROADMAP Queue 1")
    P = cond_embeddings.shape[0]
    latents = latents.float()
    if latents.shape[0] == 1 and P > 1:
        latents = latents.expand(P, *latents.shape[1:])
    elif latents.shape[0] != P:
        raise ValueError(f"latents batch {latents.shape[0]} != num prompts {P}")
    video_length = latents.shape[1]
    latent_hw = tuple(latents.shape[2:4])
    text_len = cond_embeddings.shape[-2]
    if uncond_embeddings.dim() == 3 and uncond_embeddings.shape[0] == 1:
        uncond_embeddings = uncond_embeddings[0]
    if uncond_embeddings.dim() != 2:
        raise ValueError(
            f"uncond_embeddings must be (L, D) or (1, L, D), got "
            f"{tuple(uncond_embeddings.shape)}")

    if cached_source is not None:
        if cached_source.num_steps != num_inference_steps:
            raise ValueError(
                f"cached trajectory covers {cached_source.num_steps} steps, "
                f"edit runs {num_inference_steps}")
        return _edit_sample_cached(
            unet_fn, scheduler, latents, cond_embeddings, uncond_embeddings,
            cached_source, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ctx=ctx)

    U = P - 1
    text = torch.cat([uncond_embeddings.expand(U, *uncond_embeddings.shape),
                      cond_embeddings], dim=0)
    use_blend = ctx is not None and ctx.blend is not None
    maps_sum = None
    for i, t in enumerate(scheduler.timesteps(num_inference_steps)):
        t = int(t)
        latent_in = torch.cat([latents[P - U:], latents], dim=0)
        control = AttnControl(ctx, i, U) if ctx is not None else None
        eps_all, store = unet_fn(latent_in, t, text, control, store=use_blend)
        eps_all = eps_all.float()
        eps_uncond, eps_text = eps_all[:U], eps_all[U:]
        eps_edit = eps_uncond + guidance_scale * (eps_text[1:] - eps_uncond)
        eps = torch.cat([eps_text[:1], eps_edit], dim=0)
        latents, _ = scheduler.step(eps, t, latents, num_inference_steps)
        if use_blend:
            maps = blend_maps_from_store(
                store, latent_hw=latent_hw, video_length=video_length,
                num_prompts=P, text_len=text_len, num_uncond=U).float()
            maps_sum = maps if maps_sum is None else maps_sum + maps
            latents = local_blend(latents, maps_sum, ctx.blend, i)
    return latents


def _edit_sample_cached(unet_fn: UNetFn, scheduler: DDIMScheduler,
                        latents: torch.Tensor, cond_embeddings: torch.Tensor,
                        uncond_embeddings: torch.Tensor, cached: CachedSource, *,
                        num_inference_steps: int, guidance_scale: float,
                        ctx: Optional[ControlContext]) -> torch.Tensor:
    """The cached-source loop: the batch is E uncond + E edit streams, the
    controllers read the captured base maps of each step, and LocalBlend
    sums the source's captured blend maps with the edit streams' live ones,
    source first. Deterministic: η = 0."""
    P = cond_embeddings.shape[0]
    E = U = P - 1
    if E < 1:
        raise ValueError("cached_source needs at least one edit prompt")
    video_length = latents.shape[1]
    latent_hw = tuple(latents.shape[2:4])
    text_len = cond_embeddings.shape[-2]
    edit_latents = latents[1:]
    text = torch.cat([uncond_embeddings.expand(E, *uncond_embeddings.shape),
                      cond_embeddings[1:]], dim=0)
    if ctx is not None and ctx.kind != "empty":
        # an open gate window without maps would skip the edit at every
        # site of that kind: refuse it
        lo, hi = cached.self_window
        if cached.cross_len > 0 and not cached.cross_maps:
            raise ValueError(
                f"capture declares a {cached.cross_len}-step cross window but "
                "has no cross maps")
        if hi > lo and not cached.temporal_maps:
            raise ValueError(
                f"capture declares self window {cached.self_window} but has "
                "no temporal maps")
    use_blend = ctx is not None and ctx.blend is not None
    if use_blend and cached.blend_seq is None:
        raise ValueError(
            "LocalBlend is configured but the capture has no blend_seq: run "
            "ddim_inversion_captured(capture_blend=True)")
    maps_sum = None
    for i, t in enumerate(scheduler.timesteps(num_inference_steps)):
        t = int(t)
        latent_in = torch.cat([edit_latents, edit_latents], dim=0)
        control = (AttnControl(ctx, i, U, cached_base=cached.base_tree_at(i),
                               cached_source=True) if ctx is not None else None)
        eps_all, store = unet_fn(latent_in, t, text, control, store=use_blend)
        eps_all = eps_all.float()
        eps_uncond, eps_text = eps_all[:E], eps_all[E:]
        eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        edit_latents, _ = scheduler.step(eps, t, edit_latents, num_inference_steps)
        if use_blend:
            edit_maps = blend_maps_from_store(
                store, latent_hw=latent_hw, video_length=video_length,
                num_prompts=E, text_len=text_len, num_uncond=U).float()
            maps = torch.cat([cached.blend_seq[i], edit_maps], dim=0)
            maps_sum = maps if maps_sum is None else maps_sum + maps
            # the source latent after step i is src_latents[i + 1]
            full = torch.cat([cached.src_latents[i + 1], edit_latents], dim=0)
            edit_latents = local_blend(full, maps_sum, ctx.blend, i)[1:]
    # stream 0 is the capture's x_0, copied without arithmetic
    return torch.cat([cached.src_latents[-1], edit_latents], dim=0)
