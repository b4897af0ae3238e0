"""DDIM inversion (port of ``ddim_inversion`` and ``ddim_inversion_captured``,
``videop2p_tpu/pipelines/inversion.py:86-350``; no dependent noise, no
attention-map observability record).

Walks clean latents x_0 to noise x_T with forward DDIM steps, conditional
only (guidance 1), and returns the whole trajectory; the captured form also
collects what the cached-source edit reads in place of a live source stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.models.attention import BASE_STORE, AttnControl
from videop2p_tpu_torch.pipelines.cached import CachedSource, filter_site_tree
from videop2p_tpu_torch.pipelines.sampling import UNetFn
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["ddim_inversion", "ddim_inversion_captured"]


@torch.no_grad()
def ddim_inversion(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                   cond_embedding: torch.Tensor, *,
                   num_inference_steps: int = 50) -> torch.Tensor:
    """``latents`` (B, F, h, w, C) clean scaled latents, ``cond_embedding``
    (B, L, D) source-prompt embedding → the trajectory
    (num_steps + 1, B, F, h, w, C) in float32, ``[0] = x_0``, ``[-1] = x_T``.
    Latents stay float32 whatever the UNet's compute dtype."""
    latent = latents.float()
    trajectory = [latent]
    for t in scheduler.timesteps(num_inference_steps)[::-1]:
        eps, _ = unet_fn(latent, int(t), cond_embedding, None, store=False)
        latent = scheduler.next_step(eps, int(t), latent, num_inference_steps)
        trajectory.append(latent)
    return torch.stack(trajectory)


def _encode_temporal(leaf: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A captured bf16 temporal map in its storage dtype: as it is, float8
    by conversion, or int8 as round(p·127) (``CachedSource.base_tree_at``
    decodes)."""
    if dtype is None:
        return leaf
    if dtype.is_floating_point:
        return leaf.to(dtype)
    return torch.clamp(torch.round(leaf.float() * 127.0), -127.0, 127.0).to(dtype)


@torch.no_grad()
def ddim_inversion_captured(
    unet_fn: UNetFn,
    scheduler: DDIMScheduler,
    latents: torch.Tensor,
    cond_embedding: torch.Tensor,
    *,
    num_inference_steps: int = 50,
    cross_len: int = 0,
    self_window: Tuple[int, int] = (0, 0),
    capture_blend: bool = False,
    temporal_maps_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, CachedSource]:
    """:func:`ddim_inversion` that also captures what a cached-source edit
    reads (see :mod:`videop2p_tpu_torch.pipelines.cached`):

      * the full per-head maps of the attn2 sites for edit steps
        [0, ``cross_len``), i.e. inversion steps [N − cross_len, N);
      * those of the attn_temp sites for edit steps [lo, hi) =
        ``self_window``, i.e. inversion steps [N − hi, N − lo), stored in
        ``temporal_maps_dtype`` (None: bf16; ``torch.float8_e4m3fn``; or
        ``torch.int8`` as round(p·127));
      * with ``capture_blend``, the source's LocalBlend maps at every step.

    The walk is split at the window edges; edit step *i* reads what
    inversion step N − 1 − i captured. Each captured map is written at its
    edit-step index into a buffer allocated at the first capture, so no
    per-step copies pile up. Returns ``(trajectory, CachedSource)``."""
    N = num_inference_steps
    lo, hi = self_window
    if not 0 <= lo <= hi <= N:
        raise ValueError(f"self_window {self_window} outside [0, {N}]")
    if not 0 <= cross_len <= N:
        raise ValueError(f"cross_len {cross_len} outside [0, {N}]")
    latent = latents.float()
    video_length = latent.shape[1]
    latent_hw = tuple(latent.shape[2:4])
    text_len = cond_embedding.shape[-2]
    timesteps = scheduler.timesteps(N)[::-1]
    cross: Dict[str, torch.Tensor] = {}
    temporal: Dict[str, torch.Tensor] = {}
    blend_seq = None

    def put(buffers, store, site, index, length, encode):
        for path, leaf in filter_site_tree(store[BASE_STORE], site).items():
            leaf = encode(leaf)
            if path not in buffers:
                buffers[path] = leaf.new_empty((length, *leaf.shape))
            buffers[path][index] = leaf

    trajectory = [latent]
    bounds = sorted({0, N - hi, N - lo, N - cross_len, N})
    for s, e in zip(bounds[:-1], bounds[1:]):
        want_cross = s >= N - cross_len
        want_temporal = s >= N - hi and e <= N - lo
        capture = want_cross or want_temporal
        control = AttnControl(None, 0, capture=True) if capture else None
        for j in range(s, e):
            t = int(timesteps[j])
            eps, store = unet_fn(latent, t, cond_embedding, control,
                                 store=capture or capture_blend)
            latent = scheduler.next_step(eps, t, latent, N)
            trajectory.append(latent)
            i = N - 1 - j  # the edit step that reads this capture
            if capture_blend:
                maps = blend_maps_from_store(
                    store, latent_hw=latent_hw, video_length=video_length,
                    num_prompts=1, text_len=text_len, num_uncond=0).float()
                if blend_seq is None:
                    blend_seq = maps.new_empty((N, *maps.shape))
                blend_seq[i] = maps
            if want_cross:
                put(cross, store, "attn2", i, cross_len, lambda a: a)
            if want_temporal:
                put(temporal, store, "attn_temp", i - lo, hi - lo,
                    lambda a: _encode_temporal(a, temporal_maps_dtype))
    trajectory = torch.stack(trajectory)
    cached = CachedSource(
        src_latents=torch.flip(trajectory, dims=(0,)),
        cross_maps=cross or None, temporal_maps=temporal or None,
        blend_seq=blend_seq, cross_len=cross_len, self_window=(lo, hi))
    return trajectory, cached
