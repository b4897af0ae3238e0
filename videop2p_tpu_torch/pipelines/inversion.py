"""DDIM inversion (port of ``ddim_inversion``,
``videop2p_tpu/pipelines/inversion.py:86-171``; no dependent noise, no
attention-map capture).

Walks clean latents x_0 to noise x_T with forward DDIM steps, conditional
only (guidance 1), and returns the whole trajectory.
"""

from __future__ import annotations

import torch

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.pipelines.sampling import UNetFn

__all__ = ["ddim_inversion"]


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
