"""Diffusion core: the DDIM scheduler."""

from videop2p_tpu_torch.core.ddim import DDIMScheduler, make_beta_schedule

__all__ = ["DDIMScheduler", "make_beta_schedule"]
