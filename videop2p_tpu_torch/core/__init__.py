"""Diffusion core: the DDIM scheduler and the dependent-noise sampler."""

from videop2p_tpu_torch.core.ddim import DDIMScheduler, make_beta_schedule
from videop2p_tpu_torch.core.noise import DependentNoiseSampler, ar_window_cov, toeplitz_cov

__all__ = ["DDIMScheduler", "make_beta_schedule", "DependentNoiseSampler",
           "ar_window_cov", "toeplitz_cov"]
