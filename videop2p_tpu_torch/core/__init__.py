"""Diffusion core: the DDIM and DDPM schedulers and the dependent-noise
sampler."""

from videop2p_tpu_torch.core.ddim import DDIMScheduler, make_beta_schedule
from videop2p_tpu_torch.core.ddpm import DDPMScheduler
from videop2p_tpu_torch.core.noise import DependentNoiseSampler, ar_window_cov, toeplitz_cov

__all__ = ["DDIMScheduler", "DDPMScheduler", "make_beta_schedule",
           "DependentNoiseSampler", "ar_window_cov", "toeplitz_cov"]
