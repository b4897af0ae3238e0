"""DDPM scheduler for Stage-1 training (port of ``videop2p_tpu/core/ddpm.py``):
the forward process ``add_noise`` and the regression target of the
prediction type, over the β schedules of :mod:`videop2p_tpu_torch.core.ddim`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from videop2p_tpu_torch.core.ddim import make_beta_schedule

__all__ = ["DDPMScheduler"]


@dataclasses.dataclass(frozen=True)
class DDPMScheduler:
    alphas_cumprod: np.ndarray  # (num_train_timesteps,) float32
    num_train_timesteps: int = 1000
    beta_schedule: str = "linear"
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, beta_start: float = 0.0001,
               beta_end: float = 0.02, beta_schedule: str = "linear",
               prediction_type: str = "epsilon") -> "DDPMScheduler":
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        return cls(alphas_cumprod=np.cumprod(1.0 - betas).astype(np.float32),
                   num_train_timesteps=num_train_timesteps, beta_schedule=beta_schedule,
                   prediction_type=prediction_type)

    @classmethod
    def create_sd(cls, **overrides) -> "DDPMScheduler":
        """The SD-1.x training schedule."""
        cfg = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear")
        cfg.update(overrides)
        return cls.create(**cfg)

    def _coeffs(self, timesteps: torch.Tensor, ref: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(√ᾱ_t, √(1 − ᾱ_t)) per sample, shaped to broadcast over ``ref``."""
        table = torch.as_tensor(self.alphas_cumprod, device=ref.device)
        alpha_prod = table[torch.as_tensor(timesteps, device=ref.device)]
        shape = alpha_prod.shape + (1,) * (ref.dim() - alpha_prod.dim())
        return (torch.sqrt(alpha_prod).reshape(shape),
                torch.sqrt(1.0 - alpha_prod).reshape(shape))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0) at each sample's timestep."""
        a, b = self._coeffs(timesteps, original_samples)
        return a * original_samples + b * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps: torch.Tensor) -> torch.Tensor:
        """The v-prediction target."""
        a, b = self._coeffs(timesteps, sample)
        return a * noise - b * sample

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
        """The regression target of the configured prediction type."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.get_velocity(sample, noise, timesteps)
        raise ValueError(f"unknown prediction_type: {self.prediction_type!r}")
