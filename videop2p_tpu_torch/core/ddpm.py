"""DDPM scheduler for Stage-1 training (port of ``videop2p_tpu/core/ddpm.py``):
the forward process ``add_noise`` (:class:`~videop2p_tpu_torch.core.ddim.ForwardProcess`)
and the regression target of the prediction type, over the β schedules of
:mod:`videop2p_tpu_torch.core.ddim`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videop2p_tpu_torch.core.ddim import ForwardProcess, make_beta_schedule

__all__ = ["DDPMScheduler"]


@dataclasses.dataclass(frozen=True)
class DDPMScheduler(ForwardProcess):
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

    def training_target(self, sample: torch.Tensor, noise: torch.Tensor,
                        timesteps: torch.Tensor) -> torch.Tensor:
        """The regression target of the configured prediction type."""
        if self.prediction_type == "epsilon":
            return noise
        if self.prediction_type == "v_prediction":
            return self.get_velocity(sample, noise, timesteps)
        raise ValueError(f"unknown prediction_type: {self.prediction_type!r}")
