"""DDIM scheduler (port of ``videop2p_tpu/core/ddim.py``: η ≥ 0 with the
caller's noise; epsilon, sample or v prediction; linear, scaled-linear or
cosine (``squaredcos_cap_v2``) betas; the timestep-subset walk of the cached
fast path; the forward process ``add_noise`` / ``get_velocity`` that
consistency distillation noises its latents with).

Every step is an fp32 island: ``model_output`` and ``sample`` are cast to
float32 on entry and the ᾱ-coefficient math runs in float32, whatever the
model's compute dtype, so trajectory fidelity does not depend on it. Step
outputs are float32. A timestep is a Python int or a 0-d int64 tensor on the
sample's device (a step body that CUDA graphs replay reads it from a
buffer): ᾱ comes from a table on the device either way, indexed on the
device for a tensor, so a step makes no copy from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.utils.cuda_graphs import index_step

__all__ = ["DDIMScheduler", "ForwardProcess", "make_beta_schedule", "PREDICTION_TYPES"]

PREDICTION_TYPES = ("epsilon", "sample", "v_prediction")


def make_beta_schedule(schedule: str, num_train_timesteps: int, beta_start: float,
                       beta_end: float, *, max_beta: float = 0.999) -> np.ndarray:
    """β schedule: ``linear``, ``scaled_linear`` (linear in sqrt-space, the
    Stable Diffusion schedule) or ``squaredcos_cap_v2`` (the cosine ᾱ
    schedule, each β capped at ``max_beta``)."""
    if schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    elif schedule == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train_timesteps,
                            dtype=np.float64) ** 2
    elif schedule == "squaredcos_cap_v2":
        def alpha_bar(t: np.ndarray) -> np.ndarray:
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

        t1 = np.arange(num_train_timesteps, dtype=np.float64) / num_train_timesteps
        t2 = (np.arange(num_train_timesteps, dtype=np.float64) + 1) / num_train_timesteps
        betas = np.minimum(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)
    else:
        raise ValueError(f"unknown beta schedule: {schedule!r}")
    return betas.astype(np.float32)


def _f32(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(t.float() for t in tensors)


class ForwardProcess:
    """The forward process over the scheduler's ``alphas_cumprod``, at a ()
    or (B,) timestep per sample (both schedulers' ``add_noise``)."""

    def _device_table(self, name: str, values: np.ndarray, device) -> torch.Tensor:
        """``values`` on ``device``, copied there once and kept (a step
        body indexes it on the device)."""
        tables = self.__dict__.get("_tables")
        if tables is None:
            tables = {}
            object.__setattr__(self, "_tables", tables)
        key = (name, str(torch.device(device)))
        table = tables.get(key)
        if table is None:
            table = tables[key] = torch.as_tensor(values, device=device)
        return table

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop("_tables", None)
        return state

    def alpha_coefficients(self, timesteps, ref: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(√ᾱ_t, √(1 − ᾱ_t)) per sample, shaped to broadcast over ``ref``."""
        table = self._device_table("alphas_cumprod", self.alphas_cumprod, ref.device)
        alpha_prod = table[torch.as_tensor(timesteps, device=ref.device)]
        shape = alpha_prod.shape + (1,) * (ref.dim() - alpha_prod.dim())
        return (torch.sqrt(alpha_prod).reshape(shape),
                torch.sqrt(1.0 - alpha_prod).reshape(shape))

    def add_noise(self, original_samples: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        """q(x_t | x_0) at each sample's timestep."""
        a, b = self.alpha_coefficients(timesteps, original_samples)
        return a * original_samples + b * noise

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                     timesteps) -> torch.Tensor:
        """The v-prediction target at each sample's timestep."""
        a, b = self.alpha_coefficients(timesteps, sample)
        return a * noise - b * sample


@dataclasses.dataclass(frozen=True)
class DDIMScheduler(ForwardProcess):
    alphas_cumprod: np.ndarray  # (num_train_timesteps,) float32
    final_alpha_cumprod: float
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "linear"
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, num_train_timesteps: int = 1000, beta_start: float = 0.0001,
               beta_end: float = 0.02, beta_schedule: str = "linear",
               clip_sample: bool = True, set_alpha_to_one: bool = True,
               steps_offset: int = 0, prediction_type: str = "epsilon"
               ) -> "DDIMScheduler":
        if prediction_type not in PREDICTION_TYPES:
            raise ValueError(f"unknown prediction_type: {prediction_type!r}")
        betas = make_beta_schedule(beta_schedule, num_train_timesteps, beta_start, beta_end)
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
        return cls(alphas_cumprod=alphas_cumprod, final_alpha_cumprod=final,
                   num_train_timesteps=num_train_timesteps, beta_start=beta_start,
                   beta_end=beta_end, beta_schedule=beta_schedule,
                   clip_sample=clip_sample, set_alpha_to_one=set_alpha_to_one,
                   steps_offset=steps_offset, prediction_type=prediction_type)

    @classmethod
    def from_config(cls, config) -> "DDIMScheduler":
        """From a diffusers ``scheduler_config.json`` dict (unknown keys are
        ignored; a Stage-1 export carries ``steps_offset: 1``)."""
        known = ("num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
                 "clip_sample", "set_alpha_to_one", "steps_offset", "prediction_type")
        return cls.create(**{k: config[k] for k in known if k in config})

    @classmethod
    def create_sd(cls, **overrides) -> "DDIMScheduler":
        """The Stable-Diffusion configuration."""
        cfg = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                   clip_sample=False, set_alpha_to_one=False)
        cfg.update(overrides)
        return cls.create(**cfg)

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending inference timesteps."""
        step_ratio = self.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        return ts + self.steps_offset

    def subset_positions(self, base_steps: int, steps: int) -> np.ndarray:
        """Positions into the descending ``timesteps(base_steps)`` grid of a
        ``steps``-step walk over an exact subset of its timesteps, leading
        spaced (``floor(j·base/steps)``): position 0 (x_T) is always in it,
        so a cached edit reads the source replay and the captured maps of
        one ``base_steps`` inversion exactly."""
        base_steps, steps = int(base_steps), int(steps)
        if not 1 <= steps <= base_steps:
            raise ValueError(f"steps {steps} must be in [1, base_steps={base_steps}]")
        return np.floor(np.arange(steps) * (base_steps / steps)).astype(np.int64)

    def subset_schedule(self, base_steps: int, steps: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(positions, timesteps, prev_timesteps)`` of that walk: step j
        lands on the next subset timestep, the last on the base walk's own
        terminal target (``timesteps(base)[-1] − ratio``, < 0 → the final ᾱ).
        With ``steps == base_steps`` ``prev_timesteps`` is the uniform rule
        ``timesteps − ratio``."""
        positions = self.subset_positions(base_steps, steps)
        base_ts = self.timesteps(base_steps)
        ts = base_ts[positions]
        ratio = self.num_train_timesteps // base_steps
        prev = np.concatenate([ts[1:], [base_ts[-1] - ratio]])
        return positions, ts, prev

    def _alpha_prod(self, timestep, device) -> torch.Tensor:
        """ᾱ_t as a float32 scalar tensor; t < 0 → ``final_alpha_cumprod``,
        t past the schedule → its last ᾱ. From the device table
        ``[final, ᾱ_0, …, ᾱ_{T−1}]`` at t + 1 clamped to [0, T]: a Python
        int indexes it on the host, a tensor on the device."""
        T = self.num_train_timesteps
        table = self._device_table(
            "alpha_prod", np.concatenate([np.asarray([self.final_alpha_cumprod], np.float32),
                                          np.asarray(self.alphas_cumprod, np.float32)]),
            device)
        if isinstance(timestep, torch.Tensor):
            return index_step(table, (timestep + 1).clamp(0, T))
        return table[min(max(int(timestep) + 1, 0), T)]

    def _prev(self, timestep, num_inference_steps: int, prev_timestep):
        """The step's target timestep: ``prev_timestep``, else t − T/N."""
        if prev_timestep is None:
            return timestep - self.num_train_timesteps // num_inference_steps
        return prev_timestep

    def variance(self, timestep, prev_timestep, device) -> torch.Tensor:
        """σ_t² before η (JAX: ``variance``)."""
        alpha_prod_t = self._alpha_prod(timestep, device)
        alpha_prod_t_prev = self._alpha_prod(prev_timestep, device)
        return ((1.0 - alpha_prod_t_prev) / (1.0 - alpha_prod_t)
                * (1.0 - alpha_prod_t / alpha_prod_t_prev))

    def predict_x0_eps(self, model_output: torch.Tensor, timestep,
                       sample: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pred_x0, pred_eps) under the configured prediction type, in
        float32."""
        model_output, sample = _f32(model_output, sample)
        alpha_prod_t = self._alpha_prod(timestep, sample.device)
        a, b = torch.sqrt(alpha_prod_t), torch.sqrt(1.0 - alpha_prod_t)
        if self.prediction_type == "epsilon":
            return (sample - b * model_output) / a, model_output
        if self.prediction_type == "sample":
            return model_output, (sample - a * model_output) / b
        return a * sample - b * model_output, a * model_output + b * sample

    def step(self, model_output: torch.Tensor, timestep, sample: torch.Tensor,
             num_inference_steps: int, *, eta: float = 0.0,
             variance_noise: Optional[torch.Tensor] = None,
             prev_timestep=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One reverse DDIM step x_t → x_{t−Δ}; returns
        ``(prev_sample, pred_original_sample)``. With ``eta`` > 0 the caller
        supplies ``variance_noise`` (standard normal, the sample's shape),
        added with std η·σ_t (JAX: core/ddim.py:248)."""
        model_output, sample = _f32(model_output, sample)
        prev_timestep = self._prev(timestep, num_inference_steps, prev_timestep)
        dev = sample.device
        alpha_prod_t_prev = self._alpha_prod(prev_timestep, dev)
        pred_x0, pred_eps = self.predict_x0_eps(model_output, timestep, sample)
        if self.clip_sample:
            pred_x0 = pred_x0.clamp(-1.0, 1.0)
        std_dev_t = eta * torch.sqrt(self.variance(timestep, prev_timestep, dev))
        direction = torch.sqrt(1.0 - alpha_prod_t_prev - std_dev_t ** 2) * pred_eps
        prev_sample = torch.sqrt(alpha_prod_t_prev) * pred_x0 + direction
        if eta > 0:
            if variance_noise is None:
                raise ValueError("eta > 0 requires variance_noise")
            prev_sample = prev_sample + std_dev_t * variance_noise.float()
        return prev_sample, pred_x0

    def prev_step(self, model_output: torch.Tensor, timestep,
                  sample: torch.Tensor, num_inference_steps: int, *,
                  prev_timestep=None) -> torch.Tensor:
        """Deterministic (η=0, no clipping) x_t → x_{t−Δ}, reading
        ``model_output`` as ε whatever ``prediction_type`` (as JAX's
        ``prev_step`` does)."""
        model_output, sample = _f32(model_output, sample)
        prev_timestep = self._prev(timestep, num_inference_steps, prev_timestep)
        dev = sample.device
        alpha_prod_t = self._alpha_prod(timestep, dev)
        alpha_prod_t_prev = self._alpha_prod(prev_timestep, dev)
        beta_prod_t = 1.0 - alpha_prod_t
        pred_x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(alpha_prod_t)
        direction = torch.sqrt(1.0 - alpha_prod_t_prev) * model_output
        return torch.sqrt(alpha_prod_t_prev) * pred_x0 + direction

    def next_step(self, model_output: torch.Tensor, timestep,
                  sample: torch.Tensor, num_inference_steps: int) -> torch.Tensor:
        """Forward DDIM (inversion) x_{t−Δ} → x_t, reading ``model_output``
        as ε (as JAX's ``next_step`` does)."""
        model_output, sample = _f32(model_output, sample)
        # past the schedule's end ᾱ clamps to its last entry either way
        cur_timestep = timestep - self.num_train_timesteps // num_inference_steps
        dev = sample.device
        alpha_prod_t = self._alpha_prod(cur_timestep, dev)
        alpha_prod_t_next = self._alpha_prod(timestep, dev)
        beta_prod_t = 1.0 - alpha_prod_t
        next_x0 = (sample - torch.sqrt(beta_prod_t) * model_output) / torch.sqrt(alpha_prod_t)
        direction = torch.sqrt(1.0 - alpha_prod_t_next) * model_output
        return torch.sqrt(alpha_prod_t_next) * next_x0 + direction

    @property
    def init_noise_sigma(self) -> float:
        return 1.0
