"""Frame-correlated Gaussian noise (port of ``videop2p_tpu/core/noise.py``),
the fork's dependent-noise extension.

Inside a window of frames the covariance is Toeplitz, Σ_ij = decay^|i−j|.
Windows are independent draws concatenated, or AR(1)-chained:
n_k = √ac·n_{k−1} + √(1−ac)·ξ_k, whose joint covariance is
kron(toeplitz(√ac^|i−j|), Σ). Σ = L·Lᵀ is factored once, in float64 numpy as
the JAX package does, and cast to float32; a draw is standard normals ``z``
of shape ``batch + (windows, window_size)`` from a ``torch.Generator``,
mapped by :meth:`DependentNoiseSampler.transform` (``z @ Lᵀ`` per window,
then the AR chain, a loop over the windows). A test can feed JAX's own
normals through ``transform``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["toeplitz_cov", "ar_window_cov", "DependentNoiseSampler", "step_generator"]


def toeplitz_cov(size: int, decay_rate: float) -> np.ndarray:
    """Σ_ij = decay_rate^|i−j|, float32."""
    idx = np.arange(size)
    return np.power(float(decay_rate), np.abs(idx[:, None] - idx[None, :])).astype(np.float32)


def ar_window_cov(window_size: int, decay_rate: float, ar_coeff: float,
                  num_windows: int) -> np.ndarray:
    """Joint covariance of AR-chained windows: kron(toeplitz(√ac^|i−j|), Σ)."""
    outer = toeplitz_cov(num_windows, float(np.sqrt(ar_coeff)))
    inner = toeplitz_cov(window_size, decay_rate)
    return np.kron(outer, inner).astype(np.float32)


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class DependentNoiseSampler:
    """Noise whose frame axis carries the window/AR covariance; every other
    axis is an i.i.d. batch axis. ``chol``, ``cov`` and ``cov_inv``
    (window × window, float32) live on one device, :attr:`device`; a draw
    runs there, from a generator on that device."""

    chol: torch.Tensor
    cov: torch.Tensor
    cov_inv: torch.Tensor
    num_frames: int = 60
    window_size: int = 60
    ar_sample: bool = False
    ar_coeff: float = 0.1
    decay_rate: float = 0.1

    @classmethod
    def create(cls, num_frames: int = 60, decay_rate: float = 0.1, window_size: int = 60,
               ar_sample: bool = False, ar_coeff: float = 0.1,
               device="cpu") -> "DependentNoiseSampler":
        if num_frames % window_size != 0:
            raise ValueError(
                f"num_frames ({num_frames}) must be divisible by window_size ({window_size})")
        cov = toeplitz_cov(window_size, decay_rate)
        chol = np.linalg.cholesky(cov.astype(np.float64)).astype(np.float32)
        cov_inv = np.linalg.inv(cov.astype(np.float64)).astype(np.float32)
        device = torch.device(device)
        return cls(chol=torch.from_numpy(chol).to(device),
                   cov=torch.from_numpy(cov).to(device),
                   cov_inv=torch.from_numpy(cov_inv).to(device),
                   num_frames=num_frames, window_size=window_size,
                   ar_sample=ar_sample, ar_coeff=ar_coeff, decay_rate=decay_rate)

    @property
    def device(self) -> torch.device:
        return self.chol.device

    @property
    def num_windows(self) -> int:
        return self.num_frames // self.window_size

    def joint_cov(self) -> np.ndarray:
        """The (num_frames × num_frames) covariance the sampler realizes."""
        if self.ar_sample:
            return ar_window_cov(self.window_size, self.decay_rate, self.ar_coeff,
                                 self.num_windows)
        out = np.zeros((self.num_frames, self.num_frames), dtype=np.float32)
        cov, ws = self.cov.cpu().numpy(), self.window_size
        for i in range(self.num_windows):
            out[i * ws:(i + 1) * ws, i * ws:(i + 1) * ws] = cov
        return out

    def transform(self, z: torch.Tensor, frame_axis: int = 1,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Standard normals ``z`` of shape ``batch + (num_windows,
        window_size)`` → the noise, ``batch`` with the frame axis inserted at
        ``frame_axis`` (of the output), in ``dtype``: per window ``z @ Lᵀ``,
        then with ``ar_sample`` the AR chain over the windows, in float32."""
        nw, ws = self.num_windows, self.window_size
        if tuple(z.shape[-2:]) != (nw, ws):
            raise ValueError(f"z must end in (num_windows, window_size) = {(nw, ws)}, "
                             f"got {tuple(z.shape)}")
        batch_shape = tuple(z.shape[:-2])
        w = torch.einsum("...nw,fw->...nf", z.float(), self.chol)
        if self.ar_sample and nw > 1:
            sq_ac = float(np.sqrt(self.ar_coeff))
            sq_1m = float(np.sqrt(1.0 - self.ar_coeff))
            chained = [w[..., 0, :]]
            for k in range(1, nw):
                chained.append(sq_ac * chained[-1] + sq_1m * w[..., k, :])
            w = torch.stack(chained, dim=-2)
        noise = w.reshape(batch_shape + (self.num_frames,))
        frame_axis = frame_axis % (len(batch_shape) + 1)
        return torch.movedim(noise, -1, frame_axis).to(dtype)

    def sample(self, shape: Tuple[int, ...], generator: torch.Generator,
               frame_axis: int = 1, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Correlated noise of ``shape`` (``shape[frame_axis]`` must be
        ``num_frames``; the default 1 is the (b, f, h, w, c) layout), drawn
        from ``generator``, which must lie on :attr:`device`."""
        if _indexed(generator.device) != self.device:
            raise ValueError(f"generator on {generator.device}, sampler on {self.device}: "
                             "a draw runs on the sampler's device")
        shape = tuple(shape)
        frame_axis = frame_axis % len(shape)
        if shape[frame_axis] != self.num_frames:
            raise ValueError(
                f"shape[{frame_axis}]={shape[frame_axis]} != num_frames={self.num_frames}")
        batch_shape = tuple(s for i, s in enumerate(shape) if i != frame_axis)
        z = torch.randn(batch_shape + (self.num_windows, self.window_size),
                        generator=generator, device=self.device, dtype=torch.float32)
        return self.transform(z, frame_axis, dtype)

    def sample_like(self, x: torch.Tensor, generator: torch.Generator,
                    frame_axis: int = 1) -> torch.Tensor:
        """A draw of ``x``'s shape and dtype; ``x`` must lie on
        :attr:`device`."""
        if x.device != self.device:
            raise ValueError(f"x on {x.device}, sampler on {self.device}")
        return self.sample(x.shape, generator, frame_axis=frame_axis, dtype=x.dtype)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of the run seeded ``seed`` (JAX's
    ``fold_in(key, step)``): its seed mixes the two (numpy's SeedSequence),
    so it depends on nothing else."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))
