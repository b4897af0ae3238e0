"""Edit-quality metrics in plain PyTorch (port of ``psnr``, ``ssim``,
``frame_psnr`` and ``adjacent_frame_psnr`` of
``videop2p_tpu/obs/quality.py``).

Identical inputs give the closed forms exactly: PSNR → +inf, SSIM → 1.0.
Every function computes in float32 on the inputs' device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "frame_psnr", "adjacent_frame_psnr"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr(a, b, *, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over all elements:
    ``10·log10(R²/MSE)``; identical inputs → +inf."""
    a, b = _f32(a), _f32(b)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * (2 * math.log10(data_range) - torch.log10(mse))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over ``win``×``win`` windows of the last two axes, VALID
    padding (the SSIM local window)."""
    lead = x.shape[:-2]
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), win, stride=1)
    return y.reshape(*lead, *y.shape[-2:])


def ssim(a, b, *, data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """Mean structural similarity over (..., H, W, C) images: a uniform
    ``win_size``×``win_size`` window, K1 = 0.01, K2 = 0.03, biased local
    moments; the channels are independent images."""
    a = torch.movedim(_f32(a), -1, -3)
    b = torch.movedim(_f32(b), -1, -3)
    mu_a = _uniform_filter(a, win_size)
    mu_b = _uniform_filter(b, win_size)
    var_a = _uniform_filter(a * a, win_size) - mu_a * mu_a
    var_b = _uniform_filter(b * b, win_size) - mu_b * mu_b
    cov = _uniform_filter(a * b, win_size) - mu_a * mu_b
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)


def frame_psnr(a, b, *, data_range: float = 1.0) -> torch.Tensor:
    """Per-frame PSNR curve of (F, H, W, C) videos → (F,)."""
    a, b = _f32(a), _f32(b)
    return torch.stack([psnr(x, y, data_range=data_range) for x, y in zip(a, b)])


def adjacent_frame_psnr(video, *, data_range: float = 1.0) -> torch.Tensor:
    """Temporal consistency: PSNR between each consecutive frame pair of a
    (F, H, W, C) video → (F − 1,)."""
    v = _f32(video)
    return frame_psnr(v[1:], v[:-1], data_range=data_range)
