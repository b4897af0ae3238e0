"""Edit-quality metrics in plain PyTorch (port of
``videop2p_tpu/obs/quality.py``): PSNR and SSIM, the inversion's
reconstruction PSNR, the background-preservation PSNR outside the
LocalBlend mask (:func:`masked_psnr`), adjacent-frame consistency, and
:func:`edit_quality_record`, which folds them into the run ledger's
``quality`` event and the per-frame curves of its sidecar.

Identical inputs give the closed forms exactly: PSNR → +inf, SSIM → 1.0.
Every function computes in float32 on the inputs' device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim", "masked_psnr", "frame_psnr", "adjacent_frame_psnr",
           "edit_quality_record", "QUALITY_SUMMARY_FIELDS"]

# the scalar keys every edit_quality_record summary carries (the ledger
# `quality` event); background_psnr and mask_coverage appear only with a mask
QUALITY_SUMMARY_FIELDS = (
    "recon_psnr",
    "recon_ssim",
    "edit_adjacent_psnr",
    "source_adjacent_psnr",
)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def psnr(a, b, *, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over all elements:
    ``10·log10(R²/MSE)``; identical inputs → +inf."""
    a, b = _f32(a), _f32(b)
    mse = torch.mean((a - b) ** 2)
    return 10.0 * (2 * math.log10(data_range) - torch.log10(mse))


def masked_psnr(a, b, weight, *, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over the region where ``weight`` (broadcast against ``a``) is
    nonzero, each element weighted; an all-zero weight gives NaN (there was
    nothing to measure)."""
    a, b = _f32(a), _f32(b)
    w = torch.broadcast_to(_f32(weight).to(a.device), a.shape)
    denom = w.sum()
    mse = (w * (a - b) ** 2).sum() / torch.where(
        denom > 0, denom, torch.full_like(denom, float("nan")))
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


def _scalar(x) -> float:
    return float(x.detach().cpu()) if isinstance(x, torch.Tensor) else float(x)


def edit_quality_record(source, recon, edited, *, mask=None,
                        data_range: float = 1.0) -> Tuple[Dict[str, float],
                                                           Dict[str, np.ndarray]]:
    """All edit-quality metrics of one run, as ``(summary, curves)``.

    ``source`` / ``recon`` / ``edited``: (F, H, W, C) videos in
    [0, ``data_range``] (the input frames, stream 0 of the edit output and
    the edited stream); ``mask``: optional (F, H, W) in [0, 1], 1 inside
    the edit region, whose complement the background metrics score. The
    summary is the ledger ``quality`` event's payload (the
    :data:`QUALITY_SUMMARY_FIELDS` always, finite values rounded to 4
    places); the curves are the per-frame arrays for the sidecar."""
    source, recon, edited = _f32(source), _f32(recon), _f32(edited)
    recon_curve = frame_psnr(recon, source, data_range=data_range)
    edit_adj = adjacent_frame_psnr(edited, data_range=data_range)
    src_adj = adjacent_frame_psnr(source, data_range=data_range)
    summary: Dict[str, float] = {
        "recon_psnr": _scalar(psnr(recon, source, data_range=data_range)),
        "recon_ssim": _scalar(ssim(recon, source, data_range=data_range)),
        "edit_adjacent_psnr": _scalar(edit_adj.mean()),
        "source_adjacent_psnr": _scalar(src_adj.mean()),
    }
    curves: Dict[str, np.ndarray] = {
        "recon_psnr_frames": recon_curve.cpu().numpy(),
        "edit_adjacent_psnr_frames": edit_adj.cpu().numpy(),
        "source_adjacent_psnr_frames": src_adj.cpu().numpy(),
    }
    if mask is not None:
        bg = 1.0 - torch.clamp(_f32(mask).to(edited.device), 0.0, 1.0)
        if bg.dim() == edited.dim() - 1:
            bg = bg[..., None]
        summary["background_psnr"] = _scalar(
            masked_psnr(edited, source, bg, data_range=data_range))
        summary["mask_coverage"] = _scalar(1.0 - bg.mean())
        bg_full = torch.broadcast_to(bg, edited.shape)
        curves["background_psnr_frames"] = torch.stack([
            masked_psnr(e, s, w, data_range=data_range)
            for e, s, w in zip(edited, source, bg_full)]).cpu().numpy()
    summary = {k: (round(v, 4) if np.isfinite(v) else v) for k, v in summary.items()}
    return summary, curves
