"""The port's edit-quality record (``obs/quality.py``: ``masked_psnr``,
``edit_quality_record``) against the JAX package's on the same seeded
videos and masks, in float32.

Tolerances: PSNRs within 1e-4 dB, SSIM within 1e-5 (both sides reduce the
same float32 elements in their own order); the summary's keys, the curves'
keys and shapes, and the closed forms (identical videos: +inf; an empty
weight: NaN) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)

PSNR_TOL = 1e-4
SSIM_TOL = 1e-5


def _videos(seed: int = 0, frames: int = 3, size: int = 20):
    rng = np.random.default_rng(seed)
    source = rng.random((frames, size, size, 3)).astype(np.float32)
    recon = np.clip(source + rng.normal(0, 0.05, source.shape), 0, 1).astype(np.float32)
    edited = np.clip(source + rng.normal(0, 0.2, source.shape), 0, 1).astype(np.float32)
    mask = (rng.random((frames, size, size)) > 0.6).astype(np.float32)
    return source, recon, edited, mask


@pytest.mark.parametrize("weight", ["mask", "complement", "empty"])
def test_masked_psnr_matches_jax(weight):
    from videop2p_tpu.obs.quality import masked_psnr as jax_masked

    from videop2p_tpu_torch.obs.quality import masked_psnr

    source, _, edited, mask = _videos(1)
    w = {"mask": mask, "complement": 1.0 - mask, "empty": np.zeros_like(mask)}[weight]
    w = w[..., None]
    got = float(masked_psnr(torch.from_numpy(edited), torch.from_numpy(source),
                            torch.from_numpy(w)))
    want = float(jax_masked(jnp.asarray(edited), jnp.asarray(source), jnp.asarray(w)))
    if weight == "empty":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert abs(got - want) <= PSNR_TOL


@pytest.mark.parametrize("with_mask", [False, True])
def test_edit_quality_record_matches_jax(with_mask):
    from videop2p_tpu.obs.quality import QUALITY_SUMMARY_FIELDS as JAX_FIELDS
    from videop2p_tpu.obs.quality import edit_quality_record as jax_record

    from videop2p_tpu_torch.obs.quality import QUALITY_SUMMARY_FIELDS, edit_quality_record

    source, recon, edited, mask = _videos(2)
    m = mask if with_mask else None
    got, got_curves = edit_quality_record(source, recon, edited, mask=m)
    want, want_curves = jax_record(jnp.asarray(source), jnp.asarray(recon),
                                   jnp.asarray(edited), mask=m)
    assert QUALITY_SUMMARY_FIELDS == JAX_FIELDS
    assert list(got) == list(want)
    assert set(QUALITY_SUMMARY_FIELDS) <= set(got)
    assert ("background_psnr" in got) == with_mask
    for k, v in want.items():
        tol = SSIM_TOL if k in ("recon_ssim", "mask_coverage") else PSNR_TOL
        assert abs(got[k] - v) <= tol + 1e-4, (k, got[k], v)  # both rounded to 4 places
    assert sorted(got_curves) == sorted(want_curves)
    for k, v in want_curves.items():
        assert got_curves[k].shape == np.asarray(v).shape
        np.testing.assert_allclose(got_curves[k], np.asarray(v), atol=PSNR_TOL, err_msg=k)


def test_unrounded_metrics_match_jax():
    """The record's inputs before rounding: PSNR, SSIM and the masked
    PSNR's per-frame curve."""
    from videop2p_tpu.obs import quality as jq

    from videop2p_tpu_torch.obs import quality as pq

    source, recon, edited, mask = _videos(3, frames=4, size=24)
    t = torch.from_numpy
    assert abs(float(pq.psnr(t(recon), t(source)))
               - float(jq.psnr(jnp.asarray(recon), jnp.asarray(source)))) <= PSNR_TOL
    assert abs(float(pq.ssim(t(recon), t(source)))
               - float(jq.ssim(jnp.asarray(recon), jnp.asarray(source)))) <= SSIM_TOL
    _, curves = pq.edit_quality_record(source, recon, edited, mask=mask)
    _, want = jq.edit_quality_record(source, recon, edited, mask=mask)
    np.testing.assert_allclose(curves["background_psnr_frames"],
                               np.asarray(want["background_psnr_frames"]), atol=PSNR_TOL)


def test_identical_videos_give_the_closed_forms():
    from videop2p_tpu_torch.obs.quality import edit_quality_record

    source, _, _, mask = _videos(4)
    summary, _ = edit_quality_record(source, source, source, mask=mask)
    assert summary["recon_psnr"] == float("inf") and summary["recon_ssim"] == 1.0
    assert summary["background_psnr"] == float("inf")
    assert 0.0 < summary["mask_coverage"] < 1.0
