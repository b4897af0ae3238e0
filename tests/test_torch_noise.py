"""The port's dependent-noise sampler (``videop2p_tpu_torch/core/noise.py``)
against the JAX package's, on the CPU.

The covariances are exact (the same numpy on both sides); ``create``'s
factors within 1e-6 (float64 numpy on both sides, cast to float32).
``transform`` of JAX's own normals (``jax.random.normal`` for JAX's key and
shape) equals JAX's ``sample`` within 1e-6 (float32 products of at most 8
terms; the AR chain's products in float32 on both sides). The port's own
draws (a ``torch.Generator``, whose stream cannot match JAX's) are held to
the statistics ``tests/test_noise.py`` pins: the empirical covariance within
0.08 (0.1 for the AR chain) of the closed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32


@pytest.mark.parametrize("size,decay,ac,nw", [(4, 0.5, 0.25, 2), (3, 0.3, 0.36, 3),
                                              (8, 0.1, 0.1, 1)])
def test_covariances_match_jax(size, decay, ac, nw):
    from videop2p_tpu.core import noise as jnoise

    from videop2p_tpu_torch.core import noise

    np.testing.assert_array_equal(noise.toeplitz_cov(size, decay),
                                  jnoise.toeplitz_cov(size, decay))
    got, want = noise.ar_window_cov(size, decay, ac, nw), jnoise.ar_window_cov(size, decay, ac, nw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(num_frames=8, decay_rate=0.4, window_size=8),
    dict(num_frames=8, decay_rate=0.3, window_size=4, ar_sample=True, ar_coeff=0.1),
    dict(num_frames=60, decay_rate=0.9, window_size=60),
], ids=["one_window", "ar_two_windows", "sixty"])
def test_create_matches_jax(kw):
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler

    from videop2p_tpu_torch.core import DependentNoiseSampler

    want, got = JaxSampler.create(**kw), DependentNoiseSampler.create(**kw)
    for name in ("chol", "cov", "cov_inv"):
        assert getattr(got, name).dtype == torch.float32
        np.testing.assert_allclose(np32(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert got.num_windows == want.num_windows
    np.testing.assert_array_equal(got.joint_cov(), want.joint_cov())
    for name in ("num_frames", "window_size", "ar_sample", "ar_coeff", "decay_rate"):
        assert getattr(got, name) == getattr(want, name)


def test_sampler_raises_where_jax_raises():
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler

    from videop2p_tpu_torch.core import DependentNoiseSampler

    for cls in (JaxSampler, DependentNoiseSampler):
        with pytest.raises(ValueError, match="divisible"):
            cls.create(num_frames=10, window_size=4)
    with pytest.raises(ValueError, match="num_frames"):
        JaxSampler.create(num_frames=8, window_size=8).sample(jax.random.key(0), (2, 6, 4))
    with pytest.raises(ValueError, match="num_frames"):
        DependentNoiseSampler.create(num_frames=8, window_size=8).sample(
            (2, 6, 4), torch.Generator().manual_seed(0))


def test_draw_runs_on_the_samplers_device():
    """A generator or a tensor on another device than the sampler's raises
    (the sampler on the meta device stands in for the card here)."""
    from videop2p_tpu_torch.core import DependentNoiseSampler

    s = DependentNoiseSampler.create(num_frames=4, window_size=2, device="meta")
    assert s.device.type == "meta" and s.chol.device.type == "meta"
    with pytest.raises(ValueError, match="generator on cpu"):
        s.sample((1, 4, 3), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="x on cpu"):
        s.sample_like(torch.zeros(1, 4, 3), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("nw", [1, 2, 4])
@pytest.mark.parametrize("ar_sample", [False, True], ids=["independent", "ar"])
@pytest.mark.parametrize("frame_axis", [1, -1])
def test_transform_of_jax_normals_matches_jax_sample(nw, ar_sample, frame_axis):
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler

    from videop2p_tpu_torch.core import DependentNoiseSampler

    kw = dict(num_frames=3 * nw, decay_rate=0.3, window_size=3, ar_sample=ar_sample,
              ar_coeff=0.36)
    js, ps = JaxSampler.create(**kw), DependentNoiseSampler.create(**kw)
    shape = (2, 3 * nw, 5, 4) if frame_axis == 1 else (2, 5, 4, 3 * nw)
    key = jax.random.key(11 + nw)
    batch = tuple(d for i, d in enumerate(shape) if i != frame_axis % len(shape))
    z = np.asarray(jax.random.normal(key, batch + (nw, 3), dtype=jnp.float32))
    want = np.asarray(js.sample(key, shape, frame_axis=frame_axis))
    got = ps.transform(torch.tensor(z), frame_axis)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("frame_axis", [1, -1])
def test_transform_of_jax_normals_matches_jax_sample_bf16(frame_axis):
    """The bf16 draw (``sample_like`` of a bf16 prediction): float32 math,
    one rounding at the end, on both sides."""
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler

    from videop2p_tpu_torch.core import DependentNoiseSampler

    kw = dict(num_frames=8, decay_rate=0.3, window_size=4, ar_sample=True, ar_coeff=0.1)
    js, ps = JaxSampler.create(**kw), DependentNoiseSampler.create(**kw)
    shape = (1, 8, 4, 4, 4) if frame_axis == 1 else (1, 4, 4, 4, 8)
    key = jax.random.key(5)
    z = np.asarray(jax.random.normal(key, (1, 4, 4, 4, 2, 4), dtype=jnp.float32))
    want = js.sample(key, shape, frame_axis=frame_axis, dtype=jnp.bfloat16)
    got = ps.transform(torch.tensor(z), frame_axis, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=0, atol=1e-6)


def _empirical_cov(samples: np.ndarray) -> np.ndarray:
    return (samples.T @ samples) / samples.shape[0]


def test_port_draws_single_window_covariance():
    from videop2p_tpu_torch.core import DependentNoiseSampler

    s = DependentNoiseSampler.create(num_frames=8, decay_rate=0.4, window_size=8)
    draws = s.sample((4096, 8, 2), torch.Generator().manual_seed(0), frame_axis=1)
    flat = draws.numpy().transpose(0, 2, 1).reshape(-1, 8)
    np.testing.assert_allclose(_empirical_cov(flat), s.joint_cov(), atol=0.08)


def test_port_draws_independent_windows():
    from videop2p_tpu_torch.core import DependentNoiseSampler

    s = DependentNoiseSampler.create(num_frames=8, decay_rate=0.5, window_size=4)
    emp = _empirical_cov(s.sample((8192, 8), torch.Generator().manual_seed(1)).numpy())
    np.testing.assert_allclose(emp[:4, 4:], np.zeros((4, 4)), atol=0.08)
    np.testing.assert_allclose(emp[:4, :4], s.joint_cov()[:4, :4], atol=0.08)


def test_port_draws_ar_chained_windows_covariance():
    from videop2p_tpu_torch.core import DependentNoiseSampler

    s = DependentNoiseSampler.create(num_frames=12, decay_rate=0.3, window_size=4,
                                     ar_sample=True, ar_coeff=0.36)
    emp = _empirical_cov(s.sample((16384, 12), torch.Generator().manual_seed(2)).numpy())
    np.testing.assert_allclose(emp, s.joint_cov(), atol=0.1)


def test_sample_like_layout_dtype_and_generator():
    """``sample_like`` takes the shape and dtype of its argument; a seeded
    generator repeats its draw, and the draw is the transform of that
    generator's normals."""
    from videop2p_tpu_torch.core import DependentNoiseSampler

    s = DependentNoiseSampler.create(num_frames=8, window_size=4, ar_sample=True)
    x = torch.zeros((2, 8, 16, 16, 4), dtype=torch.bfloat16)
    a = s.sample_like(x, torch.Generator().manual_seed(3))
    b = s.sample_like(x, torch.Generator().manual_seed(3))
    assert a.shape == x.shape and a.dtype == x.dtype
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    z = torch.randn((2, 16, 16, 4, 2, 4), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, s.transform(z, 1, torch.bfloat16), rtol=0, atol=0)
