"""The pipelines' attention and telemetry records (``attn_maps=``,
``telemetry=``) against the JAX package's, on the CPU in float32 with the
tiny UNet, seeded inputs, the refine controller with equalizer and
LocalBlend (``tests/test_torch_cached.py``'s setup): the cached fast edit
and its capture. The live edit and the plain inversion are
``tests/test_torch_obs_live.py``.

Tolerances. Heat, entropies and the mask series: 1e-5 relative with a
1e-7 absolute floor wherever both sides walk the same inputs: the
inversion's record, the cached edit on one shared capture, the live edit
from one x_T. The mask series and the site names are exact, and so are the
NaN / inf counts and the controller gates. The end-to-end cached fast edit
edits from each package's own capture, whose bf16 maps differ by one ulp
(``tests/test_torch_cached.py``): its edit record within 1e-3 relative
(1.3e-4 measured), its latent statistics within 1e-3. Outputs with the
records on equal the outputs with them off, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_cached import STEPS, _jax_capture, _port_cached, _windows, setup  # noqa: F401
from tests.test_torch_parity import np32, t

RTOL, ATOL = 1e-5, 1e-7
E2E_RTOL = 1e-3


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _assert_attn(got, want, rtol=RTOL, atol=ATOL):
    assert sorted(got) == sorted(want)
    _close(got["cross_heat"], want["cross_heat"], rtol, atol, "cross_heat")
    assert sorted(got["entropy"]) == sorted(want["entropy"])
    for site, curve in want["entropy"].items():
        _close(got["entropy"][site], curve, rtol, atol, site)
    for k in ("mask_cov", "mask_heat", "blend_active"):
        if k in want:
            np.testing.assert_array_equal(np32(got[k]), np.asarray(want[k], np.float32), k)


def _assert_tel(got, want, rtol):
    assert sorted(got) == sorted(want)
    for k in ("nan_count", "inf_count", "self_edit_active", "cross_gate_mean"):
        np.testing.assert_array_equal(np32(got[k]), np.asarray(want[k], np.float32), k)
    for k in ("abs_max", "mean"):
        _close(got[k], want[k], rtol, 1e-6, k)


def _jit(fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.jit(fn)(*args)


def test_cached_fast_edit_records_match_jax(setup):  # noqa: F811
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.pipelines import cached_fast_edit

    s = setup
    cross_len, self_window = _windows(s)
    kw = dict(num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
              self_window=self_window, telemetry=True, attn_maps=True)
    jtraj, jout, jtel, jattn = _jit(lambda p, x: jax_cached_edit(
        s["jfn"], p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"], s["jctx"], **kw),
        s["params"], s["x0"])
    traj, out, tel, attn = cached_fast_edit(
        s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]), t(s["uncond"]),
        s["pctx"], **kw)
    assert sorted(attn) == ["edit", "inversion"]
    _assert_attn(attn["inversion"], jattn["inversion"])
    assert tuple(attn["inversion"]["cross_heat"].shape) == (STEPS, 1, 16, 16, 77)
    assert tuple(attn["edit"]["mask_heat"].shape) == (STEPS, 2, 2, 16, 16)
    assert sorted(attn["edit"]["entropy"])[0] == "down_blocks_0/attentions_0/blocks_0/attn2"
    _assert_attn(attn["edit"], jattn["edit"], rtol=E2E_RTOL, atol=1e-6)
    _assert_tel(tel, jtel, rtol=E2E_RTOL)
    # the capture-off run: the same bits, src_err == 0.0
    traj_off, out_off = cached_fast_edit(
        s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]), t(s["uncond"]),
        s["pctx"], num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
        self_window=self_window)
    assert torch.equal(traj, traj_off) and torch.equal(out, out_off)
    assert np.abs(np32(out[0]) - s["x0"][0]).max() == 0.0


def test_cached_edit_records_match_jax_on_one_capture(setup):  # noqa: F811
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    jtraj, jcached = _jax_capture(s)
    _, jtel, jattn = _jit(lambda p, xt, c: jax_edit(
        s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"], num_inference_steps=STEPS,
        ctx=s["jctx"], source_uses_cfg=False, cached_source=c, telemetry=True,
        attn_maps=True), s["params"], jtraj[-1], jcached)
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
              cached_source=_port_cached(jcached))
    out, tel, attn = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]),
                                 t(s["uncond"]), telemetry=True, attn_maps=True, **kw)
    _assert_attn(attn, jattn)
    _assert_tel(tel, jtel, rtol=1e-4)
    off = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]), **kw)
    assert torch.equal(out, off)


def test_attn_maps_refuses_reuse_schedule(setup):  # noqa: F811
    from videop2p_tpu_torch.pipelines import cached_fast_edit, edit_sample

    s = setup
    jtraj, jcached = _jax_capture(s)
    with pytest.raises(ValueError, match="reuse_schedule='off'"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
                    cached_source=_port_cached(jcached), reuse_schedule="uniform:2",
                    attn_maps=True)
    cross_len, self_window = _windows(s)
    with pytest.raises(ValueError, match="reuse_schedule='off'"):
        cached_fast_edit(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]),
                         t(s["uncond"]), s["pctx"], num_inference_steps=STEPS,
                         cross_len=cross_len, self_window=self_window,
                         reuse_schedule="uniform:2", attn_maps=True)


def test_store_without_blend_changes_no_output(setup):  # noqa: F811
    """Without LocalBlend the loops ask the UNet for its store only under
    ``attn_maps``; storing reads the probabilities and changes no bit."""
    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    x = t(s["x0"])
    eps_off, store_off = s["pfn"](x, 500, t(s["cond"][:1]), None, store=False)
    eps_on, store_on = s["pfn"](x, 500, t(s["cond"][:1]), None, store=True)
    assert store_off is None and store_on and torch.equal(eps_off, eps_on)
    kw = dict(num_inference_steps=2, source_uses_cfg=False)
    out = edit_sample(s["pfn"], s["psched"], x, t(s["cond"]), t(s["uncond"]), **kw)
    on, attn = edit_sample(s["pfn"], s["psched"], x, t(s["cond"]), t(s["uncond"]),
                           attn_maps=True, **kw)
    assert torch.equal(out, on) and "mask_cov" not in attn


def test_resize_matches_jax_image_resize():
    """The pooling: ``jax.image.resize(method="linear")``, antialiased when
    it downsamples (64² and 32² to 16²), plain linear when it upsamples."""
    import jax.numpy as jnp

    from videop2p_tpu_torch.obs.attention import resize_linear

    rng = np.random.default_rng(5)
    for hw in ((64, 64), (32, 32), (8, 8), (4, 6), (16, 16)):
        x = rng.random((2, 3, *hw)).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), (2, 3, 16, 16), method="linear")
        _close(resize_linear(torch.from_numpy(x), (16, 16)), want, 1e-6, 1e-7, str(hw))
