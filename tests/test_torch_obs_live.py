"""The live fast edit's and the plain DDIM inversion's attention and
telemetry records (``attn_maps=``, ``telemetry=``) against the JAX
package's, on the CPU in float32 with ``tests/test_torch_cached.py``'s
tiny UNet, inputs and controller. Tolerances as
``tests/test_torch_obs_attention.py``'s: heat and entropies 1e-5 relative
(2e-5 for the live edit's heat, whose latents pass through guidance 7.5
four times) with a 1e-7 absolute floor; the mask series, the site names,
the NaN / inf counts and the gates exact; the outputs with the records on
equal those with them off, bit for bit.
"""

import torch

from tests.test_torch_cached import STEPS, setup  # noqa: F401
from tests.test_torch_obs_attention import _assert_attn, _assert_tel, _jit
from tests.test_torch_parity import t


def test_live_edit_records_match_jax(setup):  # noqa: F811
    """The live fast edit (the source stream in the batch) from one x_T:
    the heat covers all P conditional streams."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    x_t = s["x0"]  # any x_T will do: the seeded latents
    _, jtel, jattn = _jit(lambda p, xt: jax_edit(
        s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"], num_inference_steps=STEPS,
        ctx=s["jctx"], source_uses_cfg=False, telemetry=True, attn_maps=True),
        s["params"], x_t)
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False)
    out, tel, attn = edit_sample(s["pfn"], s["psched"], t(x_t), t(s["cond"]),
                                 t(s["uncond"]), telemetry=True, attn_maps=True, **kw)
    assert tuple(attn["cross_heat"].shape) == (STEPS, 2, 16, 16, 77)
    _assert_attn(attn, jattn, rtol=2e-5)
    _assert_tel(tel, jtel, rtol=1e-4)
    off = edit_sample(s["pfn"], s["psched"], t(x_t), t(s["cond"]), t(s["uncond"]), **kw)
    assert torch.equal(out, off)


def test_ddim_inversion_record_matches_jax(setup):  # noqa: F811
    from videop2p_tpu.pipelines import ddim_inversion as jax_inversion

    from videop2p_tpu_torch.pipelines import ddim_inversion

    s = setup
    jtraj, jattn = _jit(lambda p, x: jax_inversion(
        s["jfn"], p, s["jsched"], x, s["cond"][:1], num_inference_steps=STEPS,
        attn_maps=True), s["params"], s["x0"])
    traj, attn = ddim_inversion(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                num_inference_steps=STEPS, attn_maps=True)
    _assert_attn(attn, jattn)
    assert torch.equal(traj, ddim_inversion(s["pfn"], s["psched"], t(s["x0"]),
                                            t(s["cond"][:1]), num_inference_steps=STEPS))
