"""The consistency-distilled student's cached edit in the port
(``edit_sample`` / ``cached_fast_edit`` ``student_head=``), on the CPU in
float32 with the tiny-UNet weights, capture and controller of
tests/test_torch_cached.py.

An untrained student (a zero head) and the teacher: bit for bit, over the
full grid and over a timestep subset with deep-feature reuse, stream 0 the
capture's x_0 (src_err == 0.0). A JAX student (a non-zero head and a moved
subset) against JAX's ``edit_sample(student_head=)`` on JAX's capture:
2e-4, as the teacher's edit on one shared capture in
tests/test_torch_cached.py (float32 through 4 controlled steps, guidance 7.5
amplifying the UNet's summation-order differences, ~1e-6, about tenfold).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cached import (  # noqa: F401  (the fixture)
    CTRL,
    PROMPTS,
    STEPS,
    _jax_capture,
    _port_cached,
    setup,
)
from tests.test_torch_distill import _np_head, _port_head
from tests.test_torch_parity import np32, t


def test_untrained_student_edit_is_the_teacher_bit_for_bit(setup):
    """A zero head leaves ε as it is: the cached edit, and the edit over a
    timestep subset with deep-feature reuse, equal the teacher's bit for
    bit, and stream 0 stays the capture's x_0 (src_err == 0.0)."""
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.models.unet import UNet3DConfig
    from videop2p_tpu_torch.pipelines import cached_fast_edit, edit_sample
    from videop2p_tpu_torch.train import init_time_head
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    s = setup
    head = init_time_head(torch.Generator().manual_seed(0), UNet3DConfig.tiny())
    args = (s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]),
            t(s["uncond"]), s["pctx"])
    kw = dict(num_inference_steps=STEPS, cross_len=STEPS, self_window=(0, STEPS))
    traj, teacher = cached_fast_edit(*args, **kw)
    _, student = cached_fast_edit(*args, **kw, student_head=head)
    assert torch.equal(student, teacher)
    assert np.abs(np32(student[0]) - s["x0"][0]).max() == 0.0
    # 2 subset steps of the 4-step capture, a full step then a shallow one
    _, cached = _port_cached_of(s)
    ctx2 = make_controller(PROMPTS, WordTokenizer(), 2, **CTRL)
    sub = dict(num_inference_steps=2, ctx=ctx2, source_uses_cfg=False, cached_source=cached,
               step_positions=[0, 2], reuse_schedule="uniform:2")
    teacher = edit_sample(s["pfn"], s["psched"], traj[-1], t(s["cond"]), t(s["uncond"]), **sub)
    student = edit_sample(s["pfn"], s["psched"], traj[-1], t(s["cond"]), t(s["uncond"]), **sub,
                          student_head=head)
    assert torch.equal(student, teacher)
    assert np.abs(np32(student[0]) - s["x0"][0]).max() == 0.0
    with pytest.raises(ValueError, match="student seam"):
        edit_sample(s["pfn"], s["psched"], traj[-1], t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=STEPS, student_head=head)


def _port_cached_of(s):
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured

    return ddim_inversion_captured(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                   num_inference_steps=STEPS, cross_len=STEPS,
                                   self_window=(0, STEPS), capture_blend=True)


def test_student_edit_matches_jax_on_one_capture(setup):
    """A JAX student (its head, and its subset moved from the teacher's by
    seeded noise) carried into the port: ``edit_sample(cached_source=,
    student_head=)`` of both packages on JAX's capture."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit
    from videop2p_tpu.train.masking import merge_params, partition_params

    from videop2p_tpu_torch.models.convert import unet_state_dict_from_jax
    from videop2p_tpu_torch.pipelines import edit_sample, make_unet_fn

    s = setup
    rng = np.random.default_rng(9)
    trainable, frozen = partition_params(s["params"]["params"])
    trainable = jax.tree.map(
        lambda p: p + jnp.asarray(0.05 * rng.normal(size=p.shape), jnp.float32), trainable)
    student = {"params": merge_params(trainable, frozen)}
    head = _np_head(4)
    pmodel = copy.deepcopy(s["pmodel"])
    pmodel.load_state_dict(unet_state_dict_from_jax(student["params"]), strict=True)
    jtraj, jcached = _jax_capture(s)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt, c, h: jax_edit(
            s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"],
            num_inference_steps=STEPS, ctx=s["jctx"], source_uses_cfg=False,
            cached_source=c, student_head=h))(student, jtraj[-1], jcached,
                                              jax.tree.map(jnp.asarray, head))
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
              cached_source=_port_cached(jcached))
    got = edit_sample(make_unet_fn(pmodel), s["psched"], t(jtraj[-1]), t(s["cond"]),
                      t(s["uncond"]), **kw, student_head=_port_head(head))
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)
    np.testing.assert_array_equal(np32(got[0]), s["x0"][0])
    teacher = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                          **kw)
    assert np.abs(np32(got[1]) - np32(teacher[1])).max() > 1e-2
