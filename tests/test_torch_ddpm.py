"""The port's schedulers against the JAX package's (Queue 1 item 7 and Stage
1's DDPM): the β schedules, DDPM's forward process and training targets,
DDIM's steps under every prediction type, the timestep-subset walk and its
checks, and a cached edit over a timestep subset of one capture.

Tolerances: the β schedules exactly (both float64 numpy cast to float32);
scheduler outputs 1e-6 (float32 on both sides, the same formulas; measured
≤ 5e-7); the cached subset edit 2e-4 on one shared capture, as the full
cached edit in ``tests/test_torch_cached.py``, and stream 0 exactly x_0.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_cached import STEPS, _jax_capture, _port_cached, setup  # noqa: F401
from tests.test_torch_parity import np32, t

TOL = 1e-6
SCHEDULES = [("linear", 1e-4, 2e-2), ("scaled_linear", 0.00085, 0.012),
             ("squaredcos_cap_v2", 1e-4, 2e-2)]


@pytest.mark.parametrize("schedule,start,end", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_beta_schedules_equal_jax(schedule, start, end):
    from videop2p_tpu.core.ddim import make_beta_schedule as jax_betas

    from videop2p_tpu_torch.core import make_beta_schedule

    for n in (10, 1000):
        np.testing.assert_array_equal(make_beta_schedule(schedule, n, start, end),
                                      jax_betas(schedule, n, start, end))
    np.testing.assert_array_equal(make_beta_schedule("squaredcos_cap_v2", 5, 0, 0, max_beta=0.5),
                                  jax_betas("squaredcos_cap_v2", 5, 0, 0, max_beta=0.5))
    with pytest.raises(ValueError, match="unknown beta schedule"):
        make_beta_schedule("quadratic", 10, start, end)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_ddpm_matches_jax(prediction_type, schedule):
    from videop2p_tpu.core import DDPMScheduler as JaxDDPM

    from videop2p_tpu_torch.core import DDPMScheduler

    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.normal(size=x.shape).astype(np.float32)
    ts = np.array([0, 517, 999])
    jsched = JaxDDPM.create_sd(beta_schedule=schedule, prediction_type=prediction_type)
    sched = DDPMScheduler.create_sd(beta_schedule=schedule, prediction_type=prediction_type)
    np.testing.assert_array_equal(sched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))
    for name in ("add_noise", "get_velocity", "training_target"):
        want = getattr(jsched, name)(x, noise, ts)
        got = getattr(sched, name)(t(x), t(noise), torch.as_tensor(ts))
        np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=TOL, err_msg=name)
    with pytest.raises(ValueError, match="prediction_type"):
        DDPMScheduler.create(prediction_type="sample").training_target(
            t(x), t(noise), torch.as_tensor(ts))


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("schedule", ["scaled_linear", "squaredcos_cap_v2"])
def test_ddim_steps_match_jax(prediction_type, schedule):
    """``step`` (η 0 and 0.5, clipped and not, an explicit landing
    timestep), ``prev_step`` and ``next_step``, and ``from_config``."""
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.core import DDIMScheduler

    rng = np.random.default_rng(1)
    mo, x, noise = (rng.normal(size=(2, 2, 4, 4, 4)).astype(np.float32) for _ in range(3))
    cfg = {"beta_start": 0.00085, "beta_end": 0.012, "beta_schedule": schedule,
           "clip_sample": False, "set_alpha_to_one": False, "steps_offset": 1,
           "prediction_type": prediction_type, "_class_name": "DDIMScheduler"}
    for clip in (False, True):
        jsched = JaxDDIM.from_config(dict(cfg, clip_sample=clip))
        sched = DDIMScheduler.from_config(dict(cfg, clip_sample=clip))
        assert sched.prediction_type == prediction_type
        for ts in (981, 21, 1):
            for eta in (0.0, 0.5):
                kw = dict(eta=eta, variance_noise=noise if eta else None)
                want = jsched.step(mo, ts, x, 50, **kw)
                got = sched.step(t(mo), ts, t(x), 50, eta=eta,
                                 variance_noise=t(noise) if eta else None)
                for g, w in zip(got, want):
                    np.testing.assert_allclose(np32(g), np32(w), rtol=0, atol=TOL)
            got = sched.step(t(mo), ts, t(x), 50, prev_timestep=ts - 7)[0]
            want = jsched.step(mo, ts, x, 50, prev_timestep=ts - 7)[0]
            np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=TOL)
            np.testing.assert_allclose(np32(sched.prev_step(t(mo), ts, t(x), 50)),
                                       np32(jsched.prev_step(mo, ts, x, 50)), rtol=0, atol=TOL)
            np.testing.assert_allclose(np32(sched.next_step(t(mo), ts, t(x), 50)),
                                       np32(jsched.next_step(mo, ts, x, 50)), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="prediction_type"):
        DDIMScheduler.create(prediction_type="x0")


@pytest.mark.parametrize("base", [1, 4, 10, 50])
def test_subset_schedule_equals_jax(base):
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.core import DDIMScheduler

    jsched, sched = JaxDDIM.create_sd(steps_offset=1), DDIMScheduler.create_sd(steps_offset=1)
    for steps in range(1, base + 1):
        np.testing.assert_array_equal(sched.subset_positions(base, steps),
                                      jsched.subset_positions(base, steps))
        for got, want in zip(sched.subset_schedule(base, steps),
                             jsched.subset_schedule(base, steps)):
            np.testing.assert_array_equal(got, want)
    _, ts, prev = sched.subset_schedule(base, base)
    np.testing.assert_array_equal(prev, ts - 1000 // base)
    for steps in (0, base + 1):
        with pytest.raises(ValueError, match="must be in"):
            sched.subset_positions(base, steps)


@pytest.mark.parametrize("positions", [[0, 2], [0], [0, 1, 3], [1, 2], [0, 0, 1], [0, 3, 2],
                                       [0, 4], [], [[0, 1]]],
                         ids=lambda p: str(p).replace(" ", ""))
def test_validate_step_positions_matches_jax(positions):
    from videop2p_tpu.pipelines.cached import validate_step_positions as jax_validate

    from videop2p_tpu_torch.pipelines.cached import validate_step_positions

    try:
        want = jax_validate(positions, 4)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            validate_step_positions(positions, 4)
        assert str(got.value) == str(err)
    else:
        np.testing.assert_array_equal(validate_step_positions(positions, 4), want)


@pytest.mark.parametrize("windows", [(2, (0, 2)), (1, (0, 2)), (2, (1, 2)), (0, (0, 0)),
                                     (4, (0, 4))], ids=str)
@pytest.mark.parametrize("positions", [[0, 1], [0, 2], [0, 3]], ids=str)
def test_check_subset_windows_raises_as_jax(windows, positions):
    """A 2-step subset controller (cross 0.5, self 0.5) over captures with
    various windows: both packages raise on the same ones, with the same
    message."""
    from types import SimpleNamespace

    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.pipelines.cached import check_subset_windows as jax_check
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from tests.test_torch_cached import CTRL, PROMPTS
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.pipelines.cached import check_subset_windows
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    cached = SimpleNamespace(cross_len=windows[0], self_window=windows[1])
    jctx = jax_make(PROMPTS, JaxTok(), 2, **CTRL)
    pctx = make_controller(PROMPTS, WordTokenizer(), 2, **CTRL)
    try:
        jax_check(jctx, cached, np.asarray(positions), 2)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            check_subset_windows(pctx, cached, np.asarray(positions), 2)
        assert str(got.value) == str(err)
    else:
        check_subset_windows(pctx, cached, np.asarray(positions), 2)
    check_subset_windows(None, cached, positions, 2)


def test_cached_subset_edit_matches_jax_on_one_capture(setup):  # noqa: F811
    """A 2-step edit over base positions [0, 2] of JAX's 4-step capture,
    its controller built for 2 steps, in both packages."""
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.pipelines import edit_sample as jax_edit
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from tests.test_torch_cached import CTRL, PROMPTS
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.pipelines import edit_sample
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    s = setup
    positions = s["psched"].subset_positions(STEPS, 2)
    np.testing.assert_array_equal(positions, [0, 2])
    jctx = jax_make(PROMPTS, JaxTok(), 2, **CTRL)
    pctx = make_controller(PROMPTS, WordTokenizer(), 2, **CTRL)
    jtraj, jcached = _jax_capture(s)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt, c: jax_edit(
            s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"], num_inference_steps=2,
            ctx=jctx, source_uses_cfg=False, cached_source=c,
            step_positions=positions))(s["params"], jtraj[-1], jcached)
    cached = _port_cached(jcached)
    kw = dict(num_inference_steps=2, ctx=pctx, source_uses_cfg=False, cached_source=cached)
    got = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                      step_positions=positions, **kw)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)
    np.testing.assert_array_equal(np32(got[0]), s["x0"][0])
    full = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                       **dict(kw, num_inference_steps=STEPS, ctx=s["pctx"]))
    assert np.abs(np32(full[1]) - np32(got[1])).max() > 1e-3
    # the checks of edit_sample, as JAX words them
    with pytest.raises(ValueError, match="requires cached_source"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=2, step_positions=positions)
    with pytest.raises(ValueError, match="step_positions has 2 entries, edit runs 3"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                    step_positions=positions, **dict(kw, num_inference_steps=3))
    with pytest.raises(ValueError, match="pass step_positions"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]), **kw)


def test_full_subset_walk_is_the_uniform_walk(setup):  # noqa: F811
    """``step_positions = arange(steps)`` gives the plain cached edit bit for
    bit (the explicit landing timesteps are the uniform rule's)."""
    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    _, jcached = _jax_capture(s)
    jtraj, _ = _jax_capture(s)
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
              cached_source=_port_cached(jcached))
    plain = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]), **kw)
    subset = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                         step_positions=np.arange(STEPS), **kw)
    assert torch.equal(plain, subset)
