"""The dependent noise through the port's pipelines against the JAX
package's, on the CPU in float32 with identical tiny-UNet weights (4 frames,
two windows of 2, AR-chained), inputs and controller.

A torch generator cannot replay JAX's key stream, so each test re-derives
JAX's draws from its key splits (the ``Replay`` sampler below, in JAX's call
order: one split a step in the inversions and the edit; per null-text outer
step a split into (key, k_cond, k_fu, k_fc), k_cond's draw, one split of the
running key for each inner loss evaluation, then k_fu's and k_fc's draws)
and feeds them to the port in the order the port draws. A draw of the wrong
shape, a left-over draw or a missing one fails the test.

Tolerances are those of the parity tests of the same functions: the
trajectories 1e-4 (``tests/test_torch_cached.py``); the cached edit 1e-2
end to end, each package editing from its own capture, and stream 0 exactly
x_0 (src_err == 0.0); null-text's final losses 1e-4 relative (bf16 "mixed"
5e-2), its inner steps exactly and its embeddings within 2·lr_0 = 0.02
(``tests/test_torch_nulltext.py``); the full-CFG edit 2e-4 and
``official_edit``'s latents 2e-3 (``tests/test_torch_official.py``). A
zero weight is held bit for bit against no dependent arguments.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t, tiny_unet_pair

STEPS = 3
SHAPE = (1, 4, 8, 8, 4)  # (B, F, h, w, C): two windows of two frames
PROMPTS = ["a rabbit is jumping on the grass",
           "a origami rabbit is jumping on the grass"]
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.8,
            self_replace_steps=0.5, blend_words=(("rabbit",), ("rabbit",)),
            equalizer_params={"words": ["origami"], "values": [2]})
SAMPLER = dict(num_frames=4, decay_rate=0.3, window_size=2, ar_sample=True, ar_coeff=0.1)
WEIGHT = 0.2
LOSS_RTOL = 1e-4
MIXED_LOSS_RTOL = 5e-2
EMB_BOUND = 2 * 1e-2


class Replay:
    """A sampler that hands out given draws in order (the port's pipelines
    call only ``sample_like``)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def sample_like(self, x, generator):
        assert isinstance(generator, torch.Generator)
        noise = torch.tensor(self.draws.pop(0))
        assert tuple(noise.shape) == tuple(x.shape), (noise.shape, x.shape)
        return noise.to(x.dtype)


def _draw(s, key, shape):
    return np.asarray(s["jsampler"].sample(key, shape))


def _step_draws(s, key, steps, shape):
    """One split a step: ``ddim_inversion``, ``ddim_inversion_captured``,
    ``edit_sample``."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_draw(s, sub, shape))
    return out


def _null_text_draws(s, key, inner_steps, shape, mode="optimize"):
    out = []
    for n in inner_steps:
        if mode == "amortized":
            key, k_fu, k_fc = jax.random.split(key, 3)
        else:
            key, k_cond, k_fu, k_fc = jax.random.split(key, 4)
            out.append(_draw(s, k_cond, shape))
            for _ in range(int(n)):
                key, sub = jax.random.split(key)
                out.append(_draw(s, sub, shape))
        out += [_draw(s, k_fu, shape), _draw(s, k_fc, shape)]
    return out


@pytest.fixture(scope="module")
def setup():
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler, DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    jmodel, variables, pmodel = tiny_unet_pair(seed=5, frames=SHAPE[1])
    rng = np.random.default_rng(4)
    return dict(
        jmodel=jmodel, jfn=jax_unet_fn(jmodel), params=variables, jsched=JaxDDIM.create_sd(),
        jsampler=JaxSampler.create(**SAMPLER),
        jctx=jax_make(PROMPTS, JaxTok(), STEPS, **CTRL),
        pmodel=pmodel, pfn=make_unet_fn(pmodel), psched=DDIMScheduler.create_sd(),
        psampler=DependentNoiseSampler.create(**SAMPLER),
        pctx=make_controller(PROMPTS, WordTokenizer(), STEPS, **CTRL),
        x0=rng.normal(size=SHAPE).astype(np.float32),
        cond=rng.normal(size=(2, 77, 16)).astype(np.float32),
        uncond=rng.normal(size=(77, 16)).astype(np.float32),
        key=jax.random.key(7))


def _jax_trajectory(s):
    """JAX's dependent inversion of x0, once per module."""
    from videop2p_tpu.pipelines import ddim_inversion as jax_invert

    if "jtraj" not in s:
        with jax.default_matmul_precision("highest"):
            s["jtraj"] = np.asarray(jax.jit(lambda p, x, k: jax_invert(
                s["jfn"], p, s["jsched"], x, s["cond"][:1], num_inference_steps=STEPS,
                dependent_weight=WEIGHT, dependent_sampler=s["jsampler"], key=k))(
                    s["params"], s["x0"], s["key"]))
    return s["jtraj"]


def test_ddim_inversion_matches_jax_on_its_draws(setup):
    from videop2p_tpu_torch.pipelines import ddim_inversion

    s = setup
    want = _jax_trajectory(s)
    replay = Replay(_step_draws(s, s["key"], STEPS, SHAPE))
    got = ddim_inversion(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                         num_inference_steps=STEPS, dependent_weight=WEIGHT,
                         dependent_sampler=replay)
    assert replay.draws == []
    np.testing.assert_allclose(np32(got), want, atol=1e-4)
    plain = ddim_inversion(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                           num_inference_steps=STEPS)
    assert (got[-1] - plain[-1]).abs().max() > 1e-3  # the blend moved the walk


def test_cached_fast_edit_matches_jax_on_its_draws(setup):
    """``ddim_inversion_captured`` + the cached edit: the capture draws one
    noise a step, and stream 0 still replays x_0 exactly."""
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.pipelines import cached_fast_edit
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    s = setup
    cross_len, self_window = capture_windows(s["pctx"], STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
              self_window=self_window, dependent_weight=WEIGHT)
    with jax.default_matmul_precision("highest"):
        jtraj, want = jax.jit(lambda p, x, k: jax_cached_edit(
            s["jfn"], p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"], s["jctx"],
            dependent_sampler=s["jsampler"], key=k, **kw))(s["params"], s["x0"], s["key"])
    replay = Replay(_step_draws(s, s["key"], STEPS, SHAPE))
    traj, got = cached_fast_edit(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                 t(s["cond"]), t(s["uncond"]), s["pctx"],
                                 dependent_sampler=replay, **kw)
    assert replay.draws == []
    np.testing.assert_allclose(np32(traj), np32(jtraj), atol=1e-4)
    np.testing.assert_allclose(np32(traj), _jax_trajectory(s), atol=1e-4)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-2)
    assert np.abs(np32(got[0]) - s["x0"][0]).max() == 0.0
    np.testing.assert_array_equal(np32(want[0]), s["x0"][0])


@pytest.mark.parametrize("kw", [
    dict(num_inner_steps=3),
    dict(num_inner_steps=3, epsilon=15.0),  # early stop in some outer steps
    dict(num_inner_steps=2, early_stop=False),
    dict(num_inner_steps=3, null_text_mode="amortized"),
    dict(num_inner_steps=2, null_text_precision="mixed"),
], ids=["optimize", "early_stop", "fixed_work", "amortized", "mixed"])
def test_null_text_optimization_matches_jax_on_its_draws(setup, kw):
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.pipelines.inversion import null_text_optimization as jax_null_text

    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    traj = _jax_trajectory(s)
    jfn, pfn = s["jfn"], s["pfn"]
    mixed = kw.get("null_text_precision") == "mixed"
    if mixed:
        jfn = jax_unet_fn(s["jmodel"].clone(dtype=jnp.bfloat16))
        pfn = make_unet_fn(copy.deepcopy(s["pmodel"]).to(torch.bfloat16))
    common = dict(num_inference_steps=STEPS, return_losses=True, return_inner_steps=True,
                  dependent_weight=WEIGHT, **kw)
    with jax.default_matmul_precision("highest"):
        want = jax_null_text(jfn, s["params"], s["jsched"], traj, s["cond"][:1],
                             s["uncond"][None], dependent_sampler=s["jsampler"],
                             key=s["key"], **common)
    inner = np.asarray(want[2])
    if "epsilon" in kw:  # the early stop cut some outer steps, not all
        assert inner.min() < kw["num_inner_steps"] == inner.max()
    replay = Replay(_null_text_draws(s, s["key"], inner, SHAPE,
                                     kw.get("null_text_mode", "optimize")))
    emb, losses, got_inner = null_text_optimization(
        pfn, s["psched"], t(traj), t(s["cond"][:1]), t(s["uncond"][None]),
        dependent_sampler=replay, **common)
    assert replay.draws == []
    np.testing.assert_array_equal(got_inner.numpy(), inner)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want[1]),
                               rtol=MIXED_LOSS_RTOL if mixed else LOSS_RTOL)
    if not mixed:
        assert np.abs(np32(emb) - np.asarray(want[0])).max() <= EMB_BOUND


def test_full_cfg_edit_with_eta_draws_through_the_sampler(setup):
    """η > 0 with a sampler: each step's noise is a draw of the sampler
    (JAX: one split a step)."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    x_t = _jax_trajectory(s)[-1]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x, k: jax_edit(
            s["jfn"], p, s["jsched"], x, s["cond"], s["uncond"], num_inference_steps=STEPS,
            ctx=s["jctx"], source_uses_cfg=True, eta=0.7, key=k,
            dependent_sampler=s["jsampler"]))(s["params"], x_t, s["key"])
    replay = Replay(_step_draws(s, s["key"], STEPS, (2,) + SHAPE[1:]))
    got = edit_sample(s["pfn"], s["psched"], t(x_t), t(s["cond"]), t(s["uncond"]),
                      num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=True,
                      eta=0.7, generator=torch.Generator().manual_seed(0),
                      dependent_sampler=replay)
    assert replay.draws == []
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)


def test_official_edit_matches_jax_on_its_draws(setup):
    """``official_edit`` with dependent noise and η > 0: the null-text
    phase's draws (JAX: from the first half of the key's split), then the
    edit's (the second half)."""
    from videop2p_tpu.pipelines import official_edit as jax_official

    from videop2p_tpu_torch.pipelines import official_edit

    s = setup
    traj = _jax_trajectory(s)
    kw = dict(num_inference_steps=STEPS, num_inner_steps=2, eta=0.5,
              dependent_weight=WEIGHT)
    with jax.default_matmul_precision("highest"):
        want, stats = jax_official(s["jfn"], s["params"], s["jsched"], traj, s["cond"],
                                   s["uncond"], ctx=s["jctx"], key=s["key"],
                                   dependent_sampler=s["jsampler"], return_null_stats=True,
                                   donate=False, **kw)
    k_null, k_edit = jax.random.split(s["key"])
    replay = Replay(_null_text_draws(s, k_null, np.asarray(stats["inner_steps"]), SHAPE)
                    + _step_draws(s, k_edit, STEPS, (2,) + SHAPE[1:]))
    got, got_stats = official_edit(s["pfn"], s["psched"], t(traj), t(s["cond"]),
                                   t(s["uncond"]), ctx=s["pctx"],
                                   generator=torch.Generator().manual_seed(0),
                                   dependent_sampler=replay, **kw)
    assert replay.draws == []
    np.testing.assert_array_equal(got_stats["inner_steps"].numpy(),
                                  np.asarray(stats["inner_steps"]))
    np.testing.assert_allclose(got_stats["final_loss"].numpy(),
                               np.asarray(stats["final_loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-3)


def test_zero_weight_is_bit_identical_to_no_dependent_arguments(setup):
    from videop2p_tpu_torch.pipelines import ddim_inversion, ddim_inversion_captured
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    args = (s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]))
    zero = dict(dependent_weight=0.0, dependent_sampler=s["psampler"],
                generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ddim_inversion(*args, num_inference_steps=STEPS, **zero),
                               ddim_inversion(*args, num_inference_steps=STEPS),
                               rtol=0, atol=0)
    cap = dict(num_inference_steps=STEPS, cross_len=2, self_window=(0, 1))
    (a, ca), (b, cb) = (ddim_inversion_captured(*args, **cap, **zero),
                        ddim_inversion_captured(*args, **cap))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for path in cb.cross_maps:
        torch.testing.assert_close(ca.cross_maps[path], cb.cross_maps[path], rtol=0, atol=0)
    traj = t(_jax_trajectory(s))
    for mode in ("optimize", "amortized"):
        nargs = (s["pfn"], s["psched"], traj, t(s["cond"][:1]), t(s["uncond"][None]))
        nkw = dict(num_inference_steps=STEPS, num_inner_steps=2, null_text_mode=mode,
                   return_losses=True)
        for x, y in zip(null_text_optimization(*nargs, **nkw, **zero),
                        null_text_optimization(*nargs, **nkw)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_weight_without_a_sampler_raises(setup):
    from videop2p_tpu_torch.pipelines import (
        cached_fast_edit,
        ddim_inversion,
        ddim_inversion_captured,
    )
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    s = setup
    args = (s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]))
    for fn in (ddim_inversion, ddim_inversion_captured):
        with pytest.raises(ValueError, match="requires dependent_sampler"):
            fn(*args, num_inference_steps=STEPS, dependent_weight=WEIGHT)
    with pytest.raises(ValueError, match="requires dependent_sampler"):
        cached_fast_edit(*args, t(s["cond"]), t(s["uncond"]), None,
                         num_inference_steps=STEPS, dependent_weight=WEIGHT)
    with pytest.raises(ValueError, match="requires dependent_sampler"):
        null_text_optimization(s["pfn"], s["psched"], t(_jax_trajectory(s)),
                               t(s["cond"][:1]), t(s["uncond"][None]),
                               num_inference_steps=STEPS, dependent_weight=WEIGHT)


def test_port_sampler_draws_through_the_pipelines(setup):
    """The port's own sampler in the walks: a seeded generator repeats the
    run bit for bit, another seed moves it."""
    from videop2p_tpu_torch.pipelines import ddim_inversion

    s = setup
    args = (s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]))

    def run(seed):
        return ddim_inversion(*args, num_inference_steps=STEPS, dependent_weight=WEIGHT,
                              dependent_sampler=s["psampler"],
                              generator=torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a[-1] - c[-1]).abs().max() > 1e-3
