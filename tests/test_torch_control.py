"""The port's control layer and scheduler against the JAX package: golden
comparisons on the six ``configs/*-p2p.yaml`` prompt pairs,
and the edit functions on identical random probabilities.

Mappers, alphas, word indices and equalizers are host-side integer/0-1
arrays: held equal exactly. The edit functions and the scheduler are float32
math on identical inputs: 1e-6 absolute (no reduction of more than 77 terms).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from tests.test_torch_parity import np32, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P2P_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*-p2p.yaml")))


def _load(path):
    with open(path) as fh:
        return yaml.safe_load(fh)


def _controller_kwargs(cfg, num_steps=50):
    blend = cfg.get("blend_word")
    return dict(
        is_replace_controller=bool(cfg["is_word_swap"]),
        cross_replace_steps=cfg.get("cross_replace_steps", 0.2),
        self_replace_steps=cfg.get("self_replace_steps", 0.5),
        blend_words=((blend[0],), (blend[1],)) if blend else None,
        equalizer_params=cfg.get("eq_params"),
    )


@pytest.mark.parametrize("path", P2P_CONFIGS, ids=os.path.basename)
def test_controller_goldens_match_jax(path):
    from videop2p_tpu.control import get_refinement_mapper as jax_refine
    from videop2p_tpu.control import get_replacement_mapper as jax_replace
    from videop2p_tpu.control import get_word_inds as jax_inds
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import (
        get_refinement_mapper,
        get_replacement_mapper,
        get_word_inds,
        make_controller,
    )
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    cfg = _load(path)
    prompts = cfg["prompts"]
    jtok, ptok = JaxTok(), WordTokenizer()
    for prompt in prompts:
        assert ptok.encode_padded(prompt) == jtok.encode_padded(prompt)
        for word in prompt.split(" "):
            np.testing.assert_array_equal(get_word_inds(prompt, word, ptok),
                                          jax_inds(prompt, word, jtok))
    if cfg["is_word_swap"]:
        np.testing.assert_array_equal(get_replacement_mapper(prompts, ptok),
                                      jax_replace(prompts, jtok))
    else:
        for got, want in zip(get_refinement_mapper(prompts, ptok),
                             jax_refine(prompts, jtok)):
            np.testing.assert_array_equal(got, want)

    kw = _controller_kwargs(cfg)
    jctx = jax_make(prompts, jtok, 50, **kw)
    pctx = make_controller(prompts, ptok, 50, device="cpu", **kw)
    assert pctx.kind == jctx.kind and pctx.num_prompts == jctx.num_prompts
    assert pctx.self_replace_range == jctx.self_replace_range
    for name in ("cross_replace_alpha", "refine_mapper", "refine_alphas",
                 "replace_mapper", "equalizer"):
        got, want = getattr(pctx, name), getattr(jctx, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    if jctx.blend is not None:
        np.testing.assert_array_equal(pctx.blend.alpha_layers.numpy(),
                                      np.asarray(jctx.blend.alpha_layers))
        assert pctx.blend.start_blend == jctx.blend.start_blend
        assert tuple(pctx.blend.th) == tuple(jctx.blend.th)


def _ctx_pair(kind):
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    cfg = _load(os.path.join(REPO, "configs",
                             "rabbit-jump-p2p.yaml" if kind == "refine"
                             else "car-drive-p2p.yaml"))
    kw = _controller_kwargs(cfg, 10)
    kw["cross_replace_steps"] = 0.8
    return (jax_make(cfg["prompts"], JaxTok(), 10, **kw),
            make_controller(cfg["prompts"], WordTokenizer(), 10, device="cpu", **kw))


@pytest.mark.parametrize("kind", ["refine", "replace"])
@pytest.mark.parametrize("site", ["cross", "temporal"])
def test_control_attention_matches_jax(kind, site):
    """The fast CFG layout (1 uncond + 2 cond streams) at a step inside both
    windows and at one outside the temporal window."""
    from videop2p_tpu.control import control_attention as jax_control

    from videop2p_tpu_torch.control import control_attention

    jctx, pctx = _ctx_pair(kind)
    rng = np.random.default_rng(0)
    frames = 3
    if site == "cross":
        logits = rng.normal(size=(3 * frames, 2, 16, 77))
    else:
        logits = rng.normal(size=(3 * 16, 2, frames, frames))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    for step in (1, 7):
        want = jax_control(jnp.asarray(probs), jctx, is_cross=site == "cross",
                           step_index=jnp.asarray(step), video_length=frames,
                           num_uncond=1)
        got = control_attention(t(probs), pctx, is_cross=site == "cross",
                                step_index=step, video_length=frames, num_uncond=1)
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-6)


def test_control_attention_temporal_rows_are_exact():
    """A temporal map with fewer query rows than frames is refused unless
    the frames are split over as many shards as make up the difference;
    a shard's rows of the edit are the whole edit's rows."""
    from videop2p_tpu_torch.control import control_attention

    _, pctx = _ctx_pair("refine")
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3 * 16, 2, 4, 4))
    probs = t((np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32))
    kw = dict(is_cross=False, step_index=1, video_length=4, num_uncond=1)
    whole = control_attention(probs, pctx, **kw)
    rows = probs[:, :, 2:]
    with pytest.raises(ValueError, match="temporal attention maps must be"):
        control_attention(rows, pctx, **kw)
    with pytest.raises(ValueError, match="temporal attention maps must be"):
        control_attention(probs[:, :, :1], pctx, frame_shards=2, **kw)
    got = control_attention(rows, pctx, frame_shards=2, **kw)
    np.testing.assert_array_equal(got.numpy(), whole[:, :, 2:].numpy())


def test_local_blend_matches_jax():
    from videop2p_tpu.control import blend_mask as jax_mask
    from videop2p_tpu.control import local_blend as jax_blend

    from videop2p_tpu_torch.control import blend_mask, local_blend

    jctx, pctx = _ctx_pair("refine")
    rng = np.random.default_rng(1)
    # peaked maps, so the thresholded mask is neither empty nor full
    maps = (rng.random(size=(2, 3, 2, 4, 4, 77)) ** 12).astype(np.float32)
    x_t = rng.normal(size=(2, 3, 16, 16, 4)).astype(np.float32)
    want_mask = jax_mask(jnp.asarray(maps), jctx.blend, (16, 16))
    got_mask = blend_mask(t(maps), pctx.blend, (16, 16))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert 0 < got_mask.float().mean() < 1
    for step in (0, 5):
        want = jax_blend(jnp.asarray(x_t), jnp.asarray(maps), jctx.blend,
                         jnp.asarray(step))
        got = local_blend(t(x_t), t(maps), pctx.blend, step)
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-6)


@pytest.mark.parametrize("config", [{}, {"steps_offset": 1}])
def test_ddim_scheduler_matches_jax(config):
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.core import DDIMScheduler

    if config:
        # a checkpoint's scheduler_config.json: the SD schedule plus its keys
        sd = dict(beta_start=0.00085, beta_end=0.012, beta_schedule="scaled_linear",
                  clip_sample=False, set_alpha_to_one=False, **config)
        jsched, psched = JaxDDIM.from_config(sd), DDIMScheduler.from_config(sd)
    else:
        jsched, psched = JaxDDIM.create_sd(), DDIMScheduler.create_sd()
    np.testing.assert_array_equal(psched.timesteps(50), jsched.timesteps(50))
    np.testing.assert_array_equal(psched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 4, 4)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    for ts in (int(psched.timesteps(50)[0]), int(psched.timesteps(50)[-1]), 500):
        want, want_x0 = jsched.step(jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x), 50)
        got, got_x0 = psched.step(t(eps), ts, t(x), 50)
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(np32(got_x0), np32(want_x0), atol=1e-6, rtol=1e-6)
        for name in ("next_step", "prev_step"):
            want = getattr(jsched, name)(jnp.asarray(eps), jnp.asarray(ts), jnp.asarray(x), 50)
            got = getattr(psched, name)(t(eps), ts, t(x), 50)
            np.testing.assert_allclose(np32(got), np32(want), atol=1e-6, rtol=1e-6)


def test_ddim_prediction_types_match_jax():
    """The scheduler's own defaults (linear betas, clipped x0, final ᾱ = 1)
    on a 10-step grid down to t < 0, under each prediction type and with
    the cosine β schedule; an unknown name raises."""
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.core import DDIMScheduler

    for unknown in (dict(prediction_type="x0"), dict(beta_schedule="quadratic")):
        with pytest.raises(ValueError):
            DDIMScheduler.create(**unknown)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    out = rng.normal(size=x.shape).astype(np.float32)
    for kw in (dict(), dict(prediction_type="v_prediction"), dict(prediction_type="sample"),
               dict(beta_schedule="squaredcos_cap_v2")):
        jsched = JaxDDIM.create(**kw)
        psched = DDIMScheduler.create(**kw)
        for ts in psched.timesteps(10):
            want, want_x0 = jsched.step(jnp.asarray(out), jnp.asarray(int(ts)),
                                        jnp.asarray(x), 10)
            got, got_x0 = psched.step(t(out), int(ts), t(x), 10)
            np.testing.assert_allclose(np32(got), np32(want), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(np32(got_x0), np32(want_x0), atol=1e-6, rtol=1e-6)


def test_equalizer_raises_where_the_reference_is_silent():
    from videop2p_tpu_torch.control import get_equalizer
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    tok = WordTokenizer()
    with pytest.raises(ValueError):
        get_equalizer("a origami rabbit", ["lego"], [2], tok)
    with pytest.raises(ValueError):
        get_equalizer("a origami rabbit", ["origami"], [2, 3], tok)
    eq = get_equalizer("a origami rabbit", ["origami"], [2], tok)
    assert eq.shape == (1, 77) and eq[0, 2] == 2 and eq.sum() == 78
