"""The rest of Stage 2's surface in the port against the JAX package, on the
CPU in float32 with identical tiny-UNet weights: the SpatialReplace
controller, per-frame ("multi") conditioning, the UNet's ``deep_mode`` seam,
the cached edit under a deep-feature reuse schedule, and the schedule
grammar.

Tolerances: the UNet's outputs and deep feature 1e-5 (summation order); an
edit on one shared capture 2e-4, as ``tests/test_torch_cached.py`` holds
it (guidance 7.5 amplifies the UNet's ~1e-6 differences about tenfold over
4 steps); a whole cached fast edit of each package from its own capture
1e-2, as there; the live edit 2e-4; where the port claims bits (a schedule
of full steps only against no schedule, per-frame copies of one embedding
against the 3-D path, SpatialReplace's copied source) exactly; the
grammar's results and messages exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cached import (  # noqa: F401
    SHAPE,
    STEPS,
    _jax_capture,
    _port_cached,
    setup,
)
from tests.test_torch_parity import np32, t

EDIT_TOL = 2e-4
FWD_TOL = 1e-5


# ---------------------------------------------------------------- reuse.py


@pytest.mark.parametrize("schedule", [
    None, "off", "", "uniform:1", "uniform:2", "uniform:3", "uniform:0", "uniform:x",
    "custom:0,2,3", "custom:0", "custom:1,2", "custom:0,2,2", "custom:0,5", "custom:",
    "custom:a", "every:2"])
def test_reuse_schedule_grammar_matches_jax(schedule):
    from videop2p_tpu.pipelines import reuse as jax_reuse

    from videop2p_tpu_torch.pipelines import reuse

    for fn in ("parse_reuse_schedule", "validate_reuse_schedule"):
        try:
            want = getattr(jax_reuse, fn)(schedule, 4)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                getattr(reuse, fn)(schedule, 4)
            assert str(got.value) == str(e)
            continue
        assert getattr(reuse, fn)(schedule, 4) == want
    if schedule not in ("uniform:0", "uniform:x", "custom:1,2", "custom:0,2,2",
                        "custom:0,5", "custom:", "custom:a", "every:2"):
        flags = reuse.parse_reuse_schedule(schedule, 4)
        assert reuse.reuse_skip_fraction(flags) == jax_reuse.reuse_skip_fraction(
            jax_reuse.parse_reuse_schedule(schedule, 4))
        assert reuse.reuse_label(schedule) == jax_reuse.reuse_label(schedule)


# ---------------------------------------------------------- deep_mode seam


def test_deep_mode_seam_matches_jax(setup):
    """"capture" returns JAX's ε and deep feature; "shallow" on that deep
    feature returns JAX's ε; "full" is the plain forward, and "capture"'s ε
    equals it bit for bit."""
    s = setup
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2,) + SHAPE[1:]).astype(np.float32)
    text = s["cond"]
    ts = int(s["psched"].timesteps(STEPS)[1])
    with jax.default_matmul_precision("highest"):
        (jeps, jdeep), _ = jax.jit(lambda p, a, c: s["jfn"](
            p, a, ts, c, None, deep_mode="capture"))(s["params"], x, text)
        jshallow, _ = jax.jit(lambda p, a, c, d: s["jfn"](
            p, a, ts, c, None, deep_mode="shallow", deep_feature=d))(
            s["params"], x, text, jdeep)
    with torch.no_grad():
        full, _ = s["pfn"](t(x), ts, t(text), None, store=False)
        (eps, deep), _ = s["pfn"](t(x), ts, t(text), None, store=False,
                                  deep_mode="capture")
        shallow, _ = s["pfn"](t(x), ts, t(text), None, store=False, deep_mode="shallow",
                              deep_feature=t(jdeep))
        plain = s["pmodel"](t(x), ts, t(text))
    assert torch.equal(full, plain) and torch.equal(eps, full)
    np.testing.assert_allclose(np32(eps), np32(jeps), atol=FWD_TOL)
    np.testing.assert_allclose(np32(deep), np32(jdeep), atol=FWD_TOL)
    np.testing.assert_allclose(np32(shallow), np32(jshallow), atol=FWD_TOL)
    with pytest.raises(ValueError, match="deep_feature"):
        s["pmodel"](t(x), ts, t(text), deep_mode="shallow")
    with pytest.raises(ValueError, match="deep_mode"):
        s["pmodel"](t(x), ts, t(text), deep_mode="half")


def test_shallow_step_runs_the_outer_blocks_only(setup):
    """A shallow forward runs conv_in, the first down block without its
    downsampler, the last up block and the output norm: its GroupNorm and
    frame-attention calls are those modules' own."""
    from videop2p_tpu_torch.models.attention import FrameAttention
    from videop2p_tpu_torch.models.layers import TpuGroupNorm

    s = setup
    model = s["pmodel"]
    calls = []
    hooks = [m.register_forward_hook(lambda mod, a, o, name=name: calls.append(name))
             for name, m in model.named_modules()
             if isinstance(m, (TpuGroupNorm, FrameAttention))]
    x = torch.zeros((2,) + SHAPE[1:])
    try:
        with torch.no_grad():
            model(x, 10, t(s["cond"]))
            full = list(calls)
            (_, deep) = model(x, 10, t(s["cond"]), deep_mode="capture")
            calls.clear()
            model(x, 10, t(s["cond"]), deep_mode="shallow", deep_feature=deep)
    finally:
        for h in hooks:
            h.remove()
    outer = ("down_blocks.0.", f"up_blocks.{len(model.up_blocks) - 1}.", "conv_norm_out")
    assert sorted(calls) == sorted(c for c in full if c.startswith(outer))
    assert 0 < len(calls) < len(full)


# ------------------------------------------------- cached edit with reuse


@pytest.mark.parametrize("schedule", ["uniform:2", "custom:0,3"])
def test_cached_edit_with_reuse_schedule_matches_jax(setup, schedule):
    """``edit_sample(cached_source=, reuse_schedule=)`` of both packages on
    JAX's capture (LocalBlend re-adds the last full step's maps on a
    shallow step)."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    jtraj, jcached = _jax_capture(s)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt, c: jax_edit(
            s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"],
            num_inference_steps=STEPS, ctx=s["jctx"], source_uses_cfg=False,
            cached_source=c, reuse_schedule=schedule))(s["params"], jtraj[-1], jcached)
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
              cached_source=_port_cached(jcached))
    got = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                      reuse_schedule=schedule, **kw)
    np.testing.assert_allclose(np32(got), np32(want), atol=EDIT_TOL)
    np.testing.assert_array_equal(np32(got[0]), s["x0"][0])
    plain = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                        **kw)
    assert np.abs(np32(got[1]) - np32(plain[1])).max() > 0
    every = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]),
                        t(s["uncond"]), reuse_schedule="uniform:1", **kw)
    assert torch.equal(every, plain)
    with pytest.raises(ValueError, match="requires cached_source"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                    num_inference_steps=STEPS, source_uses_cfg=False,
                    reuse_schedule=schedule)


def test_cached_fast_edit_with_reuse_schedule_matches_jax(setup):
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.pipelines import cached_fast_edit
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    s = setup
    cross_len, self_window = capture_windows(s["pctx"], STEPS)
    kw = dict(num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
              self_window=self_window, reuse_schedule="uniform:2")
    with jax.default_matmul_precision("highest"):
        _, want = jax.jit(lambda p, x: jax_cached_edit(
            s["jfn"], p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"],
            s["jctx"], **kw))(s["params"], s["x0"])
    _, got = cached_fast_edit(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                              t(s["cond"]), t(s["uncond"]), s["pctx"], **kw)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-2)
    assert np.abs(np32(got[0]) - s["x0"][0]).max() == 0.0


# ------------------------------------------------------ SpatialReplace


def _spatial(stop_inject=0.5):
    from videop2p_tpu.control import make_spatial_replace_controller as jax_spatial

    from videop2p_tpu_torch.control import make_spatial_replace_controller

    return jax_spatial(stop_inject, STEPS), make_spatial_replace_controller(
        stop_inject, STEPS)


def test_spatial_replace_controller_matches_jax():
    jctx, ctx = _spatial(0.3)
    assert ctx.spatial_replace_until == jctx.spatial_replace_until == 2
    assert (ctx.kind, ctx.num_prompts, ctx.self_replace_range) == (
        jctx.kind, jctx.num_prompts, tuple(jctx.self_replace_range))
    np.testing.assert_array_equal(np32(ctx.cross_replace_alpha),
                                  np.asarray(jctx.cross_replace_alpha))


@pytest.mark.parametrize("cfg", [True, False], ids=["official_layout", "fast_layout"])
def test_spatial_replace_live_edit_matches_jax(setup, cfg):
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    jctx, ctx = _spatial()
    xt = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: jax_edit(
            s["jfn"], p, s["jsched"], x, s["cond"], s["uncond"],
            num_inference_steps=STEPS, ctx=jctx, source_uses_cfg=cfg))(s["params"], xt)
    got = edit_sample(s["pfn"], s["psched"], t(xt), t(s["cond"]), t(s["uncond"]),
                      num_inference_steps=STEPS, ctx=ctx, source_uses_cfg=cfg)
    np.testing.assert_allclose(np32(got), np32(want), atol=EDIT_TOL)
    # the edit stream left the source's latent at step 2 and moved on its own
    assert np.abs(np32(got[1]) - np32(got[0])).max() > 0


def test_spatial_replace_cached_edit_matches_jax(setup):
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.pipelines import cached_fast_edit, edit_sample
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    s = setup
    jctx, ctx = _spatial()
    assert capture_windows(ctx, STEPS) == (0, (0, 0))
    with jax.default_matmul_precision("highest"):
        _, want = jax.jit(lambda p, x: jax_cached_edit(
            s["jfn"], p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"], jctx,
            num_inference_steps=STEPS))(s["params"], s["x0"])
    traj, got = cached_fast_edit(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                 t(s["cond"]), t(s["uncond"]), ctx,
                                 num_inference_steps=STEPS)
    np.testing.assert_allclose(np32(got), np32(want), atol=EDIT_TOL)
    # with the whole walk replaced, the edit stream is the source's x_0
    always = edit_sample(s["pfn"], s["psched"], traj[-1], t(s["cond"]), t(s["uncond"]),
                         num_inference_steps=STEPS, source_uses_cfg=False,
                         ctx=_spatial(0.0)[1], cached_source=_port_capture_empty(s))
    assert torch.equal(always[1], always[0])


def _port_capture_empty(s):
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured

    return ddim_inversion_captured(s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
                                   num_inference_steps=STEPS)[1]


# ------------------------------------------------------------ multi


def _per_frame(s):
    return np.random.default_rng(8).normal(size=(2, SHAPE[1], 77, 16)).astype(np.float32)


@pytest.mark.parametrize("null", [False, True], ids=["fast_layout", "official_null"])
def test_multi_live_edit_matches_jax(setup, null):
    """Per-frame cond embeddings (P, F, L, D) in the live edit, the uncond
    broadcast per frame; with null-text embeddings (steps, 1, L, D) in the
    full CFG layout, broadcast per frame too."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    cond = _per_frame(s)
    xt = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    nulls = (np.random.default_rng(9).normal(size=(STEPS, 1, 77, 16)).astype(np.float32)
             if null else None)
    kw = dict(num_inference_steps=STEPS, source_uses_cfg=null)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x, c, n: jax_edit(
            s["jfn"], p, s["jsched"], x, c, s["uncond"], ctx=s["jctx"],
            null_uncond_embeddings=n, **kw))(s["params"], xt, cond, nulls)
    got = edit_sample(s["pfn"], s["psched"], t(xt), t(cond), t(s["uncond"]), ctx=s["pctx"],
                      null_uncond_embeddings=None if nulls is None else t(nulls), **kw)
    np.testing.assert_allclose(np32(got), np32(want), atol=EDIT_TOL)


def test_multi_cached_edit_matches_jax_and_repeats_are_the_plain_edit(setup):
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    cond = _per_frame(s)
    jtraj, jcached = _jax_capture(s)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt, c, cs: jax_edit(
            s["jfn"], p, s["jsched"], xt, cs, s["uncond"], num_inference_steps=STEPS,
            ctx=s["jctx"], source_uses_cfg=False, cached_source=c))(
            s["params"], jtraj[-1], jcached, cond)
    kw = dict(num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
              cached_source=_port_cached(jcached))
    got = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(cond), t(s["uncond"]), **kw)
    np.testing.assert_allclose(np32(got), np32(want), atol=EDIT_TOL)
    # each prompt's embedding repeated over the frames: the plain edit
    repeated = t(s["cond"])[:, None].repeat(1, SHAPE[1], 1, 1)
    multi = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), repeated, t(s["uncond"]), **kw)
    plain = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]),
                        t(s["uncond"]), **kw)
    assert torch.equal(multi, plain)
    with pytest.raises(ValueError, match="video_length"):
        edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), repeated[:, :1],
                    t(s["uncond"]), **kw)


def test_multi_cli_repeat_matches_jax():
    """The CLI's ``multi``: the prompts' embeddings repeated over the frames
    as JAX's ``jnp.repeat(cond_all[:, None], video_len, axis=1)``."""
    emb = np.random.default_rng(1).normal(size=(2, 77, 16)).astype(np.float32)
    want = np.asarray(jnp.repeat(jnp.asarray(emb)[:, None], 3, axis=1))
    got = t(emb)[:, None].repeat(1, 3, 1, 1)
    np.testing.assert_array_equal(np32(got), want)
