"""The port's cached-source fast edit against the JAX package's, on the CPU in
float32 with identical tiny-UNet weights, frames and prompts (refine
controller with equalizer and LocalBlend).

Tolerances: the trajectory 1e-4; the captured maps within one bf16 ulp
(rtol 2^-7: both sides round float32 probabilities that differ by ~1e-7 to
bf16, so a value next to a rounding boundary may land one ulp apart); the
blend maps 1e-5; stream 0 of the edit and the storage decisions exactly.
The edit on one shared capture 2e-4 (float32 on both sides through 4
controlled steps; guidance 7.5 amplifies the UNet's summation-order
differences, ~1e-6, about tenfold, as in the live slice test). End to end,
each package edits from its own capture, whose maps differ by those
one-ulp roundings (2^-8 relative): 1e-2, against 2.2e-3 measured.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_control import P2P_CONFIGS, _controller_kwargs, _load
from tests.test_torch_parity import np32, t, tiny_unet_pair

STEPS = 4
SHAPE = (1, 2, 8, 8, 4)  # (B, F, h, w, C)
PROMPTS = ["a rabbit is jumping on the grass",
           "a origami rabbit is jumping on the grass"]
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.5,
            self_replace_steps=0.5, blend_words=(("rabbit",), ("rabbit",)),
            equalizer_params={"words": ["origami"], "values": [2]})
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def setup():
    """Both packages' models, controllers, scheduler and inputs."""
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    jmodel, variables, pmodel = tiny_unet_pair(seed=4, frames=SHAPE[1])
    rng = np.random.default_rng(0)
    return dict(
        jfn=jax_unet_fn(jmodel), params=variables, jsched=JaxDDIM.create_sd(),
        jctx=jax_make(PROMPTS, JaxTok(), STEPS, **CTRL),
        pfn=make_unet_fn(pmodel), pmodel=pmodel, psched=DDIMScheduler.create_sd(),
        pctx=make_controller(PROMPTS, WordTokenizer(), STEPS, **CTRL),
        x0=rng.normal(size=SHAPE).astype(np.float32),
        cond=rng.normal(size=(2, 77, 16)).astype(np.float32),
        uncond=rng.normal(size=(77, 16)).astype(np.float32))


def _windows(s):
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    return capture_windows(s["pctx"], STEPS)


def _jax_capture(s, temporal_maps_dtype=None):
    """JAX's capture, computed once per storage dtype for the module."""
    from videop2p_tpu.pipelines import ddim_inversion_captured as jax_capture

    memo = s.setdefault("jax_captures", {})
    if temporal_maps_dtype not in memo:
        cross_len, self_window = _windows(s)
        with jax.default_matmul_precision("highest"):
            memo[temporal_maps_dtype] = jax.jit(lambda p, x: jax_capture(
                s["jfn"], p, s["jsched"], x, s["cond"][:1], num_inference_steps=STEPS,
                cross_len=cross_len, self_window=self_window, capture_blend=True,
                temporal_maps_dtype=temporal_maps_dtype))(s["params"], s["x0"])
    return memo[temporal_maps_dtype]


def _port_capture(s, temporal_maps_dtype=None):
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured

    cross_len, self_window = _windows(s)
    return ddim_inversion_captured(
        s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]),
        num_inference_steps=STEPS, cross_len=cross_len, self_window=self_window,
        capture_blend=True, temporal_maps_dtype=temporal_maps_dtype)


def _flax_path(keys) -> str:
    """A flax module path as the port's module path:
    ("down_blocks_0", "attentions_0", "blocks_0", "attn2") →
    "down_blocks.0.attentions.0.transformer_blocks.0.attn2"."""
    names = [re.sub(r"^blocks_(\d+)$", r"transformer_blocks.\1", k) for k in keys]
    return ".".join(re.sub(r"_(\d+)$", r".\1", k) for k in names)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path if hasattr(p, "key") and p.key != "probs"]
        out[_flax_path(keys)] = np.asarray(leaf)
    return out


def _assert_maps_close(got, want):
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_allclose(np32(got[path]), np.asarray(leaf, np.float32),
                                   rtol=BF16_ULP, atol=1e-7, err_msg=path)


def test_captured_inversion_matches_jax(setup):
    s = setup
    cross_len, self_window = _windows(s)
    assert 0 < cross_len < STEPS and self_window[1] > self_window[0]
    jtraj, jcached = _jax_capture(s)
    traj, cached = _port_capture(s)
    np.testing.assert_allclose(np32(traj), np32(jtraj), atol=1e-4)
    # the reversed trajectory: stream 0 of the edit reads x_0 at [-1]
    np.testing.assert_array_equal(np32(cached.src_latents[-1]), s["x0"])
    for got, want in ((cached.cross_maps, jcached.cross_maps),
                      (cached.temporal_maps, jcached.temporal_maps)):
        want = _flat_jax(want)
        assert {str(v.dtype) for v in want.values()} == {"bfloat16"}
        assert {v.dtype for v in got.values()} == {torch.bfloat16}
        _assert_maps_close(got, want)
    np.testing.assert_allclose(np32(cached.blend_seq), np32(jcached.blend_seq), atol=1e-5)
    assert (cached.cross_len, tuple(cached.self_window)) == (
        jcached.cross_len, tuple(jcached.self_window))
    # the budget's byte count is what the capture holds
    from videop2p_tpu_torch.pipelines.cached import tree_bytes
    from videop2p_tpu_torch.pipelines.fast import capture_bytes

    assert capture_bytes(s["pmodel"], SHAPE, 77, cross_len=cross_len,
                         self_window=self_window) == tree_bytes(
        cached.cross_maps, cached.temporal_maps)
    # what the edit reads at each step, windows clamped, against JAX
    for i in range(STEPS):
        _assert_maps_close(cached.base_tree_at(i),
                           _flat_jax(jcached.base_tree_at(jnp.asarray(i))))


@pytest.mark.parametrize("storage", ["int8", "float8_e4m3fn"])
def test_temporal_storage_codes_match_jax(setup, storage):
    """The 1-byte temporal-map codes of both captures agree to one code, and
    the decoded maps to one bf16 ulp plus one code."""
    s = setup
    _, jcached = _jax_capture(s, getattr(jnp, storage))
    _, cached = _port_capture(s, getattr(torch, storage))
    want = _flat_jax(jcached.temporal_maps)
    assert sorted(cached.temporal_maps) == sorted(want)
    for path, leaf in want.items():
        got = cached.temporal_maps[path]
        assert str(got.dtype) == f"torch.{storage}" and str(leaf.dtype) == storage
        # probabilities are non-negative, where both codes order like their values
        codes = got.view(torch.uint8).numpy().astype(np.int32)
        jcodes = leaf.view(np.uint8).astype(np.int32)
        assert np.abs(codes - jcodes).max() <= 1, path
    step = 1.0 / 127.0 if storage == "int8" else 0.0625
    lo, hi = cached.self_window
    for i in range(lo, hi):
        got = cached.base_tree_at(i)
        want = _flat_jax(jcached.base_tree_at(jnp.asarray(i)))
        for path in cached.temporal_maps:
            assert got[path].dtype == torch.bfloat16
            w = np.asarray(want[path], np.float32)
            tol = BF16_ULP * np.abs(w) + step * np.maximum(np.abs(w), 1.0 / 127.0)
            assert (np.abs(np32(got[path]) - w) <= tol).all(), path


def _port_cached(jcached):
    """A JAX capture as the port's ``CachedSource``."""
    from videop2p_tpu_torch.pipelines.cached import CachedSource

    def tree(jtree):
        return {path: torch.from_numpy(leaf.astype(np.float32)).to(torch.bfloat16)
                for path, leaf in _flat_jax(jtree).items()}

    return CachedSource(
        src_latents=t(jcached.src_latents), cross_maps=tree(jcached.cross_maps),
        temporal_maps=tree(jcached.temporal_maps), blend_seq=t(jcached.blend_seq),
        cross_len=jcached.cross_len, self_window=tuple(jcached.self_window))


def test_cached_edit_matches_jax_on_one_capture(setup):
    """``edit_sample(cached_source=)`` of both packages on JAX's capture."""
    from videop2p_tpu.pipelines import edit_sample as jax_edit

    from videop2p_tpu_torch.pipelines import edit_sample

    s = setup
    jtraj, jcached = _jax_capture(s)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt, c: jax_edit(
            s["jfn"], p, s["jsched"], xt, s["cond"], s["uncond"],
            num_inference_steps=STEPS, ctx=s["jctx"], source_uses_cfg=False,
            cached_source=c))(s["params"], jtraj[-1], jcached)
    got = edit_sample(s["pfn"], s["psched"], t(jtraj[-1]), t(s["cond"]), t(s["uncond"]),
                      num_inference_steps=STEPS, ctx=s["pctx"], source_uses_cfg=False,
                      cached_source=_port_cached(jcached))
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)
    np.testing.assert_array_equal(np32(got[0]), s["x0"][0])


def test_cached_fast_edit_matches_jax(setup):
    from videop2p_tpu.pipelines.fast import cached_fast_edit as jax_cached_edit

    from videop2p_tpu_torch.pipelines import cached_fast_edit

    s = setup
    cross_len, self_window = _windows(s)
    kw = dict(num_inference_steps=STEPS, guidance_scale=7.5, cross_len=cross_len,
              self_window=self_window)
    with jax.default_matmul_precision("highest"):
        jtraj, want = jax.jit(lambda p, x: jax_cached_edit(
            s["jfn"], p, s["jsched"], x, s["cond"][:1], s["cond"], s["uncond"],
            s["jctx"], **kw))(s["params"], s["x0"])
    traj, got = cached_fast_edit(
        s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]),
        t(s["uncond"]), s["pctx"], **kw)
    np.testing.assert_allclose(np32(traj), np32(jtraj), atol=1e-4)
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-2)
    # stream 0 is x_0 bit for bit on both sides: src_err == 0.0
    assert np.abs(np32(got[0]) - s["x0"][0]).max() == 0.0
    np.testing.assert_array_equal(np32(want[0]), s["x0"][0])
    assert np.abs(np32(got[1]) - np32(got[0])).max() > 1e-3


def test_cached_matches_live_fast_without_controller(setup):
    """Without a controller the edit streams do not depend on the source
    stream: the cached edit (2-stream batch) and the live fast edit
    (3-stream batch) agree stream for stream."""
    from videop2p_tpu_torch.pipelines import cached_fast_edit, edit_sample

    s = setup
    traj, cached_out = cached_fast_edit(
        s["pfn"], s["psched"], t(s["x0"]), t(s["cond"][:1]), t(s["cond"]),
        t(s["uncond"]), None, num_inference_steps=STEPS)
    live = edit_sample(s["pfn"], s["psched"], traj[-1], t(s["cond"]), t(s["uncond"]),
                       num_inference_steps=STEPS, source_uses_cfg=False)
    np.testing.assert_allclose(np32(cached_out[1]), np32(live[1]), atol=1e-5)
    assert np.abs(np32(cached_out[0]) - s["x0"][0]).max() == 0.0


@pytest.mark.parametrize("path", P2P_CONFIGS, ids=lambda p: p.rsplit("/", 1)[-1])
def test_capture_windows_match_jax(path):
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.pipelines.cached import capture_windows as jax_windows
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.pipelines.cached import capture_windows
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    cfg = _load(path)
    kw = _controller_kwargs(cfg)
    for steps in (50, 7):
        want = jax_windows(jax_make(cfg["prompts"], JaxTok(), steps, **kw), steps)
        got = capture_windows(make_controller(cfg["prompts"], WordTokenizer(), steps,
                                              **kw), steps)
        assert (got[0], tuple(got[1])) == (want[0], tuple(want[1]))


def test_choose_cached_maps_matches_jax(setup):
    """The port counts the capture's bytes from the controlled sites; JAX
    takes them from ``eval_shape`` of the capture. At 24 frames, where the
    storage dtype matters, the byte counts agree exactly at every storage
    dtype, and so do the decisions under three budgets."""
    from videop2p_tpu.pipelines.cached import tree_bytes as jax_tree_bytes
    from videop2p_tpu.pipelines.fast import capture_shapes
    from videop2p_tpu.pipelines.fast import choose_cached_maps as jax_choose

    from videop2p_tpu_torch.pipelines.fast import capture_bytes, choose_cached_maps

    s = setup
    cross_len, self_window = _windows(s)
    shape = (1, 24, 8, 8, 4)
    jax_shapes = {
        name: capture_shapes(
            s["jfn"], s["params"], s["jsched"], jnp.zeros(shape), s["cond"][:1],
            s["jctx"], num_inference_steps=STEPS, cross_len=cross_len,
            self_window=self_window,
            temporal_maps_dtype=None if name is None else getattr(jnp, name))[1]
        for name in (None, "float8_e4m3fn", "int8")}

    def jax_shapes_for(dt):
        return jax_shapes[None if dt is None else jnp.dtype(dt).name]

    def bytes_for(dt):
        return capture_bytes(s["pmodel"], shape, 77, cross_len=cross_len,
                             self_window=self_window, temporal_maps_dtype=dt)

    want = {name: jax_tree_bytes((v.cross_maps, v.temporal_maps))
            for name, v in jax_shapes.items()}
    got = {name: bytes_for(None if name is None else getattr(torch, name))
           for name in want}
    assert got == want
    full, f8 = want[None], want["float8_e4m3fn"]
    assert f8 < full
    for budget in (full * 1.01, (f8 + full) / 2, f8 * 0.5):
        jfits, jdt, jgb, _ = jax_choose(jax_shapes_for, budget_gb=budget / 2 ** 30)
        fits, dt, gb = choose_cached_maps(bytes_for, budget_gb=budget / 2 ** 30)
        assert (fits, gb) == (jfits, jgb)
        assert (dt is None and jdt is None) or str(dt) == f"torch.{jnp.dtype(jdt).name}"
