"""Parity of the port's UNet modules with the JAX package's, on the CPU in
float32 with identical weights (carried by the port's models/convert.py).

Tolerance: 1e-4 absolute and relative. Both sides compute the same float32
math; they differ only in summation order (XLA's vs ATen's reductions and
convolution algorithms), which stays well under 1e-5 at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import carry_params, jit_apply, np32, t, tiny_unet_pair

ATOL = RTOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("cin,cout", [(8, 8), (8, 16)])
def test_resnet_block_matches_jax(cin, cout):
    from videop2p_tpu.models.layers import ResnetBlock3D as JaxResnet

    from videop2p_tpu_torch.models.layers import ResnetBlock3D

    rng = _rng(0)
    x = rng.normal(size=(2, 3, 8, 8, cin)).astype(np.float32) * 2 + 0.3
    temb = rng.normal(size=(2, 32)).astype(np.float32)
    jmod = JaxResnet(cout, groups=4)
    port = ResnetBlock3D(cin, cout, 32, groups=4)
    variables = carry_params(port, jmod, (jnp.asarray(x), jnp.asarray(temb)), seed=1)
    want = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        got = port(t(x), t(temb))
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


def test_transformer3d_matches_jax():
    from videop2p_tpu.models.attention import Transformer3DModel as JaxT3D

    from videop2p_tpu_torch.models.attention import Transformer3DModel

    rng = _rng(1)
    x = rng.normal(size=(2, 3, 4, 4, 8)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 16)).astype(np.float32)
    jmod = JaxT3D(heads=2, dim_head=4, norm_groups=4)
    port = Transformer3DModel(8, heads=2, dim_head=4, context_dim=16, norm_groups=4)
    variables = carry_params(port, jmod, (jnp.asarray(x), jnp.asarray(ctx)), seed=2,
                             prefix="attentions_0")
    want = jit_apply(jmod, variables, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(t(x), t(ctx))
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


def test_timestep_embedding_matches_jax():
    from videop2p_tpu.models.layers import get_timestep_embedding as jax_emb

    from videop2p_tpu_torch.models.layers import get_timestep_embedding

    # sin/cos of float32 arguments up to ~1000, where one ulp of the
    # argument is 6e-5: the two libraries' sin/cos differ by about that
    ts = np.array([0, 1, 250, 999])
    for dim in (8, 9, 320):
        want = jax_emb(jnp.asarray(ts), dim)
        got = get_timestep_embedding(torch.as_tensor(ts), dim)
        np.testing.assert_allclose(np32(got), np32(want), atol=1e-4, rtol=1e-5)


def test_unet_uncontrolled_matches_jax():
    jmodel, variables, pmodel = tiny_unet_pair(seed=0, frames=3)
    rng = _rng(3)
    sample = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    text = rng.normal(size=(2, 77, 16)).astype(np.float32)
    want = jit_apply(jmodel, variables, jnp.asarray(sample), jnp.asarray(421),
                     jnp.asarray(text))
    with torch.no_grad():
        got = pmodel(t(sample), 421, t(text))
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


def _controllers(kind):
    """(jax ctx, port ctx) for the same prompts and word tokenizer."""
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    if kind == "refine":
        prompts = ["a rabbit is jumping on the grass",
                   "a origami rabbit is jumping on the grass"]
        kw = dict(is_replace_controller=False, cross_replace_steps=0.8,
                  self_replace_steps=0.5, blend_words=(("rabbit",), ("rabbit",)),
                  equalizer_params={"words": ["origami"], "values": [2]})
    else:
        prompts = ["a car is driving on the road", "a car is driving on the railway"]
        kw = dict(is_replace_controller=True, cross_replace_steps=0.8,
                  self_replace_steps=0.5,
                  equalizer_params={"words": ["railway"], "values": [4]})
    return (jax_make(prompts, JaxTok(), 5, **kw),
            make_controller(prompts, WordTokenizer(), 5, **kw))


@pytest.mark.parametrize("kind", ["refine", "replace"])
def test_unet_controlled_matches_jax(kind):
    """A controlled forward in the fast CFG layout (1 uncond + 2 cond
    streams) at a step inside both edit windows: eps and the stored maps
    that LocalBlend reads agree."""
    from videop2p_tpu.models.attention import AttnControl as JaxControl
    from videop2p_tpu.pipelines.stores import blend_maps_from_store as jax_blend_maps

    from videop2p_tpu_torch.models.attention import AttnControl
    from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

    jmodel, variables, pmodel = tiny_unet_pair(seed=1, frames=2)
    jctx, pctx = _controllers(kind)
    rng = _rng(4)
    sample = rng.normal(size=(3, 2, 8, 8, 4)).astype(np.float32)
    text = rng.normal(size=(3, 77, 16)).astype(np.float32)
    step = 1
    want, store = jit_apply(
        jmodel, variables, jnp.asarray(sample), jnp.asarray(600), jnp.asarray(text),
        JaxControl(ctx=jctx, step_index=jnp.asarray(step), num_uncond=1),
        mutable=["attn_store"])
    pstore = {}
    with torch.no_grad():
        got = pmodel(t(sample), 600, t(text), AttnControl(pctx, step, 1), pstore)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)

    kw = dict(latent_hw=(8, 8), video_length=2, num_prompts=2, text_len=77,
              num_uncond=1)
    want_maps = jax_blend_maps(store["attn_store"], **kw)
    got_maps = blend_maps_from_store(pstore, **kw)
    np.testing.assert_allclose(np32(got_maps), np32(want_maps), atol=1e-5)
    # the control really edits: an uncontrolled forward differs
    with torch.no_grad():
        plain = pmodel(t(sample), 600, t(text))
    assert np.abs(np32(plain) - np32(got)).max() > 1e-3


def test_weights_carry_like_the_jax_converter():
    """The port's UNet state dict equals the JAX package's own exporter
    (``unet3d_params_to_torch``) key by key and loads with strict=True."""
    from videop2p_tpu.models.convert import unet3d_params_to_torch

    from videop2p_tpu_torch.models.convert import state_dict_from_jax

    _, variables, pmodel = tiny_unet_pair(seed=2)
    want = unet3d_params_to_torch(variables["params"])
    got = state_dict_from_jax(unet_params=variables)["unet"]
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == tuple(value.shape), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)
    assert sorted(pmodel.state_dict()) == sorted(want)


def test_edit_sample_cfg_layouts_match_jax():
    """The denoise loop without a controller in the fast CFG layout (P − 1
    uncond streams; the source replays its cond-only prediction)."""
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import edit_sample as jax_edit
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn

    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import edit_sample, make_unet_fn

    jmodel, variables, pmodel = tiny_unet_pair(seed=3, frames=2)
    rng = _rng(5)
    x_t = rng.normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    cond = rng.normal(size=(2, 77, 16)).astype(np.float32)
    uncond = rng.normal(size=(77, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x, c, u: jax_edit(
            jax_unet_fn(jmodel), p, JaxDDIM.create_sd(), x, c, u,
            num_inference_steps=2, source_uses_cfg=False))(
                variables, x_t, cond, uncond)
    got = edit_sample(make_unet_fn(pmodel), DDIMScheduler.create_sd(), t(x_t),
                      t(cond), t(uncond), num_inference_steps=2,
                      source_uses_cfg=False)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)
