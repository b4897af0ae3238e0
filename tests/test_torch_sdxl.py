"""The port's ``UNet3DConfig.sdxl()`` against the JAX package's, on the CPU in
float32: the preset's fields, and an SDXL-shaped UNet at reduced width (the
overrides of tests/test_unet.py's SDXL test: 3 levels, per-block depths
1/2/3, a first level with no attention) carried across, its forward and one
controlled fast-mode edit step (3 streams, refine with an equalizer, as the
JAX benchmark's SDXL step). Its controlled sites and the weight bridge at
SDXL's depth: tests/test_torch_sdxl_bridge.py.

Tolerances: the forward 1e-4 absolute and relative, as the SD-shaped UNet's
in tests/test_torch_models.py; the edit step 2e-4 (float32, guidance 7.5
amplifying the UNet's summation-order differences, ~1e-6, about tenfold, as
in tests/test_torch_cached.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_parity import carry_params, jit_apply, np32, t

# tests/test_unet.py's SDXL-shaped reduction
SMALL = dict(sample_size=8, block_out_channels=(8, 16, 32), attention_head_dim=(1, 2, 4),
             transformer_depth=(1, 2, 3), cross_attention_dim=16, norm_num_groups=4,
             layers_per_block=1)
PROMPTS = ["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"]


def _pair(seed: int = 0, frames: int = 2, **over):
    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig

    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig

    kw = dict(SMALL, **over)
    jmodel = UNet3DConditionModel(config=UNet3DConfig.sdxl(**kw))
    pmodel = PortUNet(PortConfig.sdxl(**kw))
    variables = carry_params(
        pmodel, jmodel,
        (jnp.zeros((1, frames, 8, 8, 4)), jnp.asarray(0), jnp.zeros((1, 77, 16))), seed=seed)
    return jmodel, variables, pmodel


def test_sdxl_preset_fields_equal_jax():
    from videop2p_tpu.models import UNet3DConfig as JaxConfig

    from videop2p_tpu_torch.models.unet import UNet3DConfig

    got, want = UNet3DConfig.sdxl(), JaxConfig.sdxl()
    shared = [f.name for f in dataclasses.fields(got) if hasattr(want, f.name)]
    assert len(shared) == 16
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name
    assert got.transformer_depth == (1, 2, 10)
    assert got.attention_head_dim == (5, 10, 20)
    assert got.cross_attention_dim == 2048 and got.sample_size == 128
    assert got.down_block_types[0] == "DownBlock3D" and got.up_block_types[-1] == "UpBlock3D"
    assert UNet3DConfig.sdxl(remat_policy="dots_saveable").remat_policy == "dots_saveable"


def test_sdxl_shaped_unet_matches_jax_forward_and_controlled_step():
    from videop2p_tpu.control import make_controller as jax_make
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import edit_sample as jax_edit
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.utils.tokenizers import WordTokenizer as JaxTok

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import edit_sample, make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    jmodel, variables, pmodel = _pair(seed=3)
    sd = pmodel.state_dict()
    # the deep level carries 3 transformer blocks a site
    assert any(k.startswith("down_blocks.2.attentions.0.transformer_blocks.2.") for k in sd)
    assert not any(k.startswith("down_blocks.0.attentions") for k in sd)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 7, 16)).astype(np.float32)
    want = jit_apply(jmodel, variables, jnp.asarray(x), jnp.asarray([11]), jnp.asarray(ctx))
    with torch.no_grad():
        got = pmodel(t(x), torch.tensor([11]), t(ctx))
    np.testing.assert_allclose(np32(got), np32(want), atol=1e-4, rtol=1e-4)

    kw = dict(is_replace_controller=False, cross_replace_steps=1.0, self_replace_steps=1.0,
              equalizer_params={"words": ["origami"], "values": [2.0]})
    cond = rng.normal(size=(2, 77, 16)).astype(np.float32)
    unc = np.zeros((77, 16), np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, xt: jax_edit(
            jax_unet_fn(jmodel), p, JaxDDIM.create_sd(), xt, cond, unc,
            num_inference_steps=1, ctx=jax_make(PROMPTS, JaxTok(), 1, **kw),
            source_uses_cfg=False))(variables, x)
    got = edit_sample(make_unet_fn(pmodel), DDIMScheduler.create_sd(), t(x), t(cond), t(unc),
                      num_inference_steps=1,
                      ctx=make_controller(PROMPTS, WordTokenizer(), 1, **kw),
                      source_uses_cfg=False)
    np.testing.assert_allclose(np32(got), np32(want), atol=2e-4)
