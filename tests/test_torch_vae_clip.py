"""The port's VAE and CLIP text encoder against the JAX package's, on the CPU
in float32, with weights carried by the port's ``models/convert.py``.

Tolerance 1e-4 absolute and relative: identical float32 math whose
reductions (convolutions, GroupNorm statistics, LayerNorm, softmax) sum in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, perturb, t

ATOL = RTOL = 1e-4


def _vae_pair(seed=0):
    from videop2p_tpu.models import AutoencoderKL as JaxVAE
    from videop2p_tpu.models import VAEConfig as JaxCfg
    from videop2p_tpu.models.convert import vae_params_from_torch

    from videop2p_tpu_torch.models.convert import init_weights, vae_state_dict_from_jax
    from videop2p_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    jvae = JaxVAE(JaxCfg.tiny())
    pvae = init_weights(AutoencoderKL(VAEConfig.tiny()), seed).eval()
    abstract = jax.eval_shape(jvae.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                              jax.random.key(1))["params"]
    sd = {k: v.numpy() for k, v in pvae.state_dict().items()}
    params = perturb(vae_params_from_torch(sd, abstract), seed + 1)
    pvae.load_state_dict(vae_state_dict_from_jax({"params": params}), strict=True)
    return jvae, {"params": params}, pvae


def test_vae_encode_matches_jax():
    from videop2p_tpu.models import encode_video as jax_encode

    from videop2p_tpu_torch.models.vae import encode_video

    jvae, variables, pvae = _vae_pair(0)
    video = np.random.default_rng(0).uniform(-1, 1, (1, 3, 16, 16, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: jax_encode(jvae, p, x, jax.random.key(0),
                                               sample=False))(variables, video)
    with torch.no_grad():
        got = encode_video(pvae, t(video))
    assert got.shape == (1, 3, 8, 8, 4)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


def test_vae_decode_matches_jax():
    """5 frames: one chunk of 4 and a ragged chunk of 1."""
    from videop2p_tpu.models import decode_video as jax_decode

    from videop2p_tpu_torch.models.vae import decode_video

    jvae, variables, pvae = _vae_pair(1)
    lat = np.random.default_rng(1).normal(size=(1, 5, 8, 8, 4)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, z: jax_decode(jvae, p, z))(variables, lat)
    with torch.no_grad():
        got = decode_video(pvae, t(lat))
    assert got.shape == (1, 5, 16, 16, 3)
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("seq", [8, 77])
def test_clip_matches_jax(seq):
    from videop2p_tpu.models import CLIPTextConfig as JaxCfg
    from videop2p_tpu.models import CLIPTextEncoder as JaxCLIP
    from videop2p_tpu.models.convert import clip_params_from_torch

    from videop2p_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
    from videop2p_tpu_torch.models.convert import clip_state_dict_from_jax, init_weights

    jclip = JaxCLIP(JaxCfg.tiny())
    pclip = init_weights(CLIPTextEncoder(CLIPTextConfig.tiny()), 2).eval()
    abstract = jax.eval_shape(jclip.init, jax.random.key(0),
                              jnp.zeros((1, 8), jnp.int32))["params"]
    sd = {k: v.numpy() for k, v in pclip.state_dict().items()}
    params = perturb(clip_params_from_torch(sd, abstract), 3)
    pclip.load_state_dict(clip_state_dict_from_jax({"params": params}), strict=True)
    # ids past the tiny vocabulary wrap, as real tokenizer ids do there
    ids = np.random.default_rng(seq).integers(0, 49408, (2, seq)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jclip.apply)({"params": params}, ids)
    with torch.no_grad():
        got = pclip(torch.as_tensor(ids))
    np.testing.assert_allclose(np32(got), np32(want), atol=ATOL, rtol=RTOL)


def test_state_dict_from_jax_covers_every_model():
    from videop2p_tpu_torch.models.convert import state_dict_from_jax

    _, variables, pvae = _vae_pair(2)
    out = state_dict_from_jax(vae_params=variables)
    assert out["unet"] is None and out["text_encoder"] is None
    assert sorted(out["vae"]) == sorted(pvae.state_dict())
