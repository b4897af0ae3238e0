"""The serving slice end to end against the JAX package: the same request
through the JAX ``EditEngine`` and the port's, on identical tiny weights
(``tiny=True, width=16, video_len=2, steps=2``), and the port's
``ProgramSet`` programs against JAX's (encode, capture-inversion,
edit + decode).

Tolerances (float32 on both sides): the encoded latents 1e-5; the
trajectory 1e-4 and the captured maps within one bf16 ulp, as
``tests/test_torch_cached.py``; the edit + decode on ONE shared capture
(JAX's, carried into the port) 2e-4 on the videos, as that file's and
``tests/test_torch_slice.py``'s edits. End to end, each engine edits from
its own capture, whose bf16 maps may differ by one rounding: 1e-2 on the
[0, 1] videos, ``tests/test_torch_cached.py``'s end-to-end tolerance
(1.8e-3 measured). Both engines must report ``done`` and ``src_err == 0.0``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cached import _assert_maps_close, _flat_jax, _port_cached
from tests.test_torch_parity import carry_params, np32

KW = dict(tiny=True, width=16, video_len=2, steps=2)
REQUEST = dict(image_path="data/rabbit", prompt="a rabbit is jumping",
               prompts=["a rabbit is jumping", "a origami rabbit is jumping"],
               blend_word=["rabbit", "rabbit"], eq_params={"words": ["origami"], "values": [2]},
               # wide enough that 2 steps keep the cross edit active
               cross_replace_steps=0.8, save_name="origami")
CONTROLLER = {k: REQUEST[k] for k in ("blend_word", "eq_params", "cross_replace_steps")}
E2E_TOL = 1e-2
SHARED_CAPTURE_TOL = 2e-4


def _seeded_tree(abstract, seed: int):
    """A flax parameter tree of ``abstract``'s shapes with seeded values:
    scales near 1, small biases, embeddings at 0.02, kernels at
    1/sqrt(fan-in) (no flax ``init`` compile)."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = node.shape
        if name == "scale":
            a = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name == "bias":
            a = rng.normal(0.0, 0.05, shape)
        elif name in ("embedding", "position_embedding"):
            a = rng.normal(0.0, 0.02, shape)
        else:
            a = rng.normal(0.0, 1.0 / np.sqrt(max(int(np.prod(shape[:-1])), 1)), shape)
        return jnp.asarray(a, jnp.float32)

    return walk(abstract, "")


def paired_bundles(seed: int = 3):
    """(JAX ModelBundle, port ModelBundle) of the tiny models with the same
    weights: the UNet carried from the port's seeded init into flax and
    back (``tests/test_torch_parity.py:carry_params``), the VAE and text
    encoder seeded in flax and carried into the port
    (``models/convert.py:state_dict_from_jax``)."""
    from videop2p_tpu.cli.common import ModelBundle as JaxBundle
    from videop2p_tpu.models import (
        AutoencoderKL,
        CLIPTextConfig,
        CLIPTextEncoder,
        UNet3DConditionModel,
        UNet3DConfig,
        VAEConfig,
    )
    from videop2p_tpu.utils.tokenizers import load_tokenizer

    from videop2p_tpu_torch.cli.common import ModelBundle
    from videop2p_tpu_torch.models import AutoencoderKL as PortVAE
    from videop2p_tpu_torch.models import CLIPTextConfig as PortCLIPConfig
    from videop2p_tpu_torch.models import CLIPTextEncoder as PortCLIP
    from videop2p_tpu_torch.models import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models import UNet3DConfig as PortUNetConfig
    from videop2p_tpu_torch.models import VAEConfig as PortVAEConfig
    from videop2p_tpu_torch.models.convert import state_dict_from_jax

    key = jax.random.key(0)
    ccfg = CLIPTextConfig.tiny()
    ucfg = UNet3DConfig.tiny()
    ucfg = type(ucfg)(**{**ucfg.__dict__, "cross_attention_dim": ccfg.hidden_size})
    unet, vae, text = (UNet3DConditionModel(config=ucfg), AutoencoderKL(config=VAEConfig.tiny()),
                       CLIPTextEncoder(config=ccfg))
    port_unet = PortUNet(PortUNetConfig.tiny(cross_attention_dim=ccfg.hidden_size))
    unet_vars = carry_params(port_unet, unet, (jnp.zeros((1, 2, 8, 8, 4)), jnp.asarray(0),
                                               jnp.zeros((1, 77, ccfg.hidden_size))), seed=seed)
    vae_vars = {"params": _seeded_tree(jax.eval_shape(
        vae.init, key, jnp.zeros((1, 64, 64, 3)), key)["params"], seed + 1)}
    text_vars = {"params": _seeded_tree(jax.eval_shape(
        text.init, key, jnp.zeros((1, 8), jnp.int32))["params"], seed + 2)}
    jax_bundle = JaxBundle(unet=unet, unet_params=unet_vars, vae=vae, vae_params=vae_vars,
                           text_encoder=text, text_params=text_vars,
                           tokenizer=load_tokenizer(None), random_init=True, source_dir=None)
    sds = state_dict_from_jax(None, vae_vars, text_vars)
    port_vae, port_text = PortVAE(PortVAEConfig.tiny()), PortCLIP(PortCLIPConfig.tiny())
    port_vae.load_state_dict(sds["vae"], strict=True)
    port_text.load_state_dict(sds["text_encoder"], strict=True)
    port_bundle = ModelBundle(unet=port_unet, vae=port_vae.eval(),
                              text_encoder=port_text.eval())
    return jax_bundle, port_bundle


def paired_engines(root, *, jax_warm=None, port_warm=None):
    """The JAX engine and the port's (CPU) over the same weights, each with
    ``keep_videos``; ``*_warm`` are ``EditEngine.warm`` keyword sets (None:
    no warm-up)."""
    from videop2p_tpu.serve import EditEngine as JaxEngine
    from videop2p_tpu.serve import ProgramSet as JaxProgramSet
    from videop2p_tpu.serve import ProgramSpec as JaxSpec

    from videop2p_tpu_torch.serve import EditEngine, ProgramSet, ProgramSpec

    jax_bundle, port_bundle = paired_bundles()
    jps = JaxProgramSet(JaxSpec(**KW), bundle=jax_bundle)
    jeng = JaxEngine(JaxSpec(**KW), out_dir=str(root / "jax"), programs=jps, keep_videos=True)
    peng = EditEngine(ProgramSpec(**KW), out_dir=str(root / "port"), keep_videos=True,
                      programs=ProgramSet(ProgramSpec(**KW), bundle=port_bundle, device="cpu"))
    for eng, warm in ((jeng, jax_warm), (peng, port_warm)):
        if warm is not None:
            eng.warm(tuple(REQUEST["prompts"]), controller_kwargs=CONTROLLER, **warm)
    return jeng, peng


def serve_both(jeng, peng, **overrides):
    """One request through both engines: (JAX record, port record, JAX
    videos, port videos)."""
    from videop2p_tpu.serve import EditRequest as JaxRequest

    from videop2p_tpu_torch.serve import EditRequest

    body = {**REQUEST, **overrides}
    jrec = jeng.result(jeng.submit(JaxRequest(**body)), wait_s=300.0)
    prec = peng.result(peng.submit(EditRequest(**body)), wait_s=300.0)
    return jrec, prec, np.asarray(jeng.videos(jrec["id"])), peng.videos(prec["id"])


def assert_served_alike(jrec, prec, jvid, pvid):
    for rec in (jrec, prec):
        assert rec["status"] == "done", rec.get("error")
        assert rec["src_err"] == 0.0
    assert pvid.shape == jvid.shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(pvid, jvid, atol=E2E_TOL, rtol=0)
    # the edit stream moved away from the reconstruction
    assert np.abs(pvid[1] - pvid[0]).max() > 0.1


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    jeng, peng = paired_engines(tmp_path_factory.mktemp("serve_jax"))
    yield jeng, peng
    jeng.close()
    peng.close()


def test_engine_request_matches_jax(engines):
    jeng, peng = engines
    jrec, prec, jvid, pvid = serve_both(jeng, peng)
    assert_served_alike(jrec, prec, jvid, pvid)
    assert prec["store_hit"] is False and prec["steps"] == 2
    assert os.path.isfile(prec["edit_gif"]) and os.path.isfile(prec["inversion_gif"])


def _programs(engines):
    jeng, peng = engines
    frames = np.random.default_rng(5).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    return jeng.programs, peng.programs, frames


def test_programset_encode_and_capture_match_jax(engines):
    """``encode`` (the posterior mean) and ``invert_capture`` (the
    trajectory and every captured map) of both sets on the same frames."""
    jps, pps, frames = _programs(engines)
    jlat = jps.encode(jps.frames_to_video(frames), jax.random.key(0))
    plat = pps.encode(pps.frames_to_video(frames))
    np.testing.assert_allclose(np32(plat), np.asarray(jlat), atol=1e-5, rtol=0)
    jctx = jps.controller(REQUEST["prompts"], **CONTROLLER)
    pctx = pps.controller(REQUEST["prompts"], **CONTROLLER)
    jtraj, jcached = jps.invert_capture(jlat, jps.encode_prompts(REQUEST["prompts"][:1]), jctx,
                                        jax.random.key(0))[:2]
    ptraj, pcached = pps.invert_capture(torch.from_numpy(np.array(jlat)),
                                        pps.encode_prompts(REQUEST["prompts"][:1]), pctx)
    np.testing.assert_allclose(np32(ptraj), np.asarray(jtraj), atol=1e-4, rtol=0)
    assert (pcached.cross_len, tuple(pcached.self_window)) == (
        jcached.cross_len, tuple(jcached.self_window))
    np.testing.assert_allclose(np32(pcached.src_latents), np.asarray(jcached.src_latents),
                               atol=1e-4, rtol=0)
    _assert_maps_close(pcached.cross_maps, _flat_jax(jcached.cross_maps))
    _assert_maps_close(pcached.temporal_maps, _flat_jax(jcached.temporal_maps))
    np.testing.assert_allclose(np32(pcached.blend_seq), np.asarray(jcached.blend_seq),
                               atol=1e-5, rtol=0)


def test_programset_edit_decode_matches_jax_on_one_capture(engines):
    """``edit_decode`` of both sets on JAX's capture of one clip: the
    videos within 2e-4 and both src_err exactly 0.0."""
    jps, pps, frames = _programs(engines)
    jlat = jps.encode(jps.frames_to_video(frames), jax.random.key(0))
    jctx = jps.controller(REQUEST["prompts"], **CONTROLLER)
    _, jcached = jps.invert_capture(jlat, jps.encode_prompts(REQUEST["prompts"][:1]), jctx,
                                    jax.random.key(0))[:2]
    jvid, jerr = jps.edit_decode(jcached, jps.encode_prompts(REQUEST["prompts"]),
                                 jps.encode_prompts([""])[0], jctx, jlat)
    pctx = pps.controller(REQUEST["prompts"], **CONTROLLER)
    pvid, perr = pps.edit_decode(_port_cached(jcached), pps.encode_prompts(REQUEST["prompts"]),
                                 pps.encode_prompts([""])[0], pctx,
                                 torch.from_numpy(np.array(jlat)))
    assert float(jerr) == 0.0 and float(perr) == 0.0
    np.testing.assert_allclose(np32(pvid), np.asarray(jvid), atol=SHARED_CAPTURE_TOL, rtol=0)


def test_program_spec_fingerprint_content_addressed(tmp_path):
    """The fingerprint is a function of the fields (the tiny width rule
    resolved first), changes with each field, follows a checkpoint's
    content, and differs from the JAX package's for the same spec."""
    from videop2p_tpu.serve import ProgramSpec as JaxSpec

    from videop2p_tpu_torch.serve import ProgramSpec

    base = ProgramSpec(**KW)
    assert base.fingerprint() == ProgramSpec(**KW).fingerprint()
    assert ProgramSpec(**{**KW, "width": 512}).fingerprint() == base.fingerprint()
    assert base.fingerprint() != JaxSpec(**KW).fingerprint()
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "weights.bin").write_bytes(b"one")
    changes = dict(width=32, video_len=4, steps=4, guidance_scale=5.0, tiny=False,
                   mixed_precision="bf16", seed=1, mesh="1,2,1", ring_variant="bidir",
                   tp_collectives="psum_scatter", gradient_checkpointing=True,
                   quant_mode="w8", reuse_schedule="uniform:2", checkpoint=str(ckpt),
                   student_ckpt=str(ckpt))
    prints = {base.fingerprint()} | {ProgramSpec(**{**KW, k: v}).fingerprint()
                                     for k, v in changes.items()}
    assert len(prints) == len(changes) + 1
    before = ProgramSpec(**{**KW, "checkpoint": str(ckpt)}).fingerprint()
    (ckpt / "weights.bin").write_bytes(b"two, retuned in place")
    assert ProgramSpec(**{**KW, "checkpoint": str(ckpt)}).fingerprint() != before
