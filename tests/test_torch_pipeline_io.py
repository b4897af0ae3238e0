"""Checkpoint I/O of the port (``models/convert.py`` readers and writers,
``models/pipeline_io.py``, ``utils/tokenizers.py:load_tokenizer``) against
the JAX package's and the ``safetensors`` / ``transformers`` packages, on the
CPU at tiny size.

Exact: the safetensors bytes both ways, every weight through a save and a
load in either package, the inflation report, the SD-1.5 key manifest and
the timesteps. The UNet forward of a loaded checkpoint against JAX's
within 1e-5 (float32, summation order only); the port's CLIP text encoder
on transformers' weights against transformers' ``CLIPTextModel`` within
1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import jit_apply, np32, tiny_unet_pair

SCHED = {"_class_name": "DDIMScheduler", "num_train_timesteps": 1000,
         "beta_start": 0.00085, "beta_end": 0.012, "beta_schedule": "scaled_linear",
         "clip_sample": False, "set_alpha_to_one": False, "steps_offset": 1}


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, pmodel = tiny_unet_pair(seed=9, frames=2)
    return jmodel, variables, pmodel


def _rand(dtype, shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["F32", "F16"])
def test_safetensors_match_the_package_both_ways(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    from videop2p_tpu_torch.models.convert import read_safetensors, save_safetensors

    tensors = {"a.weight": _rand(dtype, (3, 5), 0), "b": _rand(dtype, (7,), 1),
               "c.bias": _rand(dtype, (2, 1, 4), 2), "scalar": _rand(dtype, (), 3)}
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_safetensors(tensors, ours)
    save_file(tensors, theirs)
    for got in (load_file(ours), read_safetensors(theirs), read_safetensors(ours)):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == dtype and got[k].shape == v.shape
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_safetensors_bf16_and_mixed_dtypes_round_trip(tmp_path):
    """BF16 through ``torch.frombuffer(...).view(torch.bfloat16)``; mixed
    item sizes keep every tensor aligned; the package reads it too."""
    from safetensors.torch import load_file

    from videop2p_tpu_torch.models.convert import read_safetensors, save_safetensors

    tensors = {"h": _rand(torch.bfloat16, (3, 3), 4), "f": _rand(torch.float32, (5,), 5),
               "g": _rand(torch.float16, (1,), 6), "ids": torch.arange(77)[None]}
    path = str(tmp_path / "m.safetensors")
    nbytes = save_safetensors(tensors, path)
    assert nbytes == os.path.getsize(path)
    for got in (read_safetensors(path), load_file(path)):
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_jax_checkpoint_loads_in_the_port(tmp_path, pair):
    """A tiny pipeline written by JAX's ``save_pipeline`` loads key for key,
    exactly, its UNet's output within 1e-5 of JAX's, its scheduler config
    read back."""
    from videop2p_tpu.models import UNet3DConfig
    from videop2p_tpu.models.pipeline_io import save_pipeline as jax_save

    from videop2p_tpu_torch.models.pipeline_io import load_pipeline

    jmodel, variables, pmodel = pair
    jax_save(str(tmp_path), UNet3DConfig.tiny(), variables, scheduler_config=SCHED)
    loaded = load_pipeline(str(tmp_path), device="cpu")
    assert loaded.vae is None and loaded.text_encoder is None
    assert loaded.tokenizer_dir is None and loaded.scheduler_config == SCHED
    assert loaded.inflation_report == {"kept_init": [], "unused": []}
    got, want = loaded.unet.state_dict(), pmodel.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    text = rng.normal(size=(1, 77, 16)).astype(np.float32)
    ref = jit_apply(jmodel, variables, x, jnp.asarray(10), text)
    with torch.no_grad():
        out = loaded.unet(torch.tensor(x), 10, torch.tensor(text))
    np.testing.assert_allclose(np32(out), np.asarray(ref), rtol=0, atol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path, pair):
    """The port's ``save_pipeline`` writes what JAX's ``load_pipeline``
    reads into the same parameters, scheduler config and layout."""
    from flax import traverse_util
    from videop2p_tpu.models.pipeline_io import load_pipeline as jax_load

    from videop2p_tpu_torch.models.pipeline_io import save_pipeline

    _, variables, pmodel = pair
    save_pipeline(str(tmp_path), pmodel.config, pmodel.state_dict(), scheduler_config=SCHED)
    assert json.loads((tmp_path / "model_index.json").read_text())["_class_name"] == \
        "TuneAVideoPipeline"
    loaded = jax_load(str(tmp_path), dtype=jnp.float32)
    assert loaded.scheduler_config == SCHED
    assert loaded.inflation_report == {"kept_init": [], "unused": []}
    got = traverse_util.flatten_dict(loaded.unet_params["params"])
    want = traverse_util.flatten_dict(variables["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=str(k))


def test_2d_checkpoint_inflates_as_jax_reports(tmp_path, pair):
    """A 2-D checkpoint (no ``_temp.`` keys): the same temporal parameters
    keep their init as in JAX's report, with the temporal output projection
    at zero; an unknown or a missing non-temporal key raises."""
    from flax import traverse_util
    from videop2p_tpu.models.convert import _flax_path_to_torch, unet3d_params_from_torch

    from videop2p_tpu_torch.models import convert
    from videop2p_tpu_torch.models.pipeline_io import load_pipeline, save_pipeline

    _, variables, pmodel = pair
    sd2d = {k: v for k, v in pmodel.state_dict().items() if "_temp." not in k}
    _, jreport = unet3d_params_from_torch({k: v.numpy() for k, v in sd2d.items()},
                                          variables["params"])
    want = sorted(_flax_path_to_torch(tuple(p.split("/")))[0] for p in jreport["kept_init"])
    save_pipeline(str(tmp_path), pmodel.config, sd2d)
    loaded = load_pipeline(str(tmp_path), device="cpu", seed=3)
    assert sorted(loaded.inflation_report["kept_init"]) == want
    assert len(want) == len(traverse_util.flatten_dict(variables["params"])) - len(sd2d)
    params = dict(loaded.unet.named_parameters())
    for k in want:
        if "attn_temp.to_out" in k:
            assert params[k].abs().max() == 0, k
    for k, v in sd2d.items():
        torch.testing.assert_close(params[k].detach(), v, rtol=0, atol=0)
    with pytest.raises(KeyError, match="the model lacks"):
        convert.load_weights(loaded.unet, {**sd2d, "conv_in.extra": torch.zeros(1)},
                             keep_init=convert.is_temporal_key)
    missing = {k: v for k, v in sd2d.items() if k != "conv_in.weight"}
    with pytest.raises(KeyError, match="missing from the checkpoint"):
        convert.load_weights(loaded.unet, missing, keep_init=convert.is_temporal_key)


def test_sd15_unet_keys_are_the_diffusers_manifest():
    """The SD-1.5 UNet built on the meta device has exactly the 686
    diffusers 2-D keys of the JAX package's manifest, at their shapes, plus
    the 112 temporal ones."""
    from flax import traverse_util
    from videop2p_tpu.models import UNet3DConditionModel as JaxUNet
    from videop2p_tpu.models import UNet3DConfig as JaxConfig

    from tests.test_convert import _torch_manifest_entry
    from videop2p_tpu_torch.models import UNet3DConditionModel, UNet3DConfig

    abstract = jax.eval_shape(
        JaxUNet(config=JaxConfig.sd15()).init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 2, 64, 64, 4), jnp.bfloat16),
        jax.ShapeDtypeStruct((), jnp.int32),
        jax.ShapeDtypeStruct((1, 77, 768), jnp.bfloat16))["params"]
    manifest, temporal = {}, {}
    for path, leaf in traverse_util.flatten_dict(abstract).items():
        key, shape = _torch_manifest_entry(path, tuple(leaf.shape))
        pstr = "/".join(path)
        (temporal if "attn_temp" in pstr or "norm_temp" in pstr else manifest)[key] = shape
    with torch.device("meta"):
        model = UNet3DConditionModel(UNet3DConfig.sd15())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert len(manifest) == 686 and len(temporal) == 112
    assert {k: v for k, v in shapes.items() if "_temp." not in k} == manifest
    assert {k: v for k, v in shapes.items() if "_temp." in k} == temporal


def _write_component(root, sub, config, sd, weights="diffusion_pytorch_model.safetensors"):
    from videop2p_tpu_torch.models.convert import save_safetensors

    os.makedirs(root / sub, exist_ok=True)
    (root / sub / "config.json").write_text(json.dumps(config))
    save_safetensors(sd, str(root / sub / weights))


@pytest.mark.parametrize("naming", ["to_q", "query"])
def test_vae_loads_both_attention_namings(tmp_path, pair, naming):
    from videop2p_tpu_torch.models import AutoencoderKL, VAEConfig
    from videop2p_tpu_torch.models.convert import init_weights
    from videop2p_tpu_torch.models.pipeline_io import load_pipeline, save_pipeline

    _, _, pmodel = pair
    vae = init_weights(AutoencoderKL(VAEConfig.tiny()), 5)
    sd = vae.state_dict()
    if naming == "query":
        old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        sd = {next((k.replace(f".{n}.", f".{o}.") for n, o in old.items()
                    if f".attentions.0.{n}." in k), k): v for k, v in sd.items()}
        assert any(".proj_attn." in k for k in sd)
    save_pipeline(str(tmp_path), pmodel.config, pmodel.state_dict())
    _write_component(tmp_path, "vae", {"block_out_channels": [8, 16], "layers_per_block": 1,
                                       "norm_num_groups": 4}, sd)
    loaded = load_pipeline(str(tmp_path), device="cpu")
    got = loaded.vae.state_dict()
    for k, v in vae.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_clip_loads_transformers_names_and_matches_transformers(tmp_path, pair):
    """A transformers ``CLIPTextModel``'s own state dict (``text_model.``
    prefix, the position-ids buffer) loads into the port's encoder, whose
    output then matches transformers' within 1e-5."""
    transformers = pytest.importorskip("transformers")

    from videop2p_tpu_torch.models.convert import clip_state_dict_to_transformers
    from videop2p_tpu_torch.models.pipeline_io import load_pipeline, save_pipeline

    _, _, pmodel = pair
    cfg = dict(vocab_size=128, hidden_size=16, intermediate_size=32, num_hidden_layers=2,
               num_attention_heads=2, max_position_embeddings=77, hidden_act="quick_gelu")
    torch.manual_seed(0)
    ref = transformers.CLIPTextModel(transformers.CLIPTextConfig(**cfg)).eval()
    sd = dict(ref.state_dict())
    sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    save_pipeline(str(tmp_path), pmodel.config, pmodel.state_dict())
    _write_component(tmp_path, "text_encoder", cfg, sd, weights="model.safetensors")
    te = load_pipeline(str(tmp_path), device="cpu").text_encoder
    assert sorted(clip_state_dict_to_transformers(te.state_dict())) == sorted(ref.state_dict())
    ids = torch.randint(0, 126, (2, 77), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref(input_ids=ids).last_hidden_state
        got = te(ids)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_scheduler_config_gives_jax_timesteps(tmp_path, pair):
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.cli.run_videop2p import build_models
    from videop2p_tpu_torch.models.pipeline_io import save_pipeline

    _, _, pmodel = pair
    save_pipeline(str(tmp_path), pmodel.config, pmodel.state_dict(), scheduler_config=SCHED)
    with pytest.warns(UserWarning, match="backfilling"):
        bundle = build_models(str(tmp_path), device="cpu")
    assert bundle.scheduler_config == SCHED
    sched, jsched = bundle.make_scheduler(), JaxDDIM.from_config(SCHED)
    for n in (50, 4):
        np.testing.assert_array_equal(np.asarray(sched.timesteps(n)),
                                      np.asarray(jsched.timesteps(n)))
    assert sched.timesteps(50)[-1] == 1  # steps_offset 1
    np.testing.assert_array_equal(sched.alphas_cumprod, np.asarray(jsched.alphas_cumprod))


def test_load_tokenizer_falls_back_to_the_word_tokenizer(tmp_path):
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer, load_tokenizer

    assert isinstance(load_tokenizer(None), WordTokenizer)
    assert isinstance(load_tokenizer(str(tmp_path)), WordTokenizer)
    (tmp_path / "tokenizer").mkdir()
    with pytest.warns(UserWarning, match="failed to load CLIP tokenizer"):
        assert isinstance(load_tokenizer(str(tmp_path)), WordTokenizer)


def _tiny_clip_tokenizer_dir(root):
    """A character-level CLIP BPE vocabulary (no merges), enough for
    ``CLIPTokenizer`` to load from a local directory."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {c: i for i, c in enumerate(letters)}
    vocab.update({c + "</w>": 26 + i for i, c in enumerate(letters)})
    vocab.update({"<|startoftext|>": 52, "<|endoftext|>": 53})
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.json"), "w") as fh:
        json.dump(vocab, fh)
    with open(os.path.join(root, "merges.txt"), "w") as fh:
        fh.write("#version: 0.2\n")
    with open(os.path.join(root, "tokenizer_config.json"), "w") as fh:
        json.dump({"model_max_length": 77}, fh)


def test_clip_tokenizer_matches_jax(tmp_path):
    """A checkpoint's ``tokenizer/`` loads as the CLIP tokenizer, which
    encodes, pads and decodes as the JAX package's does."""
    pytest.importorskip("transformers")
    from videop2p_tpu.utils.tokenizers import load_tokenizer as jax_load

    from videop2p_tpu_torch.utils.tokenizers import CLIPTokenizerWrapper, load_tokenizer

    _tiny_clip_tokenizer_dir(str(tmp_path / "tokenizer"))
    ours, theirs = load_tokenizer(str(tmp_path)), jax_load(str(tmp_path))
    assert isinstance(ours, CLIPTokenizerWrapper)
    for text in ("a rabbit is jumping", "an origami rabbit " * 30):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.encode_padded(text) == theirs.encode_padded(text)
        assert len(ours.encode_padded(text)) == 77
    assert [ours.decode_token(i) for i in range(54)] == [theirs.decode_token(i)
                                                         for i in range(54)]
    assert (ours.bos_token_id, ours.eos_token_id) == (theirs.bos_token_id, theirs.eos_token_id)
