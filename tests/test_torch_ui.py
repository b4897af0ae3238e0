"""The port's demo layer (``videop2p_tpu_torch/ui/``) and the two
``ProgramSet`` programs its inference tab uses: every case of
``tests/test_ui.py`` held against the port (no gradio, no
``huggingface_hub``, no network: the modules import them where they are
used), the trainer's config dicts against the JAX package's for the same
inputs, ``ProgramSet.sample`` / ``decode`` against JAX's on the same tiny
weights (``tests/test_torch_serve_jax.py:paired_bundles``: the UNet carried
by ``tests/test_torch_parity.py``, the VAE and text encoder by
``models/convert.py:state_dict_from_jax``), float32, the same ``x_t`` and
the same embeddings, ``sample_decode`` = ``edit_sample`` + ``decode`` bit
for bit, and ``InferencePipeline`` on a written tiny checkpoint.

Tolerance: the parity harness's 1e-4 relative to the output's scale (the
[0, 1] videos); measured on this CPU: 2.0e-6 (sample) and 7.2e-7 (decode)
absolute on outputs of scale 1.45 and 1.61.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_parity import np32

from videop2p_tpu_torch.ui import ModelUploader, Trainer, Uploader, UploadTarget, find_exp_dirs

TOL = 1e-4
PROMPT = "a rabbit is jumping"


class FakeApi:
    def __init__(self, token=None, fail_create=False):
        self.token = token
        self.fail_create = fail_create
        self.calls = []

    def whoami(self):
        return {"name": "testuser"}

    def delete_repo(self, repo_id, repo_type=None):
        self.calls.append(("delete", repo_id))

    def create_repo(self, repo_id, repo_type=None, private=None):
        if self.fail_create:
            raise RuntimeError("409 Conflict: repo exists")
        self.calls.append(("create", repo_id, private))

    def upload_folder(self, *, repo_id, folder_path, path_in_repo, repo_type):
        self.calls.append(("upload", repo_id, folder_path))


def make_uploader(cls=Uploader, token="tok", **api_kwargs):
    api = FakeApi(**api_kwargs)
    return cls(token, api_factory=lambda t: api), api


# ---- tests/test_ui.py's cases, against the port ----------------------------


def test_upload_personal_profile_defaults_org_to_whoami(tmp_path):
    up, api = make_uploader()
    msg = up.upload(str(tmp_path), "my-model")
    assert "huggingface.co/testuser/my-model" in msg
    assert ("create", "testuser/my-model", True) in api.calls
    assert ("upload", "testuser/my-model", str(tmp_path)) in api.calls


def test_upload_delete_existing_and_errors_surface(tmp_path):
    up, api = make_uploader(fail_create=True)
    msg = up.upload(str(tmp_path), "m", delete_existing_repo=True)
    assert ("delete", "testuser/m") in api.calls
    assert "409" in msg
    with pytest.raises(ValueError):
        up.upload("", "m")
    with pytest.raises(ValueError):
        up.upload(str(tmp_path), "")


def test_model_uploader_routing_and_slugify(tmp_path):
    exp = tmp_path / "My Experiment_2024"
    exp.mkdir()
    up, _ = make_uploader(ModelUploader)
    msg = up.upload_model(str(exp), "", UploadTarget.MODEL_LIBRARY.value)
    assert "Video-P2P-library/my-experiment_2024" in msg
    up2, api2 = make_uploader(ModelUploader)
    up2.upload_model(str(exp), "Name With Spaces", UploadTarget.PERSONAL_PROFILE.value)
    assert ("create", "testuser/name-with-spaces", True) in api2.calls
    with pytest.raises(ValueError, match="unknown upload target"):
        up.upload_model(str(exp), "x", "Nowhere")


def test_trainer_config_schemas(tmp_path):
    t = Trainer(experiments_dir=str(tmp_path / "exp"), checkpoint_dir=str(tmp_path / "ck"))
    cfg = t.build_tune_config(video_path="data/rabbit", training_prompt="a rabbit",
                              validation_prompt="an origami rabbit",
                              base_model=str(tmp_path / "base"),
                              output_dir=str(tmp_path / "out"), n_steps=7)
    assert cfg["max_train_steps"] == 7
    assert cfg["train_data"]["prompt"] == "a rabbit"
    assert cfg["validation_data"]["prompts"] == ["an origami rabbit"]
    assert cfg["trainable_modules"] == ["attn1.to_q", "attn2.to_q", "attn_temp"]
    p2p = t.build_p2p_config(output_dir=str(tmp_path / "out"), video_path="data/rabbit",
                             training_prompt="a rabbit is jumping",
                             editing_prompt="a origami rabbit is jumping",
                             blend_word_src="rabbit", blend_word_tgt="rabbit",
                             eq_word="origami")
    assert p2p["prompts"][1] == "a origami rabbit is jumping"
    assert p2p["blend_word"] == ["rabbit", "rabbit"]
    assert p2p["eq_params"] == {"words": ["origami"], "values": [2.0]}
    assert p2p["is_word_swap"] is False


def test_find_exp_dirs_orders_by_mtime(tmp_path):
    for i, name in enumerate(["a", "b"]):
        d = tmp_path / name
        d.mkdir()
        (d / "model_index.json").write_text(json.dumps({}))
        os.utime(d / "model_index.json", (1000 + i, 1000 + i))
    assert [os.path.basename(d) for d in find_exp_dirs(str(tmp_path))] == ["b", "a"]
    assert find_exp_dirs(str(tmp_path / "missing")) == []


def test_inference_rejects_mismatched_inv_latent(tmp_path):
    from videop2p_tpu_torch.ui.inference import InferencePipeline

    pipe = InferencePipeline()
    pipe.checkpoint_dir = str(tmp_path)
    inv_dir = tmp_path / "inv_latents"
    inv_dir.mkdir()
    np.save(inv_dir / "ddim_latent-100.npy", np.zeros((1, 4, 8, 8, 4), np.float32))
    got = pipe._latest_inv_latent()
    assert got.shape == (1, 4, 8, 8, 4)
    assert tuple(got.shape) != (1, 2, 8, 8, 4)
    with pytest.raises(RuntimeError, match="load"):
        pipe.run("x")


def test_trainer_run_p2p_prefers_engine_then_falls_back(tmp_path, monkeypatch):
    import videop2p_tpu_torch.ui.inference as inference_mod

    t = Trainer(experiments_dir=str(tmp_path / "exp"), checkpoint_dir=str(tmp_path / "ck"))
    exp = tmp_path / "exp" / "demo"
    exp.mkdir(parents=True)
    launches = []
    monkeypatch.setattr(t, "_launch", lambda *a, **k: (launches.append(a), 0)[1])
    kw = dict(output_dir=str(exp), video_path="data/rabbit",
              training_prompt="a rabbit is jumping",
              editing_prompt="a origami rabbit is jumping")
    served = []
    monkeypatch.setattr(inference_mod, "edit_via_engine",
                        lambda url, cfg, **k: (served.append((url, cfg)), "served.gif")[1])
    assert t.run_p2p(engine_url="http://fake:8000", **kw) == exp.as_posix()
    assert served and not launches
    url, cfg = served[0]
    assert url == "http://fake:8000" and cfg["prompts"][1] == "a origami rabbit is jumping"
    monkeypatch.setattr(inference_mod, "edit_via_engine", lambda url, cfg, **k: None)
    t.run_p2p(engine_url="http://fake:8000", **kw)
    assert len(launches) == 1
    monkeypatch.delenv("VIDEOP2P_SERVE_URL", raising=False)
    t.run_p2p(**kw)
    assert len(launches) == 2
    # the port's CLIs, with --fast by default
    assert launches[0][0] == "videop2p_tpu_torch.cli.run_videop2p"
    assert launches[0][2] == ["--fast"]
    assert os.path.isfile(exp / "p2p_config.yaml")


def test_edit_via_engine_fallback_semantics(monkeypatch):
    import videop2p_tpu_torch.serve.client as client_mod
    from videop2p_tpu_torch.ui.inference import edit_via_engine

    cfg = {"image_path": "data/rabbit", "prompt": "a", "prompts": ["a", "b"], "save_name": "x",
           "pretrained_model_path": "ignored", "video_len": 8}
    assert edit_via_engine(None, cfg) is None
    monkeypatch.setattr(client_mod, "engine_available", lambda url, **k: False)
    assert edit_via_engine("http://down", cfg) is None

    class FakeClient:
        def __init__(self, url, **k):
            self.url = url

        def submit(self, request):
            assert "pretrained_model_path" not in request and "video_len" not in request
            return "abc123"

        def wait(self, rid, **k):
            return {"status": "done", "edit_gif": "/srv/out.gif", "total_s": 0.1,
                    "store_hit": True, "compile_events": 0}

    monkeypatch.setattr(client_mod, "engine_available", lambda url, **k: True)
    monkeypatch.setattr(client_mod, "EngineClient", FakeClient)
    assert edit_via_engine("http://up", cfg) == "/srv/out.gif"

    class ErrorClient(FakeClient):
        def wait(self, rid, **k):
            return {"status": "error", "error": "boom"}

    monkeypatch.setattr(client_mod, "EngineClient", ErrorClient)
    assert edit_via_engine("http://up", cfg) is None


def test_metrics_logger_jsonl(tmp_path):
    from videop2p_tpu_torch.utils.metrics import MetricsLogger

    m = MetricsLogger(str(tmp_path))
    m.log(1, {"train_loss": 0.5, "lr": 3e-5})
    m.log(2, {"train_loss": 0.25, "lr": 3e-5})
    m.close()
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [line["step"] for line in lines] == [1, 2]
    assert lines[1]["train_loss"] == 0.25 and all("wall_s" in line for line in lines)


def test_bundle_make_scheduler_uses_checkpoint_config():
    from videop2p_tpu_torch.cli.common import ModelBundle

    b = ModelBundle(unet=None, vae=None, text_encoder=None,
                    scheduler_config={"steps_offset": 1, "beta_schedule": "scaled_linear",
                                      "beta_start": 0.00085, "beta_end": 0.012})
    assert b.make_scheduler().steps_offset == 1
    assert ModelBundle(unet=None, vae=None, text_encoder=None).make_scheduler().steps_offset == 0


# ---- against the JAX package ----------------------------------------------


TUNE_INPUTS = dict(video_path="data/rabbit", training_prompt="a rabbit is jumping",
                   validation_prompt="an origami rabbit is jumping", n_steps=11,
                   learning_rate=1e-5, seed=3, resolution=256, n_sample_frames=4)


@pytest.mark.parametrize("case", [
    {},
    dict(blend_word_src="rabbit", blend_word_tgt="rabbit", eq_word="origami", eq_value=3.0),
    dict(editing_prompt="a rabbit is jumping!", save_name="My Edit #1", video_len=4),
])
def test_p2p_config_equals_jax(tmp_path, case):
    from videop2p_tpu.ui.trainer import Trainer as JaxTrainer

    kw = dict(output_dir=str(tmp_path / "out"), video_path="data/rabbit",
              training_prompt="a rabbit is jumping",
              editing_prompt="a origami rabbit is jumping")
    kw.update(case)
    dirs = dict(experiments_dir=str(tmp_path / "exp"), checkpoint_dir=str(tmp_path / "ck"))
    assert Trainer(**dirs).build_p2p_config(**kw) == JaxTrainer(**dirs).build_p2p_config(**kw)


@pytest.mark.parametrize("local", [False, True])
def test_tune_config_equals_jax(tmp_path, local, monkeypatch):
    from videop2p_tpu.ui.trainer import Trainer as JaxTrainer

    # no hub lookup in a test: the snapshot download fails as offline
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    dirs = dict(experiments_dir=str(tmp_path / "exp"), checkpoint_dir=str(tmp_path / "ck"))
    port, ref = Trainer(**dirs), JaxTrainer(**dirs)
    if local:
        (tmp_path / "ck" / "some-model").mkdir(parents=True)
    kw = dict(TUNE_INPUTS, base_model="some-model", output_dir=str(tmp_path / "out"))
    assert port.build_tune_config(**kw) == ref.build_tune_config(**kw)


def test_ui_imports_no_optional_package():
    import subprocess

    code = ("import sys; import videop2p_tpu_torch.ui, videop2p_tpu_torch.ui.app; "
            "bad = [m for m in ('gradio', 'huggingface_hub', 'yaml', 'jax', 'videop2p_tpu') "
            "if m in sys.modules]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_build_app_names_gradio_when_missing(monkeypatch):
    from videop2p_tpu_torch.ui import app

    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        app.build_app()


def test_default_uploader_imports_hub_only_when_called(monkeypatch):
    from videop2p_tpu_torch.ui import upload

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(ImportError):
        upload._default_api_factory("tok")


@pytest.fixture(scope="module")
def program_sets():
    from videop2p_tpu.serve import ProgramSet as JaxProgramSet
    from videop2p_tpu.serve import ProgramSpec as JaxSpec

    from tests.test_torch_serve_jax import KW, paired_bundles
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec

    jax_bundle, port_bundle = paired_bundles()
    return (JaxProgramSet(JaxSpec(**KW), bundle=jax_bundle),
            ProgramSet(ProgramSpec(**KW), bundle=port_bundle, device="cpu"))


def _inputs(jps):
    import jax.numpy as jnp

    x_t = np.random.default_rng(11).normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    cond = np.asarray(jps.encode_prompts([PROMPT]))
    uncond = np.asarray(jps.encode_prompts([""])[0])
    return (jnp.asarray(x_t), jnp.asarray(cond), jnp.asarray(uncond)), tuple(
        torch.from_numpy(np.array(a)) for a in (x_t, cond, uncond))


def test_decode_matches_jax(program_sets):
    jps, pps = program_sets
    lat = np.random.default_rng(12).normal(size=(2, 2, 8, 8, 4)).astype(np.float32)
    want = np.asarray(jps.decode(lat))
    got = np32(pps.decode(torch.from_numpy(lat)))
    assert got.shape == want.shape == (2, 2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def test_sample_matches_jax(program_sets):
    import jax

    jps, pps = program_sets
    jargs, pargs = _inputs(jps)
    np.testing.assert_allclose(np32(pps.encode_prompts([PROMPT])), np.asarray(jargs[1]),
                               atol=1e-5, rtol=0)
    want = np.asarray(jps.sample(*jargs, jax.random.key(0), steps=2, guidance_scale=7.5))
    got = np32(pps.sample(*pargs, steps=2, guidance_scale=7.5))
    assert got.shape == want.shape == (1, 2, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def test_sample_equals_edit_sample_then_decode(program_sets):
    from videop2p_tpu_torch.pipelines.sampling import edit_sample

    _, pps = program_sets
    x_t, cond, uncond = _inputs(program_sets[0])[1]
    with torch.no_grad():
        latents = edit_sample(pps.unet_fn, pps.scheduler, x_t, cond, uncond,
                              num_inference_steps=2, guidance_scale=7.5)
    assert torch.equal(pps.sample(x_t, cond, uncond, steps=2, guidance_scale=7.5),
                       pps.decode(latents))


def test_sample_programs_keyed_on_steps_and_guidance(program_sets, tmp_path):
    from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger

    _, pps = program_sets
    x_t, cond, uncond = _inputs(program_sets[0])[1]
    led = RunLedger(str(tmp_path / "led.jsonl")).activate()
    pps.sample(x_t, cond, uncond, steps=1, guidance_scale=3.0)
    misses = pps.cache_misses
    pps.sample(x_t, cond, uncond, steps=1, guidance_scale=3.0)
    assert pps.cache_misses == misses
    pps.sample(x_t, cond, uncond, steps=1, guidance_scale=5.0)
    assert pps.cache_misses == misses + 1
    led.close()
    calls = [(e["program"], e["cache_miss"]) for e in read_ledger(led.path)
             if e["event"] == "program_call"]
    assert calls == [("sample_decode", True), ("sample_decode", False),
                     ("sample_decode", True)]


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from videop2p_tpu_torch.cli.common import build_models
    from videop2p_tpu_torch.models.pipeline_io import save_pipeline

    root = tmp_path_factory.mktemp("ckpt") / "exp"
    unet = build_models(None, tiny=True, device="cpu", seed=0).unet
    save_pipeline(str(root), unet.config, unet.state_dict())
    return str(root)


def test_inference_pipeline_writes_a_gif_and_reuses_its_program(tiny_checkpoint, tmp_path,
                                                               monkeypatch):
    from PIL import Image

    from videop2p_tpu_torch.obs.ledger import RunLedger, read_ledger
    from videop2p_tpu_torch.ui.inference import InferencePipeline

    monkeypatch.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        pipe = InferencePipeline(tiny_checkpoint, device="cpu", mixed_precision="fp32")
    assert InferencePipeline().mixed_precision == "bf16"
    led = RunLedger(str(tmp_path / "led.jsonl")).activate()
    kw = dict(video_length=2, num_steps=2, height=64, width=64, seed=5)
    paths = [pipe.run(PROMPT, out_path=str(tmp_path / f"s{i}.gif"), **kw) for i in range(2)]
    led.close()
    for path in paths:
        with Image.open(path) as im:
            assert im.n_frames == 2 and im.size == (16, 16)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    events = read_ledger(led.path)
    # the second run reuses the warm program: no new first-call event
    assert [e["program"] for e in events if e["event"] == "compile"] == ["sample_decode"]
    assert [e["program"] for e in events if e["event"] == "program_analysis"] == [
        "sample_decode"]
    # loading the same directory again is a no-op
    programs = pipe.programs
    pipe.load(tiny_checkpoint)
    assert pipe.programs is programs


def test_inference_uses_a_fitting_inv_latent(tiny_checkpoint, tmp_path):
    from videop2p_tpu_torch.ui.inference import InferencePipeline

    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        pipe = InferencePipeline(tiny_checkpoint, device="cpu", mixed_precision="fp32")
    inv_dir = os.path.join(tiny_checkpoint, "inv_latents")
    os.makedirs(inv_dir, exist_ok=True)
    inv = np.random.default_rng(3).normal(size=(1, 2, 8, 8, 4)).astype(np.float32)
    np.save(os.path.join(inv_dir, "ddim_latent-2.npy"), inv)
    seen = []
    ps = pipe.programs
    orig = ps.sample
    ps.sample = lambda x_t, *a, **k: (seen.append(x_t), orig(x_t, *a, **k))[1]
    try:
        pipe.run(PROMPT, video_length=2, num_steps=1, height=64, width=64,
                 out_path=str(tmp_path / "a.gif"))
        pipe.run(PROMPT, video_length=2, num_steps=1, height=64, width=64,
                 use_inv_latent=False, seed=1, out_path=str(tmp_path / "b.gif"))
    finally:
        ps.sample = orig
        os.remove(os.path.join(inv_dir, "ddim_latent-2.npy"))
    assert np.array_equal(seen[0].numpy(), inv)
    want = torch.randn((1, 2, 8, 8, 4), generator=torch.Generator("cpu").manual_seed(1))
    assert torch.equal(seen[1], want)
