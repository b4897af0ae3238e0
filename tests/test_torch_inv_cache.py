"""Persisted inversion reuse in the port against the JAX package, on the CPU:
``utils/inv_cache.py`` and the disk layer of ``serve/store.py`` against
JAX's, the CLI's key against JAX's CLI's, and the CLI's reuse decisions at
tiny size.

Tolerances: keys, fingerprints, file names and loaded arrays exactly; a
repeat run's output bit for bit the first run's.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_slice import RABBIT

STEPS = 3


def _tree(root):
    os.makedirs(os.path.join(root, "unet"))
    os.makedirs(os.path.join(root, "results_dpFalse", "inv_cache"))
    with open(os.path.join(root, "unet", "w.bin"), "wb") as fh:
        fh.write(bytes(range(256)) * 64)
    with open(os.path.join(root, "model_index.json"), "w") as fh:
        fh.write("{}")
    with open(os.path.join(root, "results_dpFalse", "x.gif"), "w") as fh:
        fh.write("output, not content")


@pytest.mark.parametrize("determinants", [
    dict(image_path="/a/b", prompt="a rabbit", steps=50, width=512, video_len=8,
         dependent_p2p=False, dependent_weights=0.0, seed=0, tiny=False, guidance=7.5),
    dict(prompt="x", steps=4, decay_rate=0.3, ar_sample=True, checkpoint=None,
         impl="torch", mixed_precision="bf16"),
])
def test_key_and_fingerprints_match_jax(tmp_path, determinants):
    from videop2p_tpu.utils import inv_cache as jax_cache

    from videop2p_tpu_torch.utils import inv_cache

    assert inv_cache.inversion_cache_key(**determinants) == jax_cache.inversion_cache_key(
        **determinants)
    root = str(tmp_path / "ckpt")
    _tree(root)
    for path in (root, os.path.join(root, "unet", "w.bin"), str(tmp_path / "missing")):
        assert inv_cache.content_fingerprint(path) == jax_cache.content_fingerprint(path)
    # the run's own outputs do not churn the checkpoint's identity; content does
    before = inv_cache.content_fingerprint(root)
    with open(os.path.join(root, "results_dpFalse", "y.gif"), "w") as fh:
        fh.write("more output")
    assert inv_cache.content_fingerprint(root) == before
    with open(os.path.join(root, "unet", "w.bin"), "r+b") as fh:
        fh.seek(8192)
        fh.write(b"\xff")
    assert inv_cache.content_fingerprint(root) != before


def test_entries_cross_between_packages(tmp_path):
    """An entry JAX's ``save_inversion`` wrote loads in the port, and one
    the port wrote loads in JAX; the null embeddings by their tag; no
    temporary file stays visible; the first writer wins."""
    from videop2p_tpu.serve.store import load_persisted_inversion as jax_load
    from videop2p_tpu.utils.inv_cache import save_inversion as jax_save

    from videop2p_tpu_torch.serve.store import (
        load_persisted_inversion,
        save_persisted_inversion,
    )
    from videop2p_tpu_torch.utils.inv_cache import load_inversion, save_inversion

    rng = np.random.default_rng(0)
    traj = rng.normal(size=(4, 1, 2, 8, 8, 4)).astype(np.float32)
    null = rng.normal(size=(3, 1, 77, 16)).astype(np.float32)
    root = str(tmp_path)
    jax_save(root, "k1", traj, null, null_tag="_i10", meta={"steps": 3})
    got_traj, got_null = load_inversion(root, "k1", want_null=True, null_tag="_i10")
    np.testing.assert_array_equal(got_traj, traj)
    np.testing.assert_array_equal(got_null, null)
    assert load_inversion(root, "k1", want_null=True, null_tag="_i3")[1] is None
    assert load_inversion(root, "k1", want_null=False, null_tag="_i10")[1] is None
    assert load_inversion(root, "nope", want_null=True) is None

    save_inversion(root, "k2", traj, meta={"fast": True})
    save_persisted_inversion(root, "k2", None, null, null_tag="_i2_hybrid")
    # the first writer wins: a second trajectory does not replace the first
    save_inversion(root, "k2", traj + 1)
    want_traj, want_null = jax_load(root, "k2", want_null=True, null_tag="_i2_hybrid")
    np.testing.assert_array_equal(want_traj, traj)
    np.testing.assert_array_equal(want_null, null)
    got = load_persisted_inversion(root, "k2", want_null=True, null_tag="_i2_hybrid")
    np.testing.assert_array_equal(got[0], traj)
    for key in ("k1", "k2"):
        names = sorted(os.listdir(os.path.join(root, "inv_cache", key)))
        assert not [n for n in names if "tmp" in n or n.startswith(".")], names
    assert sorted(os.listdir(os.path.join(root, "inv_cache", "k2"))) == [
        "meta.json", "null_embeddings_i2_hybrid.npy", "trajectory.npy"]
    # no root, or one that cannot be written: nothing, and no raise
    assert load_persisted_inversion("", "k1") is None
    assert save_persisted_inversion("", "k1", traj) is None
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert save_persisted_inversion(str(blocker), "k1", traj) is None


@pytest.mark.parametrize("inner, precision, mode", [
    (10, "fp32", "optimize"), (2, "mixed", "optimize"), (10, "fp32", "amortized"),
    (3, "mixed", "hybrid")])
def test_null_tag_is_jax_s(inner, precision, mode):
    from videop2p_tpu_torch.cli.run_videop2p import null_text_tag

    # JAX: run_videop2p.py:579-581
    want = f"_i{inner}" + ("_mixed" if precision == "mixed" else "") + (
        "" if mode == "optimize" else f"_{mode}")
    assert null_text_tag(inner, precision, mode) == want


class _Captured(Exception):
    pass


def test_cli_key_is_jax_s_and_impl(tmp_path, monkeypatch):
    """The determinants both CLIs hash for the same run differ by exactly
    ``impl``: each CLI is stopped at its key."""
    import videop2p_tpu.utils.inv_cache as jax_cache
    from videop2p_tpu.cli.run_videop2p import main as jax_main

    import videop2p_tpu_torch.cli.run_videop2p as port_cli

    clip = tmp_path / "clip"
    clip.mkdir()
    from PIL import Image

    rng = np.random.default_rng(4)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(
            clip / f"{i}.png")
    kw = dict(RABBIT, pretrained_model_path=str(tmp_path / "rabbit-jump"),
              image_path=str(clip), tiny=True, video_len=2, fast=True,
              reuse_inversion=True)
    seen = {}

    def capture(name):
        def key(**determinants):
            seen[name] = determinants
            raise _Captured
        return key

    monkeypatch.setattr(jax_cache, "inversion_cache_key", capture("jax"))
    with pytest.raises(_Captured):
        jax_main(**kw, program_analysis=False)
    monkeypatch.setattr(port_cli, "inversion_cache_key", capture("port"))
    with pytest.raises(_Captured):
        port_cli.main(**kw, device="cpu", num_ddim_steps=50)
    assert seen["port"] == dict(seen["jax"], impl="torch")


def _frames(seed=3):
    return np.random.default_rng(seed).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)


def _kw(root, **extra):
    return dict(RABBIT, pretrained_model_path=str(root / "rabbit-jump"), device="cpu",
                tiny=True, video_len=2, num_ddim_steps=STEPS, frames=_frames(),
                save_gifs=False, reuse_inversion=True, num_inner_steps=2, **extra)


@pytest.fixture
def unet_calls(monkeypatch):
    """The number of UNet forwards since the last read."""
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel

    count = [0]
    forward = UNet3DConditionModel.forward

    def counted(self, *a, **kw):
        count[0] += 1
        return forward(self, *a, **kw)

    monkeypatch.setattr(UNet3DConditionModel, "forward", counted)

    def read():
        n, count[0] = count[0], 0
        return n

    return read


def test_repeat_official_run_reuses_both_products(tmp_path, unet_calls):
    from videop2p_tpu_torch.cli.run_videop2p import main

    first = main(**_kw(tmp_path))
    first_calls = unet_calls()
    assert first["reused"] == {"trajectory": False, "null_text": False}
    repeat = main(**_kw(tmp_path))
    assert repeat["reused"] == {"trajectory": True, "null_text": True}
    assert unet_calls() == STEPS  # the edit's forwards only
    assert "ddim_inversion" not in repeat["timings"]
    assert "null_text_optimization" not in repeat["timings"]
    assert repeat["null_text"] is None and repeat["inv_key"] == first["inv_key"]
    assert torch.equal(repeat["videos"], first["videos"])
    assert torch.equal(repeat["latents"], first["latents"])
    fresh = main(**dict(_kw(tmp_path), reuse_inversion=False))
    assert unet_calls() == first_calls
    assert fresh["reused"] == {"trajectory": False, "null_text": False}
    assert torch.equal(fresh["videos"], first["videos"])
    entry = os.path.join(first["output_dir"], "inv_cache", first["inv_key"])
    assert sorted(os.listdir(entry)) == ["meta.json", "null_embeddings_i2.npy",
                                         "trajectory.npy"]


@pytest.mark.parametrize("change", [dict(null_text_mode="amortized"),
                                    dict(null_text_precision="mixed"),
                                    dict(num_inner_steps=3),
                                    dict(null_text_mode="hybrid")],
                         ids=["mode", "precision", "inner_steps", "hybrid"])
def test_null_settings_miss_by_their_tag(tmp_path, unet_calls, change):
    from videop2p_tpu_torch.cli.run_videop2p import main

    main(**_kw(tmp_path))
    unet_calls()
    other = main(**{**_kw(tmp_path), **change})
    assert other["reused"] == {"trajectory": True, "null_text": False}
    assert "ddim_inversion" not in other["timings"]
    assert "null_text_optimization" in other["timings"]
    again = main(**{**_kw(tmp_path), **change})
    assert again["reused"] == {"trajectory": True, "null_text": True}
    assert torch.equal(again["videos"], other["videos"])


def test_cached_run_saves_and_never_reads(tmp_path, unet_calls):
    """The cached fast path saves its trajectory and never consults the
    store; a later official run reuses the trajectory and runs null-text;
    other frames at the same path miss."""
    from videop2p_tpu_torch.cli.run_videop2p import main

    cached = main(**_kw(tmp_path, fast=True))
    assert cached["mode"] == "cached" and cached["reused"]["trajectory"] is False
    again = main(**_kw(tmp_path, fast=True))
    assert again["reused"]["trajectory"] is False
    assert torch.equal(again["videos"], cached["videos"])
    unet_calls()
    official = main(**_kw(tmp_path))
    assert official["reused"] == {"trajectory": True, "null_text": False}
    assert torch.equal(official["x_t"], cached["x_t"])
    assert "ddim_inversion" not in official["timings"]
    live = main(**_kw(tmp_path, fast=True, live_source=True))
    assert live["reused"] == {"trajectory": True, "null_text": False}
    other = main(**dict(_kw(tmp_path), frames=_frames(4)))
    assert other["reused"] == {"trajectory": False, "null_text": False}
    assert other["inv_key"] != official["inv_key"]


def test_bundle_run_neither_reads_nor_writes(tmp_path):
    from videop2p_tpu_torch.cli.common import build_models
    from videop2p_tpu_torch.cli.run_videop2p import main

    bundle = build_models(tiny=True, device="cpu", seed=0)
    out = main(**_kw(tmp_path), bundle=bundle)
    assert not os.path.exists(os.path.join(out["output_dir"], "inv_cache"))
    main(**_kw(tmp_path))
    assert os.path.isdir(os.path.join(out["output_dir"], "inv_cache"))
    again = main(**_kw(tmp_path), bundle=bundle)
    assert again["reused"] == {"trajectory": False, "null_text": False}
    assert "ddim_inversion" in again["timings"]


def test_inv_store_is_shared_across_results_directories(tmp_path):
    from videop2p_tpu_torch.cli.run_videop2p import main

    store = str(tmp_path / "store")
    a = main(**dict(_kw(tmp_path / "a"), inv_store=store))
    b = main(**dict(_kw(tmp_path / "b"), inv_store=store))
    assert b["reused"] == {"trajectory": True, "null_text": True}
    assert torch.equal(a["videos"], b["videos"])
    assert os.path.isdir(os.path.join(store, "inv_cache", a["inv_key"]))
    assert not os.path.exists(os.path.join(a["output_dir"], "inv_cache"))
