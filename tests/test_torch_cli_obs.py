"""The run CLIs' observability flags on the CPU: ``python -m
videop2p_tpu_torch.cli.run_videop2p --device cpu --tiny --fast`` with every
ported flag, twice on one ledger (its records, JAX's
``tools/ledger_summary.py`` and ``tools/edit_report.py`` rendering it);
official mode's null-text record; ``--incidents`` with a forced crash;
``python -m videop2p_tpu_torch.cli.run_tuning --device cpu --tiny
--telemetry --latency --ledger L``'s ledger; the three flags that stay
refused.

The same ledger against the JAX CLI's is ``tests/test_torch_cli_obs_jax.py``;
Stage 1's gradient norms against JAX's are
``tests/test_torch_obs_tuning.py``.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_slice import RABBIT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--telemetry", "--attn_maps", "--quality", "--report", "--latency"]
# the JAX tuning CLI's event kinds under --telemetry --latency --ledger
# (the port analyses train_steps' first call as JAX analyses its compile)
JAX_TUNE_KINDS = {"run_start", "phase", "compile", "program_call", "program_analysis",
                  "metric", "memory", "execute_timing", "artifacts", "run_end"}


def _config(root, **over) -> str:
    cfg = {k: v for k, v in RABBIT.items() if k != "reuse_inversion"}
    cfg.update(pretrained_model_path=str(root / "ckpt"),
               image_path=os.path.join(REPO, "data", "rabbit"), video_len=2)
    cfg.update(over)
    path = str(root / "cfg.yaml")
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _run_cli(module: str, argv, monkeypatch):
    """``python -m module argv...`` in this process."""
    import warnings

    monkeypatch.setattr(sys, "argv", [module] + list(argv))
    with warnings.catch_warnings():
        # runpy's note that the module was imported before: it was, by
        # earlier tests, and its __main__ block runs all the same
        warnings.filterwarnings("ignore", message=".*found in sys.modules",
                                category=RuntimeWarning)
        runpy.run_module(module, run_name="__main__", alter_sys=False)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Two port CLI runs on one ledger, every ported flag on."""
    from _pytest.monkeypatch import MonkeyPatch

    from videop2p_tpu_torch.obs.ledger import read_ledger

    root = tmp_path_factory.mktemp("port")
    led = str(root / "led.jsonl")
    # program analysis off, as in the JAX run tests/test_torch_cli_obs_jax.py
    # holds this ledger against
    argv = ["--config", _config(root), "--device", "cpu", "--tiny", "--fast", "--steps",
            "2", "--no_reuse_inversion", "--ledger", led, "--incidents",
            str(root / "inc"), "--no_program_analysis"] + FLAGS
    mp = MonkeyPatch()
    try:
        with pytest.warns(UserWarning, match="RANDOM-INIT"):
            _run_cli("videop2p_tpu_torch.cli.run_videop2p", argv, mp)
            _run_cli("videop2p_tpu_torch.cli.run_videop2p", argv, mp)
    finally:
        mp.undo()
    return {"root": root, "ledger": led, "events": read_ledger(led)}


def test_cli_ledger_records(port_runs):
    events = port_runs["events"]
    tel = [e for e in events if e["event"] == "telemetry"]
    assert [e["program"] for e in tel] == ["cached_invert_edit"] * 2
    assert tel[0]["summary"]["steps"] == 2 and tel[0]["summary"]["nan_total"] == 0
    attn = [e for e in events if e["event"] == "attn_maps"]
    assert [e["scope"] for e in attn] == ["inversion", "edit"] * 2
    assert attn[0]["sites"][0] == "down_blocks_0/attentions_0/blocks_0/attn2"
    assert attn[1]["streams"] == [1] and "mask_cov_final" in attn[1]
    timing = {e["program"] for e in events if e["event"] == "execute_timing"}
    assert timing == {"cached_invert_edit"}
    notes = [e["note"] for e in events if e["event"] == "memory"]
    assert notes == ["after_cached_edit", "run_end"] * 2
    quality = [e for e in events if e["event"] == "quality"]
    assert len(quality) == 2 and np.isfinite(quality[0]["recon_psnr"])
    arts = [e for e in events if e["event"] == "artifacts"]
    assert all(os.path.isfile(a["report"]) and os.path.isfile(a["edit_gif"]) for a in arts)
    sidecar = attn[0]["sidecar"]
    with np.load(sidecar) as z:
        keys = set(z.files)
    assert {"attn_inversion/cross_heat", "attn_edit/mask_heat", "frames/source",
            "quality/recon_psnr_frames"} <= keys
    # a healthy run writes no bundle (the incident root holds only the
    # faulthandler log)
    assert os.listdir(port_runs["root"] / "inc") == ["faulthandler.log"]


def test_jax_tools_render_the_port_ledger(port_runs, capsys):
    summary = runpy.run_path(os.path.join(REPO, "tools", "ledger_summary.py"))
    assert summary["main"](["ledger_summary.py", port_runs["ledger"]]) == 0
    out = capsys.readouterr().out
    assert "cached_invert_edit" in out
    report = runpy.run_path(os.path.join(REPO, "tools", "edit_report.py"))
    html_path = str(port_runs["root"] / "jax_report.html")
    assert report["main"](["edit_report.py", port_runs["ledger"], "-o", html_path]) == 0
    text = open(html_path).read()
    assert "Per-word cross-attention heatmaps" in text and "Edit quality" in text


def test_official_mode_null_text_record(tmp_path, monkeypatch):
    from videop2p_tpu.obs.telemetry import decode_null_text_stats as jax_decode

    import videop2p_tpu_torch.cli.run_videop2p as cli
    import videop2p_tpu_torch.pipelines.inversion as inversion
    from videop2p_tpu_torch.obs.ledger import read_ledger

    # the null-text phase and the edit are two programs, one after the
    # other: "edit_sample"'s timing holds the edit alone
    spans = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            spans.append(("enter", name))
            out = fn(*args, **kwargs)
            spans.append(("exit", name))
            return out
        return wrapped

    monkeypatch.setattr(cli, "edit_sample", spy(cli.edit_sample, "edit"))
    monkeypatch.setattr(inversion, "null_text_optimization",
                        spy(inversion.null_text_optimization, "null_text"))
    monkeypatch.delenv("VIDEOP2P_OBS_LATENCY", raising=False)
    led = str(tmp_path / "led.jsonl")
    frames = np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        res = cli.main(**dict(RABBIT, pretrained_model_path=str(tmp_path / "ckpt")),
                       tiny=True, device="cpu", num_ddim_steps=2, video_len=2, frames=frames,
                       save_gifs=False, num_inner_steps=2, ledger=led, telemetry=True,
                       latency=True)
    assert spans == [("enter", "null_text"), ("exit", "null_text"),
                     ("enter", "edit"), ("exit", "edit")]
    assert "VIDEOP2P_OBS_LATENCY" not in os.environ  # restored when the ledger closed
    events = read_ledger(led)
    timing = {e["program"]: e["count"] for e in events if e["event"] == "execute_timing"}
    assert timing == {"ddim_inversion": 1, "null_text_fused": 1, "edit_sample": 1}
    tel = {e["program"]: e for e in events if e["event"] == "telemetry"}
    assert sorted(tel) == ["edit_sample", "null_text_fused"]
    rec = tel["null_text_fused"]
    want = jax_decode({k: np.asarray(v) for k, v in res["null_text"].items()
                       if k != "latent_stats"})
    assert sorted(set(rec) - {"event", "t", "program"}) == sorted(set(want) | {"latent"})
    assert rec["inner_steps"] == res["null_text"]["inner_steps"].tolist()
    assert rec["latent"]["steps"] == 2 and rec["latent"]["nan_total"] == 0
    assert len(rec["loss_curve"]) == 2
    notes = [e["note"] for e in events if e["event"] == "memory"]
    assert notes == ["after_null_text", "after_edit", "run_end"]
    phases = {e["name"]: e for e in events if e["event"] == "phase"}
    assert phases["null_text_optimization"]["count"] == 4
    assert phases["null_text_optimization"]["unit"] == "inner-step"
    calls = [e["program"] for e in events if e["event"] == "program_call"]
    assert calls == ["ddim_inversion", "null_text_fused", "edit_sample"]


def test_incidents_capture_a_crash_bundle(tmp_path):
    """A run that dies after its ledger opened (here: no frames at the image
    path) leaves one ``crash`` bundle under ``--incidents``."""
    inc, led = str(tmp_path / "inc"), str(tmp_path / "led.jsonl")
    cfg = _config(tmp_path, image_path=str(tmp_path / "no_such_clip"))
    proc = subprocess.run(
        [sys.executable, "-m", "videop2p_tpu_torch.cli.run_videop2p", "--config", cfg,
         "--device", "cpu", "--tiny", "--fast", "--steps", "2", "--ledger", led,
         "--incidents", inc], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    bundles = [d for d in os.listdir(inc) if os.path.isdir(os.path.join(inc, d))]
    assert len(bundles) == 1
    with open(os.path.join(inc, bundles[0], "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["trigger"] == "crash"
    crash = open(os.path.join(inc, bundles[0], "crash.txt")).read()
    assert "no_such_clip" in crash or "Error" in crash
    kinds = [json.loads(line)["event"] for line in open(led)]
    assert kinds[0] == "run_start" and "incident" in kinds


def test_run_tuning_cli_ledger(tmp_path, monkeypatch, capsys):
    import yaml

    from videop2p_tpu_torch.obs.ledger import read_ledger

    led = str(tmp_path / "tune_ledger.jsonl")
    cfg = dict(
        pretrained_model_path=str(tmp_path / "no_checkpoint"),
        output_dir=str(tmp_path / "out" / "rabbit-jump"),
        train_data={"video_path": os.path.join(REPO, "data", "rabbit"),
                    "prompt": "a rabbit is jumping on the grass", "n_sample_frames": 2,
                    "width": 16, "height": 16},
        validation_data={"prompts": ["a origami rabbit is jumping on the grass"],
                         "num_inv_steps": 2, "num_inference_steps": 2},
        max_train_steps=2, checkpointing_steps=0, validation_steps=2, log_every=1,
        steps_per_call=1, mixed_precision="no", seed=0, gradient_checkpointing=False)
    path = str(tmp_path / "tune.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    # --latency switches execute timing on process-wide while the ledger is
    # open, then restores what was there
    monkeypatch.setenv("VIDEOP2P_OBS_LATENCY", "0")
    # the JAX CLI's --no_program_analysis leaves its kill switch set for the
    # rest of its process, which may be this one
    monkeypatch.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)
    argv = ["--config", path, "--device", "cpu", "--tiny", "--telemetry", "--latency",
            "--ledger", led, "--attn_maps"]
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        _run_cli("videop2p_tpu_torch.cli.run_tuning", argv, monkeypatch)
    assert "--attn_maps/--quality/--report are Stage-2" in capsys.readouterr().out
    events = read_ledger(led)
    kinds = {e["event"] for e in events}
    assert kinds == JAX_TUNE_KINDS
    start = events[0]
    assert start["cli"] == "run_tuning" and start["telemetry"] and start["latency"]
    metrics = [e for e in events if e["event"] == "metric"]
    assert [m["step"] for m in metrics] == [1, 2]
    assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0 for m in metrics)
    assert sorted(metrics[0]) == ["event", "grad_norm", "lr", "step", "t", "train_loss",
                                  "wall_s"]
    timing = [e for e in events if e["event"] == "execute_timing"]
    assert [(e["program"], e["count"]) for e in timing] == [("train_steps", 2)]
    calls = [e for e in events if e["event"] == "program_call"]
    assert [c["program"] for c in calls] == ["train_steps"] * 2
    assert all("blocked_s" in c for c in calls)
    assert [e["note"] for e in events if e["event"] == "memory"] == ["after_training"]
    arts = [e for e in events if e["event"] == "artifacts"]
    assert len(arts) == 1 and os.path.isdir(arts[0]["pipeline_dir"])
    assert {e["name"] for e in events if e["event"] == "phase"} >= {"vae_encode", "validation"}
    assert os.environ.get("VIDEOP2P_OBS_LATENCY") == "0"


@pytest.mark.parametrize("module", ["run_videop2p", "run_tuning"])
@pytest.mark.parametrize("flag,item", [
    ("--device_telemetry", "item 13"),
])
def test_unported_flags_name_their_item(module, flag, item, monkeypatch, capsys):
    """Every JAX observability flag of the run CLIs is now parsed (the last,
    ``--device_telemetry``, came with item 13): a config that cannot be
    read fails on the config, not on the flag."""
    with pytest.raises(FileNotFoundError, match="unused.yaml"):
        _run_cli(f"videop2p_tpu_torch.cli.{module}", ["--config", "unused.yaml", flag],
                 monkeypatch)
    assert "is not ported" not in capsys.readouterr().err
