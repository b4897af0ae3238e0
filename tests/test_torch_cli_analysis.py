"""The run CLIs with ``--no_program_analysis`` and ``--trace_analysis``
(JAX's semantics), on the CPU at the tiny size: ``run_videop2p --fast``
and official mode, and ``run_tuning``, with the flags on and off. The
outputs are the same bits either way; the ledger holds one
``program_analysis`` per program (or its ``disabled`` skip), the traced
window's ``trace_analysis`` (exactly one tuning chunk, the second), and the
kill switch is restored when the ledger closes. ``--device_telemetry``
reaches ``main`` and, without a mesh, is noted and ignored.
"""

import json
import os

import pytest
import torch

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_cli_obs import _config, _run_cli
from tests.test_torch_slice import RABBIT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FIELDS = ("flops", "transcendentals", "bytes_accessed", "argument_bytes", "output_bytes",
              "temp_bytes", "alias_bytes", "generated_code_bytes", "peak_hbm_bytes",
              "hlo_instructions", "hlo_fingerprint", "hlo_histogram")


@pytest.fixture(autouse=True)
def analysis_on(monkeypatch):
    monkeypatch.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)


def _edit(root, **kw):
    from videop2p_tpu_torch.cli.run_videop2p import main

    args = dict(RABBIT, pretrained_model_path=str(root / "ckpt"), tiny=True, video_len=2,
                num_ddim_steps=2, device="cpu", save_gifs=False)
    args.update(kw)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        return main(**args)


def _events(path, kind):
    from videop2p_tpu_torch.obs.ledger import read_ledger

    return [e for e in read_ledger(path) if e["event"] == kind]


@pytest.fixture(scope="module")
def fast_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast")
    led = str(root / "led.jsonl")
    mp = pytest.MonkeyPatch()
    mp.delenv("VIDEOP2P_OBS_NO_ANALYSIS", raising=False)
    try:
        runs = {"off": _edit(root, fast=True),
                "on": _edit(root, fast=True, ledger=led, trace_analysis=True),
                "again": _edit(root, fast=True, ledger=led, trace_analysis=True),
                "no_analysis": _edit(root, fast=True, ledger=led, program_analysis=False)}
        env_after = os.environ.get("VIDEOP2P_OBS_NO_ANALYSIS")
    finally:
        mp.undo()
    return {"runs": runs, "ledger": led, "env_after": env_after}


@pytest.mark.parametrize("run", ["on", "again", "no_analysis"])
@pytest.mark.parametrize("key", ["latents", "videos", "x_t"])
def test_fast_outputs_same_bits_with_the_flags(fast_runs, run, key):
    assert torch.equal(fast_runs["runs"][run][key], fast_runs["runs"]["off"][key])


def test_fast_program_analysis_events(fast_runs):
    pa = _events(fast_runs["ledger"], "program_analysis")
    assert [e["program"] for e in pa] == ["cached_invert_edit"] * 2
    for e in pa:
        assert set(JAX_FIELDS) <= set(e) and e["analysis_s"] >= 0
        assert e["flops"] > 0 and e["transcendentals"] > 0
        assert e["hlo_instructions"] == sum(e["hlo_histogram"].values())
    # the same record in both runs, less the analysis' own seconds
    first, second = ({k: v for k, v in e.items() if k not in ("t", "analysis_s")}
                     for e in pa)
    assert first == second


def test_no_program_analysis_is_a_disabled_skip_and_restores(fast_runs):
    skips = _events(fast_runs["ledger"], "program_analysis_skipped")
    assert [(e["program"], e["reason"]) for e in skips] == [("cached_invert_edit", "disabled")]
    assert fast_runs["env_after"] is None


def test_fast_trace_analysis_events(fast_runs):
    from videop2p_tpu_torch.obs.trace import TRACE_ANALYSIS_FIELDS

    ta = _events(fast_runs["ledger"], "trace_analysis")
    assert [e["name"] for e in ta] == ["cached_invert_edit"] * 2
    for e in ta:
        assert set(TRACE_ANALYSIS_FIELDS) <= set(e)
        # a CPU capture holds no device event
        assert e["num_events"] == 0 and os.path.isfile(e["sidecar"])
        assert os.path.isfile(os.path.join(e["trace_dir"], "trace_cached_invert_edit.json"))
    starts = _events(fast_runs["ledger"], "run_start")
    assert [s["trace_analysis"] for s in starts] == [True, True, False]


def test_official_mode_analyses_each_program(tmp_path):
    led = str(tmp_path / "led.jsonl")
    off = _edit(tmp_path, fast=False, num_inner_steps=2, reuse_inversion=False)
    on = _edit(tmp_path, fast=False, num_inner_steps=2, reuse_inversion=False, ledger=led,
               trace_analysis=True)
    assert torch.equal(on["latents"], off["latents"])
    pa = {e["program"]: e for e in _events(led, "program_analysis")}
    assert sorted(pa) == ["ddim_inversion", "edit_sample", "null_text_fused"]
    # null-text differentiates through the UNet: a backward's convolutions
    assert pa["null_text_fused"]["hlo_histogram"].get("convolution_backward", 0) > 0
    assert pa["null_text_fused"]["flops"] > pa["ddim_inversion"]["flops"]
    assert [e["name"] for e in _events(led, "trace_analysis")] == ["edit_sample"]


def _tune_cfg(root, steps=3):
    return dict(
        pretrained_model_path=str(root / "no_checkpoint"),
        output_dir=str(root / "out" / "rabbit-jump"),
        train_data={"video_path": os.path.join(REPO, "data", "rabbit"),
                    "prompt": "a rabbit is jumping on the grass", "n_sample_frames": 2,
                    "width": 16, "height": 16},
        validation_data={"prompts": ["a origami rabbit is jumping on the grass"],
                         "num_inv_steps": 2, "num_inference_steps": 2},
        max_train_steps=steps, checkpointing_steps=0, validation_steps=0, log_every=1,
        steps_per_call=1, mixed_precision="no", seed=0, gradient_checkpointing=False)


def _tune(root, **kw):
    from videop2p_tpu_torch.cli.run_tuning import main

    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        out = main(**_tune_cfg(root), device="cpu", tiny=True, **kw)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["train_loss"] for line in f]


def test_tuning_traces_exactly_one_chunk(tmp_path):
    led = str(tmp_path / "led.jsonl")
    off = _tune(tmp_path / "off")
    on = _tune(tmp_path / "on", ledger=led, trace_analysis=True)
    assert on == off and len(on) == 3
    ta = _events(led, "trace_analysis")
    assert [e["name"] for e in ta] == ["train_steps_chunk"]
    calls = [e for e in _events(led, "program_call") if e["program"] == "train_steps"]
    assert len(calls) == 3
    # the traced chunk is the second: after the first call's analysis
    assert calls[0]["t"] < ta[0]["t"] and calls[1]["t"] <= ta[0]["t"] < calls[2]["t"]
    pa = _events(led, "program_analysis")
    assert [e["program"] for e in pa] == ["train_steps"]
    assert pa[0]["hlo_histogram"].get("convolution_backward", 0) > 0


def test_tuning_no_program_analysis(tmp_path):
    led = str(tmp_path / "led.jsonl")
    _tune(tmp_path, ledger=led, program_analysis=False)
    skips = _events(led, "program_analysis_skipped")
    assert [(e["program"], e["reason"]) for e in skips] == [("train_steps", "disabled")]
    assert not _events(led, "program_analysis")
    assert os.environ.get("VIDEOP2P_OBS_NO_ANALYSIS") is None


@pytest.mark.parametrize("module", ["run_videop2p", "run_tuning"])
@pytest.mark.parametrize("flag", ["--no_program_analysis", "--trace_analysis"])
def test_cli_parses_the_ported_flags(module, flag, monkeypatch):
    """Each flag reaches ``main`` with JAX's meaning: the module's
    ``__main__`` block run with ``load_config`` and ``main`` stubbed."""
    import importlib
    import sys

    mod = importlib.import_module(f"videop2p_tpu_torch.cli.{module}")
    seen = {}
    monkeypatch.setattr(sys, "argv", [module, "--config", "unused.yaml", flag])
    src = open(mod.__file__).read()
    block = src[src.index('if __name__ == "__main__":'):]
    exec(compile(block, mod.__file__, "exec"),
         {**vars(mod), "__name__": "__main__", "load_config": lambda path: {},
          "main": lambda **kw: seen.update(kw)})
    assert seen["program_analysis"] is (flag != "--no_program_analysis")
    assert seen["trace_analysis"] is (flag == "--trace_analysis")


@pytest.mark.parametrize("module", ["run_videop2p", "run_tuning"])
def test_device_telemetry_still_refused(module, monkeypatch):
    """``--device_telemetry`` is ported (it probes the replicas of a
    ``--mesh`` run): the flag reaches ``main``, as ``--mesh`` does; the
    module's ``__main__`` block run with ``load_config`` and ``main``
    stubbed. (The name dates from when the flag was refused.)"""
    import importlib
    import sys

    mod = importlib.import_module(f"videop2p_tpu_torch.cli.{module}")
    seen = {}
    monkeypatch.setattr(sys, "argv", [module, "--config", "unused.yaml", "--device_telemetry",
                                      "--mesh", "1,2,1"])
    src = open(mod.__file__).read()
    block = src[src.index('if __name__ == "__main__":'):]
    exec(compile(block, mod.__file__, "exec"),
         {**vars(mod), "__name__": "__main__", "load_config": lambda path: {},
          "main": lambda **kw: seen.update(kw)})
    assert seen["device_telemetry"] is True and seen["mesh"] == "1,2,1"


@pytest.mark.parametrize("module", ["run_videop2p", "run_tuning"])
def test_main_refuses_device_telemetry(module, tmp_path, capsys):
    """Without a mesh there are no replicas to probe: ``main`` says the
    flag is ignored (JAX's note) and runs; its ledger, which the flag
    opens, records the flag and no probe."""
    import importlib

    from videop2p_tpu_torch.obs.ledger import read_ledger

    mod = importlib.import_module(f"videop2p_tpu_torch.cli.{module}")
    if module == "run_tuning":
        out = mod.main(**_tune_cfg(tmp_path, steps=1), device="cpu", tiny=True,
                       device_telemetry=True)
        led = os.path.join(out, "run_ledger.jsonl")
    else:
        res = mod.main(**dict(RABBIT, pretrained_model_path=str(tmp_path / "ckpt"), tiny=True,
                              video_len=2, num_ddim_steps=1, fast=True, device="cpu",
                              frames=__import__("numpy").zeros((2, 16, 16, 3), "uint8"),
                              save_gifs=False), device_telemetry=True)
        led = res["ledger"]
    assert "--device_telemetry needs --mesh" in capsys.readouterr().out
    events = read_ledger(led)
    assert events[0]["device_telemetry"] is True
    assert not [e for e in events if e["event"] in ("device_telemetry", "divergence",
                                                   "comm_analysis")]


def test_cli_end_to_end_with_both_flags(tmp_path, monkeypatch):
    """``python -m videop2p_tpu_torch.cli.run_videop2p`` with
    ``--trace_analysis`` writes both kinds of event."""
    led = str(tmp_path / "led.jsonl")
    argv = ["--config", _config(tmp_path), "--device", "cpu", "--tiny", "--fast", "--steps",
            "2", "--no_reuse_inversion", "--ledger", led, "--trace_analysis"]
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        _run_cli("videop2p_tpu_torch.cli.run_videop2p", argv, monkeypatch)
    assert [e["program"] for e in _events(led, "program_analysis")] == ["cached_invert_edit"]
    assert [e["name"] for e in _events(led, "trace_analysis")] == ["cached_invert_edit"]
