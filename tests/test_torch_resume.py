"""Preemption and resume of the port's Stage-1 CLI (tiny models on the CPU):
a run stopped at a chunk boundary resumes from "latest" to the bytes of an
uninterrupted run (bf16 on float32 weights, checkpointed blocks, with and
without gradient accumulation), refuses another seed, installs and
restores its signal handlers; the "latest" rule against JAX's; the options
the port does not have raise.

All checks are exact: exported bytes, paths and messages.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

import tests.test_torch_parity  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_cli_tuning import REPO, _cfg


def _weights(top):
    with open(os.path.join(top, "unet", "diffusion_pytorch_model.safetensors"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("accumulate", [1, 2])
def test_preempted_run_resumes_bit_for_bit(tmp_path, monkeypatch, accumulate):
    """A run preempted at its first chunk boundary (bf16, checkpointed
    blocks) writes a checkpoint there and no pipeline; resumed from "latest"
    it exports the same bytes as an uninterrupted run. With gradient
    accumulation over 2 steps the checkpoint falls between the two halves
    of an update (step 3 of 6)."""
    from videop2p_tpu_torch.cli import run_tuning
    from videop2p_tpu_torch.train import latest_checkpoint

    over = dict(validation_steps=0, checkpointing_steps=0, log_every=0,
                validation_data={"prompts": [], "use_inv_latent": False},
                gradient_checkpointing=True, mixed_precision="bf16",
                gradient_accumulation_steps=accumulate, device="cpu",
                max_train_steps=3 * accumulate, steps_per_call=accumulate + 1)
    event = threading.Event()
    event.set()
    monkeypatch.setattr(run_tuning, "_PREEMPT_EVENT", event)
    with pytest.warns(UserWarning):
        out = run_tuning.main(**_cfg(tmp_path, "interrupted", **over))
    first = accumulate + 1
    assert latest_checkpoint(out).endswith(f"checkpoint-{first}")
    assert not os.path.isfile(os.path.join(out, "model_index.json"))
    monkeypatch.setattr(run_tuning, "_PREEMPT_EVENT", threading.Event())
    with pytest.warns(UserWarning):
        resumed = run_tuning.main(**_cfg(tmp_path, "interrupted", **over),
                                  resume_from_checkpoint="latest")
    assert resumed == out
    with pytest.warns(UserWarning):
        straight = run_tuning.main(**_cfg(tmp_path, "straight", **over))
    assert _weights(resumed) == _weights(straight)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == list(range(1, 3 * accumulate + 1))


def test_resume_refuses_another_seed(tmp_path, monkeypatch):
    from videop2p_tpu_torch.cli import run_tuning

    over = dict(validation_steps=0, validation_data={"prompts": [], "use_inv_latent": False},
                device="cpu", max_train_steps=2)
    with pytest.warns(UserWarning):
        run_tuning.main(**_cfg(tmp_path, "a", **over))
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="seeded 0"):
        run_tuning.main(**_cfg(tmp_path, "a", **dict(over, seed=1, max_train_steps=4)),
                        resume_from_checkpoint="latest")


def test_preempt_handlers_are_installed_and_restored():
    import signal

    from videop2p_tpu_torch.cli import run_tuning as rt

    assert not rt._PREEMPT_EVENT.is_set()
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    restore = rt._install_preempt_handlers()
    try:
        assert signal.getsignal(signal.SIGTERM) is rt._preempt_handler
        assert signal.getsignal(signal.SIGINT) is rt._preempt_handler
        signal.raise_signal(signal.SIGTERM)
        assert rt._PREEMPT_EVENT.is_set()
    finally:
        rt._PREEMPT_EVENT.clear()
        restore()
    assert {s: signal.getsignal(s) for s in before} == before


@pytest.mark.parametrize("listing", [[], ["checkpoint-2"], ["checkpoint-2", "checkpoint-10",
                                                          "checkpoint-9"],
                                     ["checkpoint-x", "checkpoint-3", "checkpoint-03a",
                                      "samples", "checkpoint-"]], ids=str)
def test_latest_checkpoint_matches_jax(tmp_path, listing):
    from videop2p_tpu.train import latest_checkpoint as jax_latest

    from videop2p_tpu_torch.train import latest_checkpoint

    for name in listing:
        os.makedirs(tmp_path / name)
    assert latest_checkpoint(str(tmp_path)) == jax_latest(str(tmp_path))
    assert latest_checkpoint(str(tmp_path / "absent")) is None


def test_unported_options_raise(tmp_path):
    from videop2p_tpu_torch.cli import run_tuning

    # a mesh is ported (item 13): in one process a 2-rank mesh raises and
    # names torchrun, which launches its ranks
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        run_tuning.main(**_cfg(tmp_path, "mesh"), mesh="1,2,1", device="cpu")
    # through the CLI: a config's mesh (consistency distillation, which this
    # test refused before it was ported, is tests/test_torch_distill.py's)
    cfg = tmp_path / "tune.yaml"
    cfg.write_text("pretrained_model_path: x\noutput_dir: y\ntrain_data: {}\n"
                   "validation_data: {}\nmesh: '1,2,1'\n")
    proc = subprocess.run([sys.executable, "-m", "videop2p_tpu_torch.cli.run_tuning",
                           "--config", str(cfg), "--distill_steps", "1", "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torchrun" in proc.stderr
