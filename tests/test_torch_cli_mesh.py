"""The run CLIs on a mesh of processes: ``torchrun --standalone
--nproc_per_node 2 -m videop2p_tpu_torch.cli.run_videop2p --tiny --device
cpu --fast --mesh 1,2,1`` (gloo) and its ``run_tuning`` counterpart against
their single-process runs, their ledgers (``comm_analysis``,
``device_telemetry`` with divergence 0.0, ``host_phase``) rendered by the
port's report and JAX's ``tools/ledger_summary.py``, and the mesh's loud
failures (a mesh that is not the world, dp ≠ 1, sp not dividing the
frames).

The edit is compared on the report sidecar's frames (the decoded videos
as uint8, one level of rounding apart at most: the sharded run sums in
another order, ~1e-5 in the latents); Stage 1 on the exported weights.
The comparisons and the ledger checks are ``tools/mesh_compare.py``'s,
which runs the same on GPUs at SD-1.5 width.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# without the analysis' kill switch, which JAX's CLI leaves set in a test
# process that ran it: the mesh runs' ledgers must hold comm_analysis
ENV = {k: v for k, v in os.environ.items() if k != "VIDEOP2P_OBS_NO_ANALYSIS"}
ENV["OMP_NUM_THREADS"] = "1"
TIMEOUT = 300


def _yaml(path, data):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return str(path)


def _run(argv, nproc=None):
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 f"--nproc_per_node={nproc}"] if nproc else [sys.executable])
    proc = subprocess.run(launcher + argv, cwd=REPO, capture_output=True, text=True,
                          timeout=TIMEOUT, env=ENV)
    return proc


def _edit_config(tmp, name):
    return _yaml(tmp / f"{name}.yaml", dict(
        pretrained_model_path=str(tmp / name / "ckpt"), image_path="./data/rabbit",
        prompt="a rabbit is jumping on the grass",
        prompts=["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"],
        save_name="origami", is_word_swap=False, blend_word=["rabbit", "rabbit"],
        eq_params={"words": ["origami"], "values": [2]}, cross_replace_steps=0.4,
        self_replace_steps=0.5, video_len=4))


@pytest.fixture(scope="module")
def edit_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("edit_mesh")
    common = ["--tiny", "--device", "cpu", "--fast", "--steps", "2", "--quality", "--report"]
    single = _run(["-m", "videop2p_tpu_torch.cli.run_videop2p", "--config",
                   _edit_config(tmp, "single"), *common,
                   "--ledger", str(tmp / "single.jsonl")])
    mesh = _run(["-m", "videop2p_tpu_torch.cli.run_videop2p", "--config",
                 _edit_config(tmp, "mesh"), *common, "--mesh", "1,2,1", "--device_telemetry",
                 "--ledger", str(tmp / "mesh.jsonl")], nproc=2)
    return tmp, single, mesh


def _sidecar(tmp, name):
    import glob

    (path,) = glob.glob(str(tmp / name / "**" / "obs_sidecar_*.npz"), recursive=True)
    return np.load(path)


def test_run_videop2p_on_two_ranks_matches_one(edit_runs):
    tmp, single, mesh = edit_runs
    assert single.returncode == 0, single.stderr[-3000:]
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    from videop2p_tpu_torch.tools.mesh_compare import frame_levels

    assert "[mesh] data=1 frames=2 tensor=1" in mesh.stdout
    assert frame_levels(_sidecar(tmp, "single"), _sidecar(tmp, "mesh")) <= 1
    # rank 0 wrote the GIFs, the report and the sidecar; rank 1 only its ledger
    assert len(list((tmp / "mesh").rglob("*.gif"))) == 2
    assert len(list((tmp / "mesh").rglob("obs_sidecar_*.npz"))) == 1
    assert os.path.exists(tmp / "mesh.rank1.jsonl")


def test_run_videop2p_mesh_ledger(edit_runs, capsys):
    """The mesh run's ledger (rank 0's): a ``comm_analysis`` of the cached
    edit (the ring's sends, the frame-0 broadcasts, the pooled statistics'
    all-reduces, the K/V gathers), the probe's ``device_telemetry`` with
    divergence 0.0 over 2 devices, both ranks' ``host_phase`` records; the
    port's report and JAX's ``ledger_summary`` render them."""
    import importlib.util

    from videop2p_tpu_torch.obs.ledger import read_ledger

    from videop2p_tpu_torch.tools.mesh_compare import mesh_ledger

    tmp, _, mesh = edit_runs
    assert mesh.returncode == 0, mesh.stderr[-3000:]
    events = read_ledger(str(tmp / "mesh.jsonl"))
    rec, failures = mesh_ledger(events, 2)
    assert not failures
    # the probe compares replicas over tensor only: at tp = 1 no axis
    assert rec["divergence_axes"] == [] and rec["host_phase_ranks"] == [0, 1]
    assert any(e["event"] == "phase" and e["name"] == "mesh_setup" for e in events)
    (comm,) = [e for e in events if e["event"] == "comm_analysis"]
    assert comm["program"] == "cached_invert_edit" and comm["num_partitions"] == 2
    for kind in ("collective-permute", "collective-broadcast", "all-reduce", "all-gather"):
        assert comm["per_kind"][kind]["count"] > 0, kind
    (dev,) = [e for e in events if e["event"] == "device_telemetry"]
    assert dev["devices"] == 2 and dev["divergence_max"] == 0.0
    hp = {e["process_index"] for e in events if e["event"] == "host_phase"}
    assert hp == {0, 1}
    (report,) = list((tmp / "mesh").rglob("report_*.html"))
    assert "Distributed / communication" in report.read_text()
    spec = importlib.util.spec_from_file_location(
        "ledger_summary_under_cli_mesh", os.path.join(REPO, "tools", "ledger_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["ledger_summary.py", str(tmp / "mesh.jsonl")]) == 0
    out = capsys.readouterr().out
    assert "collectives" in out and "divergence max 0.0" in out
    assert "per-host phase skew" in out


def _tune_config(tmp, name):
    return _yaml(tmp / f"{name}.yaml", dict(
        pretrained_model_path=str(tmp / "no_checkpoint"), output_dir=str(tmp / name / "out"),
        train_data={"video_path": "./data/rabbit", "prompt": "a rabbit is jumping",
                    "n_sample_frames": 4, "width": 16, "height": 16},
        validation_data={"prompts": ["a cat is jumping"], "num_inv_steps": 2,
                         "num_inference_steps": 2},
        max_train_steps=3, checkpointing_steps=2, validation_steps=3, log_every=1,
        steps_per_call=1, seed=1, mixed_precision="no", gradient_checkpointing=False,
        learning_rate=1e-3))


def test_run_tuning_on_two_ranks_matches_one(tmp_path):
    """Stage 1 on 2 ranks (frames split): the exported UNet equals the
    single-process export within 1e-5 after 3 steps at lr 1e-3, the
    logged losses agree, rank 0 alone wrote the export and the metrics,
    and ``--device_telemetry`` records the tuned parameters' divergence:
    0.0."""
    from safetensors.numpy import load_file

    from videop2p_tpu_torch.obs.ledger import read_ledger

    argv = ["-m", "videop2p_tpu_torch.cli.run_tuning", "--tiny", "--device", "cpu"]
    single = _run([*argv, "--config", _tune_config(tmp_path, "single")])
    mesh = _run([*argv, "--config", _tune_config(tmp_path, "mesh"), "--mesh", "1,2,1",
                 "--device_telemetry", "--ledger", str(tmp_path / "tune.jsonl")], nproc=2)
    assert single.returncode == 0, single.stderr[-3000:]
    assert mesh.returncode == 0, mesh.stderr[-3000:]

    def export(name):
        (path,) = list((tmp_path / name).rglob("diffusion_pytorch_model.safetensors"))
        return load_file(str(path))

    a, b = export("single"), export("mesh")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, err_msg=k)

    def losses(name):
        (path,) = list((tmp_path / name).rglob("metrics.jsonl"))
        return [json.loads(line)["train_loss"] for line in open(path)]

    np.testing.assert_allclose(losses("mesh"), losses("single"), rtol=1e-5)
    from videop2p_tpu_torch.tools.mesh_compare import mesh_ledger

    events = read_ledger(str(tmp_path / "tune.jsonl"))
    (div,) = [e for e in events if e["event"] == "divergence"]
    assert div["value"] == 0.0 and div["axes"] == ["frames"]
    assert any(e["event"] == "comm_analysis" and e["program"] == "train_steps" for e in events)
    rec, failures = mesh_ledger(events, 2)
    assert not failures and rec["divergence_axes"] == ["frames"]
    assert rec["host_phase_ranks"] == [0, 1]


def test_mesh_failures_are_loud(tmp_path):
    """A mesh that is not the world raises and names torchrun; dp ≠ 1, an
    sp that does not divide the frames and ``--attn_maps`` over split
    frames (records per rank, not gathered) raise before anything runs."""
    import numpy as np

    from videop2p_tpu_torch.cli.run_videop2p import main

    frames = np.zeros((4, 16, 16, 3), np.uint8)
    kw = dict(pretrained_model_path=str(tmp_path / "ck"), image_path="unused",
              prompt="a rabbit", prompts=["a rabbit", "a cat"], save_name="x",
              is_word_swap=True, video_len=4, fast=True, device="cpu", tiny=True,
              num_ddim_steps=1, frames=frames, save_gifs=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        main(**kw, mesh="1,2,1")
    with pytest.raises(ValueError, match="dp=2"):
        main(**kw, mesh="2,1,1")
    with pytest.raises(ValueError, match="sp axis 3 must divide video_len 4"):
        main(**kw, mesh="1,3,1")
    with pytest.raises(ValueError, match="quant_mode"):
        main(**kw, mesh="1,2,1", quant_mode="w8")
    with pytest.raises(ValueError, match="attn_maps on mesh '1,2,1'"):
        main(**kw, mesh="1,2,1", attn_maps=True)
    proc = _run(["-m", "videop2p_tpu_torch.cli.run_videop2p", "--config",
                 _edit_config(tmp_path, "mismatch"), "--tiny", "--device", "cpu", "--fast",
                 "--steps", "1", "--mesh", "1,1,1"], nproc=2)
    assert proc.returncode != 0
    assert "needs 1 processes, have 2" in proc.stderr
