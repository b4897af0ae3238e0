"""The run CLIs on a mesh of GPUs against their one-GPU runs.

Runs ``cli.run_videop2p`` (the cached fast edit, and official mode with
``--official``) and, with ``--tune``, ``cli.run_tuning``, once as a plain
process and once per mesh spec under ``torchrun --standalone
--nproc_per_node <dp·sp·tp>``, on the rabbit-jump clip at SD-1.5 width
(seeded random weights), and compares what each run wrote:

  * the edit: the report sidecar's uint8 frames of the reconstruction and
    the edit (``--quality``), their largest difference in levels of 255;
  * Stage 1: the exported UNet's weights;
  * each mesh run's ledger (:func:`mesh_ledger`): its ``comm_analysis``
    (collectives by kind), its ``device_telemetry`` or Stage 1's
    ``divergence`` event (0.0 over the replicated axes; the edit's probe
    compares replicas over ``tensor`` only, so at tp = 1 it has no axis
    and no gate, which the record's ``divergence_axes`` shows), and every
    rank's ``host_phase`` records;
  * the seconds of the main phases (``cached_invert_edit``,
    ``null_text_optimization`` + ``edit_sample``) from the ledgers' phase
    events, Stage 1's ``train_steps`` calls (synchronised: ``--latency``),
    the mesh runs' ``mesh_setup`` (the process group's communicators,
    built there before any program runs), and each process's wall.

Every number is a process's first call. Exits 1 when a gate fails (frames
more than ``--max_levels`` apart, a divergence other than 0.0, a rank's
phases missing, the weights further than ``--max_weight_diff``), else
prints one JSON summary as its last line and writes it to ``--out``.

    python -m videop2p_tpu_torch.tools.mesh_compare --specs 1,2,1 1,4,1 1,2,2 \\
        --official --tune --out mesh_compare.json    # 4 GPUs
    python -m videop2p_tpu_torch.tools.mesh_compare --device cpu --tiny \\
        --specs 1,2,1 1,1,2                                        # gloo
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

# the clip and the edit of configs/rabbit-jump-p2p.yaml, 8 frames
EDIT = dict(
    image_path="./data/rabbit", prompt="a rabbit is jumping on the grass",
    prompts=["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"],
    blend_word=["rabbit", "rabbit"], eq_params={"words": ["origami"], "values": [2]},
    save_name="origami", is_word_swap=False, video_len=8)
# configs/rabbit-jump-tune.yaml at 8 frames, cut to a few steps in float32
TUNE = dict(
    train_data={"video_path": "./data/rabbit", "prompt": "a rabbit is jumping on the grass",
                "n_sample_frames": 8, "width": 512, "height": 512},
    validation_data={"prompts": ["a origami rabbit is jumping on the grass"],
                     "num_inv_steps": 2, "num_inference_steps": 2},
    learning_rate=3e-5, checkpointing_steps=0, log_every=1, steps_per_call=1,
    mixed_precision="no", gradient_checkpointing=True, seed=33)
# the phases whose seconds each mode reports
MAIN_PHASES = {"fast": ("cached_invert_edit",),
               "official": ("null_text_optimization", "edit_sample")}
# the report sidecar's uint8 frames an edit is compared on
FRAME_KEYS = ("frames/recon", "frames/edit")


def _nproc(spec: Optional[str]) -> int:
    return int(np.prod([int(t) for t in spec.split(",")])) if spec else 1


def _launch(module: str, argv: List[str], spec: Optional[str], env) -> tuple:
    """Run ``python -m module argv`` (under torchrun on a mesh); returns
    (wall seconds, the completed process)."""
    cmd = [sys.executable]
    if spec:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={_nproc(spec)}"]
    cmd += ["-m", module, *argv] + (["--mesh", spec, "--device_telemetry"] if spec else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
    return time.perf_counter() - t0, proc


def _config(path: str, cfg: dict) -> str:
    """A config file the CLIs' ``--config`` reads (YAML: PyYAML reads a
    JSON ``3e-05`` as a string)."""
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return path


def _events(path: str) -> List[dict]:
    from videop2p_tpu_torch.obs.ledger import read_ledger

    return read_ledger(path)


def _phase_seconds(events: List[dict], names) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in events:
        if e.get("event") == "phase" and e.get("name") in names:
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["seconds"])
    return out


def frame_levels(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]) -> int:
    """The largest difference, in levels of 255, between two report
    sidecars' frames of the reconstruction and the edit."""
    return max(int(np.abs(a[k].astype(np.int16) - b[k].astype(np.int16)).max())
               for k in FRAME_KEYS)


def mesh_ledger(events: List[dict], nproc: int) -> Tuple[dict, List[str]]:
    """A mesh run's ledger checks: a ``comm_analysis``, a divergence of 0.0
    wherever the probe had an axis to compare over, every rank's
    ``host_phase`` records. Returns (the record, the failures)."""
    failures: List[str] = []
    comm = {e["program"]: {k: v["count"] for k, v in e["per_kind"].items()}
            for e in events if e.get("event") == "comm_analysis"}
    divs = ([(e["divergence_max"], e.get("divergence_axes", []))
             for e in events if e.get("event") == "device_telemetry"]
            + [(e["value"], e.get("axes", [])) for e in events
               if e.get("event") == "divergence"])
    ranks = sorted({e["process_index"] for e in events if e.get("event") == "host_phase"})
    if not comm:
        failures.append("no comm_analysis")
    if not divs or any(d != 0.0 for d, _ in divs):
        failures.append(f"divergence {divs}")
    if nproc > 1 and ranks != list(range(nproc)):
        failures.append(f"host_phase ranks {ranks}")
    return {"comm": comm, "divergence": [d for d, _ in divs],
            "divergence_axes": sorted({a for _, axes in divs for a in axes}),
            "host_phase_ranks": ranks}, failures


def _checked_ledger(events: List[dict], spec: str, failures: List[str], label: str) -> dict:
    rec, bad = mesh_ledger(events, _nproc(spec))
    failures += [f"{label}: {f}" for f in bad]
    return rec


def edit_compare(mode: str, specs: List[str], args, tmp: str, env, failures) -> dict:
    common = ["--steps", str(args.steps), "--device", args.device, "--quality",
              "--mixed_precision", args.mixed_precision]
    if mode == "fast":
        common.append("--fast")
    else:
        common += ["--num_inner_steps", str(args.inner_steps)]
    if args.tiny:
        common.append("--tiny")
    runs = {}
    for spec in [None] + specs:
        name = f"{mode}_{spec or 'one'}".replace(",", "")
        cfg = _config(os.path.join(tmp, f"{name}.yaml"),
                      {**EDIT, "pretrained_model_path": os.path.join(tmp, name, "ckpt")})
        led = os.path.join(tmp, f"{name}.jsonl")
        wall, proc = _launch("videop2p_tpu_torch.cli.run_videop2p",
                             ["--config", cfg, "--ledger", led, *common], spec, env)
        if proc.returncode != 0:
            failures.append(f"{name}: exit {proc.returncode}: {proc.stderr[-1500:]}")
            continue
        events = _events(led)
        (sidecar,) = glob.glob(os.path.join(tmp, name, "**", "obs_sidecar_*.npz"),
                               recursive=True)
        frames = np.load(sidecar)
        rec = {"wall_s": wall,
               "phases": _phase_seconds(events, MAIN_PHASES[mode] + ("mesh_setup",)),
               "frames": {k: frames[k] for k in FRAME_KEYS}}
        if spec:
            rec.update(_checked_ledger(events, spec, failures, name))
        runs[spec or "one"] = rec
    out = {}
    base = runs.get("one")
    for spec, rec in runs.items():
        row = {k: rec[k] for k in ("wall_s", "phases") if k in rec}
        if spec != "one" and base is not None:
            levels = frame_levels(rec["frames"], base["frames"])
            row.update(max_levels=levels, comm=rec["comm"], divergence=rec["divergence"],
                       divergence_axes=rec["divergence_axes"],
                       host_phase_ranks=rec["host_phase_ranks"])
            if levels > args.max_levels:
                failures.append(f"{mode} {spec}: frames {levels} levels from one GPU's")
        out[spec] = row
        print(f"[mesh_compare] {mode} {spec}: " + json.dumps(row), flush=True)
    return out


def tune_compare(specs: List[str], args, tmp: str, env, failures) -> dict:
    from safetensors.numpy import load_file

    # --latency: each train_steps call synchronised and timed (program_call)
    common = ["--device", args.device, "--latency"] + (["--tiny"] if args.tiny else [])
    runs = {}
    for spec in [None] + specs:
        name = f"tune_{spec or 'one'}".replace(",", "")
        # the tiny VAE downsamples 2×: 16² frames keep the tiny UNet's 8²
        size = 16 if args.tiny else 512
        cfg = _config(os.path.join(tmp, f"{name}.yaml"), {
            **TUNE, "train_data": dict(TUNE["train_data"], width=size, height=size),
            "pretrained_model_path": os.path.join(tmp, "no_checkpoint"),
            "output_dir": os.path.join(tmp, name, "out"),
            "max_train_steps": args.tune_steps, "validation_steps": args.tune_steps})
        led = os.path.join(tmp, f"{name}.jsonl")
        wall, proc = _launch("videop2p_tpu_torch.cli.run_tuning",
                             ["--config", cfg, "--ledger", led, *common], spec, env)
        if proc.returncode != 0:
            failures.append(f"{name}: exit {proc.returncode}: {proc.stderr[-1500:]}")
            continue
        events = _events(led)
        (weights,) = glob.glob(os.path.join(tmp, name, "**",
                                            "diffusion_pytorch_model.safetensors"),
                               recursive=True)
        steps_s = sum(e["blocked_s"] for e in events
                      if e.get("event") == "program_call" and e["program"] == "train_steps")
        rec = {"wall_s": wall,
               "phases": {"train_steps": round(steps_s, 4),
                          **_phase_seconds(events, ("mesh_setup",))},
               "weights": load_file(weights)}
        if spec:
            rec.update(_checked_ledger(events, spec, failures, name))
        runs[spec or "one"] = rec
    out = {}
    base = runs.get("one")
    for spec, rec in runs.items():
        row = {k: rec[k] for k in ("wall_s", "phases")}
        if spec != "one" and base is not None:
            diff = max(float(np.abs(rec["weights"][k] - base["weights"][k]).max())
                       for k in base["weights"])
            row.update(max_weight_diff=diff, comm=rec["comm"], divergence=rec["divergence"],
                       divergence_axes=rec["divergence_axes"],
                       host_phase_ranks=rec["host_phase_ranks"])
            if not diff <= args.max_weight_diff:
                failures.append(f"tune {spec}: weights {diff} from one GPU's")
        out[spec] = row
        print(f"[mesh_compare] tune {spec}: " + json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--specs", nargs="+", required=True, help="mesh specs dp,sp,tp")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--tiny", action="store_true", help="the tiny models (a CPU rehearsal)")
    ap.add_argument("--steps", type=int, default=2, help="DDIM steps of the edits")
    ap.add_argument("--inner_steps", type=int, default=2, help="official mode's null-text")
    ap.add_argument("--mixed_precision", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--official", action="store_true", help="also official mode")
    ap.add_argument("--tune", action="store_true", help="also Stage 1")
    ap.add_argument("--tune_steps", type=int, default=2)
    ap.add_argument("--max_levels", type=int, default=2,
                    help="largest difference of a mesh run's uint8 frames from one GPU's")
    ap.add_argument("--max_weight_diff", type=float, default=1e-5,
                    help="largest difference of a mesh run's exported weights")
    ap.add_argument("--out", default=None, help="also write the summary to this JSON file")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        need = max(_nproc(s) for s in args.specs)
        if torch.cuda.device_count() < need:
            print(f"mesh_compare: {need} GPUs needed, {torch.cuda.device_count()} found",
                  file=sys.stderr)
            return 2
    env = {**os.environ, "OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")}
    tmp = tempfile.mkdtemp(prefix="mesh_compare_")
    failures: List[str] = []
    summary = {"specs": args.specs, "device": args.device, "steps": args.steps}
    try:
        summary["fast"] = edit_compare("fast", args.specs, args, tmp, env, failures)
        if args.official:
            summary["official"] = edit_compare("official", args.specs, args, tmp, env, failures)
        if args.tune:
            summary["tune"] = tune_compare(args.specs, args, tmp, env, failures)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if args.device == "cuda":
        import torch

        summary["card"] = torch.cuda.get_device_name(0)
        summary["cards"] = torch.cuda.device_count()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**summary, "failures": failures}, fh, indent=1)
    if failures:
        print("mesh_compare failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
