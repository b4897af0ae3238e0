"""Stage-1 one-shot tuning entry point (port of ``videop2p_tpu/cli/run_tuning.py``).

Flow: the clip's frames (``data/dataset.py:SingleVideoDataset``) → VAE
encode (a posterior draw) → CLIP text encode → ``max_train_steps`` steps of
``train/tuner.py:train_steps`` on the trainable subset (``attn1.to_q``,
``attn2.to_q``, ``attn_temp``), with the UNet's frame attention "chunked"
(as JAX's tuner builds it: no frame-attention kernel on this path) and its
GroupNorm the CUDA kernel. Every ``log_every`` steps the losses go to
``metrics.jsonl``; every ``checkpointing_steps`` a checkpoint to
``checkpoint-<step>``; every ``validation_steps`` (and at the end) a DDIM
inversion of the training latents (``inv_latents/ddim_latent-<step>.npy``)
and one sample per validation prompt from it (``samples/sample-<step>.gif``).
It ends by writing the diffusers-layout pipeline directory that
``run_videop2p`` loads, its scheduler the DDIM one with ``steps_offset`` 1.

``mixed_precision`` "bf16" (or "fp16", which maps to it) keeps float32
weights and Adam state and runs the UNet in bfloat16
(``UNet3DConditionModel.compute_dtype``), as JAX's flax layers do: the
export is float32, the frozen weights leave bit for bit as they came.
``gradient_checkpointing`` recomputes each UNet block in the backward.
``output_dir`` takes the Stage-1 suffix of the dependent-noise flags.
SIGTERM or SIGINT stops the run at the next chunk boundary with a
checkpoint; ``resume_from_checkpoint: latest`` continues it with the same
bits as an uninterrupted run. ``steps_per_call`` sets how often the losses
are synchronised to the host.

``--distill_steps N`` then consistency-distils the few-step student from
the tuned pipeline (:func:`run_distillation`, ``train/distill.py``) and
writes it to ``<pipeline_dir>/student/checkpoint-<N>``.

Observability (JAX's flags): ``--ledger PATH`` (default
``<output_dir>/run_ledger.jsonl`` when any of these is set) records the
phases, every logged step as a ``metric`` event, a memory snapshot after
training and the ``artifacts`` event (``preempted`` on a stop);
``--telemetry`` adds each step's pre-clip gradient norm to the logged
metrics; ``--latency`` times the ``train_steps`` program (each chunk of
steps) into ``execute_timing`` events; ``--incidents DIR`` writes a crash
bundle under DIR; ``--trace_analysis`` captures one chunk of steps after
the first with ``torch.profiler`` and mines it into a ``trace_analysis``
event (``obs/trace.py``). With a ledger the first ``train_steps`` call (and
``distill_steps``') is analysed into a ``program_analysis`` event
(``obs/introspect.py``); ``--no_program_analysis`` skips that.
``--attn_maps``, ``--quality`` and ``--report`` are the edit's flags: parsed
and ignored here, as JAX's CLI does.

``--mesh dp,sp,tp`` (or the config's ``mesh``) tunes on a mesh of GPUs,
one process each under ``torchrun`` (``cli/common.py:setup_mesh``; dp must
be 1): each rank trains on its frames, every rank draws the whole clip's
noise and the same timesteps, the loss is the global mean and the
replicated parameters' gradients are summed over ``frames``; the clip
norm counts a tensor-split parameter once. Rank 0 writes the metrics,
the checkpoints, the validation samples and the export from the gathered
weights; a resumed run loads the whole checkpoint and cuts it to each
rank's shards. ``--device_telemetry`` (with ``--mesh``) records the tuned
parameters' cross-replica divergence (a ``divergence`` event, 0.0).

Run:  python -m videop2p_tpu_torch.cli.run_tuning --config configs/rabbit-jump-tune.yaml
      [--dependent --decay_rate 0.3 --window_size 4 --ar_sample ...] [--device cpu] [--tiny]
      [--distill_steps N [--distill_grid 50] [--distill_lr 1e-4] [--distill_ema 0.95]
                         [--distill_boundary_weight 1.0]]
      [--ledger L] [--telemetry] [--latency] [--incidents DIR] [--trace_analysis]
      [--no_program_analysis]
      torchrun --standalone --nproc_per_node 2 -m videop2p_tpu_torch.cli.run_tuning \
          --config configs/rabbit-jump-tune.yaml --mesh 1,2,1 [--device_telemetry]

then Stage 2 on its output:
      python -m videop2p_tpu_torch.cli.run_videop2p --config configs/rabbit-jump-p2p.yaml
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import signal
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from videop2p_tpu_torch.cli.common import (
    add_dependent_args,
    add_obs_args,
    build_models,
    dependent_suffix,
    deterministic_convolutions,
    encode_prompts,
    load_config,
    make_run_ledger,
    setup_mesh,
    validate_mesh,
)
from videop2p_tpu_torch.core import DDIMScheduler, DDPMScheduler, DependentNoiseSampler
from videop2p_tpu_torch.data import SingleVideoDataset
from videop2p_tpu_torch.models.pipeline_io import save_pipeline
from videop2p_tpu_torch.models.vae import decode_video, encode_video
from videop2p_tpu_torch.obs.ledger import instrumented_program
from videop2p_tpu_torch.parallel.distributed import process_index
from videop2p_tpu_torch.pipelines.inversion import ddim_inversion
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn
from videop2p_tpu_torch.train import (
    DEFAULT_TRAINABLE,
    DistillConfig,
    DistillState,
    TrainState,
    TuneConfig,
    init_time_head,
    latest_checkpoint,
    make_distill_optimizer,
    make_lr_schedule,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    save_student,
    train_steps,
)
# the loop under another name: run_distillation's argument is distill_steps
from videop2p_tpu_torch.train import distill_steps as distill_loop
from videop2p_tpu_torch.utils.metrics import MetricsLogger
from videop2p_tpu_torch.utils.profiling import phase_timer
from videop2p_tpu_torch.utils.video_io import save_videos_grid

__all__ = ["main", "run_distillation", "deterministic_convolutions"]

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16, "no": torch.float32}
# the scheduler config of the exported pipeline (JAX's, and the reference's)
_EXPORT_SCHEDULER_CONFIG = {
    "_class_name": "DDIMScheduler",
    "beta_start": 0.00085,
    "beta_end": 0.012,
    "beta_schedule": "scaled_linear",
    "clip_sample": False,
    "set_alpha_to_one": False,
    "steps_offset": 1,
}

# SIGTERM/SIGINT set this event; the training loop checks it at every chunk
# boundary, saves a checkpoint there and returns
_PREEMPT_EVENT = threading.Event()


def _preempt_handler(signum, frame):
    _PREEMPT_EVENT.set()


def _install_preempt_handlers():
    """Install SIGTERM/SIGINT → checkpoint-then-exit; returns a callable that
    restores the previous handlers. Off the main thread (where the signal
    API refuses) it installs nothing."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _preempt_handler)
        except (ValueError, OSError):
            continue

    def _restore():
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                continue
    return _restore


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(
    pretrained_model_path: str,
    output_dir: str,
    train_data: Dict[str, Any],
    validation_data: Dict[str, Any],
    learning_rate: float = 3e-5,
    train_batch_size: int = 1,
    max_train_steps: int = 500,
    checkpointing_steps: int = 1000,
    validation_steps: int = 500,
    trainable_modules=DEFAULT_TRAINABLE,
    seed: Optional[int] = None,
    mixed_precision: str = "fp16",
    gradient_checkpointing: bool = True,
    gradient_accumulation_steps: int = 1,
    max_grad_norm: float = 1.0,
    lr_scheduler: str = "constant",
    lr_warmup_steps: int = 0,
    scale_lr: bool = False,
    resume_from_checkpoint: Optional[str] = None,
    prediction_type: str = "epsilon",
    dependent: bool = False,
    num_frames: int = 60,
    decay_rate: float = 0.1,
    window_size: int = 60,
    ar_sample: bool = False,
    ar_coeff: float = 0.1,
    eta: float = 0.0,
    dependent_weights: float = 0.0,
    mesh: Optional[str] = None,
    tiny: bool = False,
    log_every: int = 50,
    steps_per_call: int = 100,
    device: str = "cuda",
    telemetry: bool = False,
    ledger: Optional[str] = None,
    latency: bool = False,
    incidents: Optional[str] = None,
    device_telemetry: bool = False,
    trace_analysis: bool = False,
    program_analysis: bool = True,
    **unused,
) -> str:
    """Tune, validate and export; returns the (suffixed) output directory.
    The arguments are the YAML config's keys, the dependent flags and the
    observability flags of the module docstring; ``mesh`` ("dp,sp,tp") the
    mesh run (the ring schedule and the row-parallel reduction from
    ``VIDEOP2P_RING_VARIANT`` / ``VIDEOP2P_TP_COLLECTIVES``, as in JAX)."""
    del unused
    if mixed_precision not in _DTYPES:
        raise ValueError(f"mixed_precision must be one of {sorted(_DTYPES)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    # full float32 products and convolutions (cuDNN's default for float32
    # convolutions is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mesh:
        from videop2p_tpu_torch.parallel.distributed import initialize_distributed

        # one process per GPU: this one's is cuda:LOCAL_RANK
        initialize_distributed(device.type)
        validate_mesh(mesh, int(train_data.get("n_sample_frames", 8)))
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    n_frames = int(train_data.get("n_sample_frames", 8))
    output_dir = output_dir + dependent_suffix(
        dependent=dependent, decay_rate=decay_rate, window_size=window_size,
        ar_sample=ar_sample, ar_coeff=ar_coeff, eta=eta,
        dependent_weights=dependent_weights)
    os.makedirs(output_dir, exist_ok=True)
    if process_index() == 0:
        with open(os.path.join(output_dir, "config.json"), "w") as f:
            json.dump({k: v for k, v in locals().items()
                       if isinstance(v, (str, int, float, bool, dict, list, tuple,
                                         type(None)))},
                      f, indent=2, default=str)
    rank0 = process_index() == 0
    run_seed = seed if seed is not None else 0
    # one JSONL record of the run: phases, metrics, execute timing, memory
    run_ledger = make_run_ledger(
        os.path.join(output_dir, "run_ledger.jsonl"), ledger=ledger,
        meta={"cli": "run_tuning", "max_train_steps": max_train_steps},
        telemetry=telemetry, latency=latency, trace_analysis=trace_analysis,
        program_analysis=program_analysis, incidents=incidents, device=device,
        device_telemetry=device_telemetry)

    sampler = None
    if dependent:
        if num_frames != n_frames:
            print(f"[tune] dependent sampler uses the clip's {n_frames} frames "
                  f"(--num_frames {num_frames} would not match the data)")
        sampler = DependentNoiseSampler.create(
            num_frames=n_frames, decay_rate=decay_rate,
            window_size=min(window_size, n_frames), ar_sample=ar_sample,
            ar_coeff=ar_coeff, device=device)

    # float32 weights (what the optimizer updates and the export writes);
    # the UNet computes in `dtype`, the frozen VAE and text encoder run in it
    dtype = _DTYPES[mixed_precision]
    bundle = build_models(pretrained_model_path, dtype=torch.float32, device=device,
                          frame_attention="chunked",
                          gradient_checkpointing=gradient_checkpointing, tiny=tiny,
                          seed=run_seed)
    if dtype != torch.float32:
        bundle.unet.compute_dtype = dtype
        bundle.vae.to(dtype)
        bundle.text_encoder.to(dtype)

    latents, text_emb = _clip_latents(bundle, train_data, run_seed, device)
    device_mesh = None
    if mesh:
        # the mesh before the train state, so that it holds the shards
        with phase_timer("mesh_setup"):
            device_mesh = setup_mesh(bundle, mesh, n_frames, device=device)
        # the posterior draw is one draw over the whole clip: every rank
        # encodes it and keeps its frames
        from videop2p_tpu_torch.parallel.mesh import frames_slice

        latents = frames_slice(latents)
    elif device_telemetry:
        print("[tune] --device_telemetry needs --mesh — single-device runs have no "
              "replicas to compare; flag ignored")

    tune_cfg = TuneConfig(
        learning_rate=learning_rate, scale_lr=scale_lr, lr_scheduler=lr_scheduler,
        lr_warmup_steps=lr_warmup_steps, max_train_steps=max_train_steps,
        max_grad_norm=max_grad_norm,
        gradient_accumulation_steps=gradient_accumulation_steps,
        trainable_modules=tuple(trainable_modules), train_batch_size=train_batch_size)
    tx = make_optimizer(tune_cfg)
    state = TrainState.create(bundle.unet, tx, tune_cfg.trainable_modules)

    first_step = 0
    if resume_from_checkpoint:
        path = (latest_checkpoint(output_dir) if resume_from_checkpoint == "latest"
                else resume_from_checkpoint)
        if path:
            restore_checkpoint(path, state, seed=run_seed,
                               shard=_tensor_cut(bundle.unet, device_mesh))
            first_step = state.step
            print(f"[tune] resumed from {path} at step {first_step}")

    noise_sched = DDPMScheduler.create_sd(prediction_type=prediction_type)
    unet_fn = make_unet_fn(bundle.unet)
    lr_schedule = make_lr_schedule(tune_cfg)
    # with a run ledger every logged step is also a `metric` event; on a
    # mesh rank 0 writes the metrics
    metrics = (MetricsLogger(output_dir, ledger=run_ledger) if rank0
               else _NoMetrics())
    losses: List[torch.Tensor] = []
    grad_norms: List[torch.Tensor] = []  # telemetry: each step's pre-clip norm

    def flush_losses(next_step: int) -> float:
        # one device → host copy for the whole buffer
        flat = torch.cat(losses).cpu().numpy()
        gflat = torch.cat(grad_norms).cpu().numpy() if grad_norms else None
        start = next_step - len(flat)
        for j, value in enumerate(flat):
            rec = {"train_loss": float(value), "lr": float(lr_schedule(start + j))}
            if gflat is not None:
                rec["grad_norm"] = float(gflat[j])
            metrics.log(start + j + 1, rec)
        losses.clear()
        grad_norms.clear()
        return float(flat[-1])

    steps_fn = instrumented_program(
        train_steps, program="train_steps",
        sync=(lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None)

    # chunks end on every log / checkpoint / validation boundary; a cadence
    # of 0 or None turns that feature off. steps_per_call is rounded down to
    # divide the cadences' gcd where that keeps a chunk of at least 5 steps
    # (JAX's rule: there, each chunk length is a compiled program)
    steps_per_call = max(int(steps_per_call), 1)
    cadences = [p for p in (log_every, checkpointing_steps, validation_steps) if p and p > 0]
    g = math.gcd(*cadences) if cadences else steps_per_call
    if g > 1 and steps_per_call % g and g % steps_per_call:
        aligned = math.gcd(steps_per_call, g)
        if aligned >= 5:
            print(f"[tune] steps_per_call {steps_per_call} → {aligned} to align with "
                  f"the log/checkpoint/validation cadences (gcd {g})")
            steps_per_call = aligned
    t0 = time.perf_counter()
    i = first_step
    preempted = False
    traced_chunk = False
    restore_signals = _install_preempt_handlers()
    try:
        with deterministic_convolutions():
            while i < max_train_steps:
                nxt = min([max_train_steps, i + steps_per_call]
                          + [(i // p + 1) * p for p in cadences])
                # --trace_analysis: ONE chunk after the first (which holds
                # the first call's kernel builds and analysis), as JAX's CLI
                do_trace = trace_analysis and not traced_chunk and i > first_step
                chunk_ctx = contextlib.nullcontext()
                if do_trace:
                    from videop2p_tpu_torch.obs.trace import trace_window

                    chunk_ctx = trace_window("train_steps_chunk", device=device)
                with chunk_ctx:
                    out = steps_fn(unet_fn, tx, state, noise_sched, latents, text_emb,
                                   run_seed, num_steps=nxt - i, dependent_sampler=sampler,
                                   telemetry=telemetry)
                    if do_trace:
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)  # the capture holds the work
                        traced_chunk = True
                losses.append(out[1])
                if telemetry:
                    grad_norms.append(out[2])
                first_chunk = i == first_step
                i = nxt
                if _agreed(_PREEMPT_EVENT.is_set(), device_mesh, device):
                    preempted = True
                    break
                if (log_every and i % log_every == 0) or i == max_train_steps or first_chunk:
                    loss = flush_losses(i)
                    rate = (i - first_step) / max(time.perf_counter() - t0, 1e-9)
                    print(f"[tune] step {i}/{max_train_steps} loss={loss:.4f} "
                          f"({rate:.2f} it/s)")
                if checkpointing_steps and i % checkpointing_steps == 0:
                    _save_checkpoint(output_dir, state, i, run_seed, bundle.unet, device_mesh)
                if (validation_steps and i % validation_steps == 0) or i == max_train_steps:
                    _validate(bundle, latents, validation_data, output_dir, i,
                              dependent_weights=dependent_weights, sampler=sampler,
                              text_emb=text_emb, seed=run_seed, device=device,
                              rank0=rank0)
    finally:
        restore_signals()
    if preempted:
        if losses:
            flush_losses(i)
        metrics.close()
        ckpt_path = _save_checkpoint(output_dir, state, i, run_seed, bundle.unet, device_mesh)
        print(f"[tune] preempted at step {i}: checkpoint saved to {ckpt_path}; "
              "resume with resume_from_checkpoint: latest")
        if run_ledger is not None:
            run_ledger.event("preempted", step=i, checkpoint=ckpt_path)
            _close_ledger(run_ledger, device_mesh)
        return output_dir
    if losses:
        flush_losses(max_train_steps)
    metrics.close()
    if run_ledger is not None:
        run_ledger.memory_snapshot(note="after_training")
    if device_telemetry and device_mesh is not None:
        _param_divergence(state, device_mesh, run_ledger)

    with phase_timer("export"):
        params = state.params
        if device_mesh is not None:
            # the tensor-split weights gathered; rank 0 writes them
            from videop2p_tpu_torch.parallel.mesh import gather_state_dict

            params = {k: v for k, v in gather_state_dict(bundle.unet, device_mesh).items()
                      if k in params}
        nbytes = (save_pipeline(output_dir, bundle.unet.config, params,
                                source_dir=bundle.source_dir,
                                scheduler_config=dict(_EXPORT_SCHEDULER_CONFIG))
                  if rank0 else 0)
        _barrier(device_mesh)
    if rank0:
        print(f"[tune] saved pipeline to {output_dir} (unet {nbytes} bytes)")
    if run_ledger is not None:
        run_ledger.event("artifacts", pipeline_dir=output_dir)
        _close_ledger(run_ledger, device_mesh)
        print(f"[tune] run ledger: {run_ledger.path}")
    if device_mesh is not None:
        from videop2p_tpu_torch.parallel.mesh import set_active_mesh

        set_active_mesh(None)
    return output_dir


def _close_ledger(run_ledger, device_mesh=None) -> None:
    """Close the run ledger (on a mesh, after rank 0 has gathered every
    rank's ``host_phase`` records) and, the run having ended without a
    crash, the incident plane it armed (its hooks restored)."""
    if device_mesh is not None:
        from videop2p_tpu_torch.parallel.distributed import gather_host_phases

        gather_host_phases(run_ledger)
    run_ledger.close()
    if getattr(run_ledger, "incidents", None) is not None:
        run_ledger.incidents.close()


class _NoMetrics:
    """The metrics log of a rank other than 0 on a mesh: nothing written."""

    def log(self, step: int, scalars) -> None:
        pass

    def close(self) -> None:
        pass


def _barrier(device_mesh) -> None:
    if device_mesh is not None and device_mesh.size > 1:
        torch.distributed.barrier()


def _agreed(flag: bool, device_mesh, device: torch.device) -> bool:
    """``flag`` on any rank of the mesh (a stop every rank takes at the same
    chunk boundary, where a signal may reach the ranks at different
    times); ``flag`` itself without one."""
    if device_mesh is None or device_mesh.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


def _tensor_dims(unet) -> Dict[str, int]:
    return getattr(unet, "tp_shard_dims", None) or {}


def _tensor_cut(unet, device_mesh):
    """``shard(name, whole)`` for :func:`restore_checkpoint` on a
    tensor-parallel mesh, else None."""
    dims = _tensor_dims(unet)
    if device_mesh is None or not dims:
        return None
    from videop2p_tpu_torch.parallel.mesh import shard_tensor

    return lambda name, t: shard_tensor(name, t, dims.get(name), device_mesh)


def _save_checkpoint(output_dir: str, state: TrainState, step: int, seed: int, unet,
                     device_mesh) -> str:
    """``save_checkpoint`` of the whole state: on a mesh the tensor-split
    trainable parameters and their optimizer state are gathered and rank 0
    writes them (the other ranks wait for it)."""
    if device_mesh is None:
        return save_checkpoint(output_dir, state, step, seed=seed)
    from videop2p_tpu_torch.parallel.mesh import gather_tensor

    dims = _tensor_dims(unet)
    names = list(state.trainable)

    def whole(name, t):
        return gather_tensor(name, t, dims.get(name), device_mesh)

    full = SimpleNamespace(
        step=state.step, trainable={n: whole(n, p) for n, p in state.trainable.items()},
        opt_state={k: [whole(n, t) for n, t in zip(names, v)] if isinstance(v, list) else v
                   for k, v in state.opt_state.items()})
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    if device_mesh.rank == 0:
        path = save_checkpoint(output_dir, full, step, seed=seed)
    _barrier(device_mesh)
    return path


def _param_divergence(state: TrainState, device_mesh, run_ledger) -> None:
    """The tuned parameters' cross-replica divergence (JAX's
    ``tree_replica_divergence`` after training): every parameter over
    ``frames``, the unsplit ones over ``tensor`` too; a ``divergence``
    event, which must read 0.0."""
    from videop2p_tpu_torch.obs.comm import tree_replica_divergence
    from videop2p_tpu_torch.parallel.mesh import AXIS_FRAMES, AXIS_TENSOR

    params = state.params
    whole = [p for p in params.values() if getattr(p, "tp_shard_dim", None) is None]
    div = float(max(tree_replica_divergence(list(params.values()), device_mesh,
                                            axes=(AXIS_FRAMES,)),
                    tree_replica_divergence(whole, device_mesh, axes=(AXIS_TENSOR,))))
    axes = [a for a in (AXIS_FRAMES, AXIS_TENSOR) if device_mesh.shape[a] > 1]
    if run_ledger is not None:
        run_ledger.divergence("params_after_training", div, axes=axes)
    print(f"[tune] param replica divergence over {tuple(axes)}: {div}"
          + ("  <-- REPLICAS DIVERGED (must be 0.0)" if div else ""))


def _clip_latents(bundle, train_data: Dict[str, Any], seed: int,
                  device: torch.device) -> tuple:
    """The clip's latents (1, F, h, w, C), a VAE posterior draw seeded from
    ``seed``, and its prompt's text embedding (1, 77, D)."""
    ds = SingleVideoDataset(
        video_path=train_data["video_path"],
        prompt=train_data["prompt"],
        width=int(train_data.get("width", 512)),
        height=int(train_data.get("height", 512)),
        n_sample_frames=int(train_data.get("n_sample_frames", 8)),
        sample_start_idx=int(train_data.get("sample_start_idx", 0)),
        sample_frame_rate=int(train_data.get("sample_frame_rate", 1)),
    )
    video = torch.as_tensor(ds.load(), device=device)[None]  # (1, F, H, W, 3)
    with torch.no_grad(), phase_timer("vae_encode"):
        latents = encode_video(bundle.vae, video,
                               torch.Generator(device).manual_seed(seed)).float()
        _sync(device)
    return latents, encode_prompts(bundle, [train_data["prompt"]], device)


def run_distillation(pipeline_dir: str, train_data: Dict[str, Any], *, distill_steps: int,
                     distill_grid: int = 50, distill_lr: float = 1e-4,
                     distill_ema: float = 0.95, distill_boundary_weight: float = 1.0,
                     tiny: bool = False, seed: Optional[int] = None,
                     steps_per_call: int = 50, device: str = "cuda") -> str:
    """Consistency-distil the few-step student from a tuned pipeline
    directory (``train/distill.py``): its UNet, built in float32 with
    "chunked" frame attention as Stage 1's, is the frozen teacher; the
    student trains Stage 1's parameter subset and the time head on the
    latents of the clip Stage 1 tuned on. Prints a ``[distill] step i/N``
    line every ``steps_per_call`` steps and at the end, and writes the
    student to ``<pipeline_dir>/student/checkpoint-<distill_steps>``;
    returns that path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run_seed = seed if seed is not None else 0
    bundle = build_models(pipeline_dir, dtype=torch.float32, device=device,
                          frame_attention="chunked", tiny=tiny, seed=run_seed)
    latents, text_emb = _clip_latents(bundle, train_data, run_seed, device)
    cfg = DistillConfig(learning_rate=distill_lr, max_train_steps=distill_steps,
                        distill_grid=distill_grid, ema_decay=distill_ema,
                        boundary_weight=distill_boundary_weight)
    tx = make_distill_optimizer(cfg)
    head = init_time_head(torch.Generator(device).manual_seed(run_seed + 1),
                          bundle.unet.config)
    state = DistillState.create(bundle.unet, head, tx, cfg.trainable_modules)
    sched = bundle.make_scheduler()  # the DDIM grid the student walks
    unet_fn = make_unet_fn(bundle.unet)
    steps_per_call = max(int(steps_per_call), 1)
    i, t0 = 0, time.perf_counter()
    # the JAX package's label: with an active ledger and execute timing on,
    # each chunk of steps lands in its `distill_steps` reservoir
    steps_fn = instrumented_program(
        distill_loop, program="distill_steps",
        sync=(lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None)
    with deterministic_convolutions(), phase_timer("distill_steps"):
        while i < distill_steps:
            n = min(steps_per_call, distill_steps - i)
            _, losses = steps_fn(unet_fn, tx, state, sched, latents, text_emb, run_seed,
                                 num_steps=n, cfg=cfg)
            i += n
            loss = float(losses[-1])
            rate = i / max(time.perf_counter() - t0, 1e-9)
            print(f"[distill] step {i}/{distill_steps} loss={loss:.5f} ({rate:.2f} it/s)")
    path = save_student(os.path.join(pipeline_dir, "student"), state, i)
    print(f"[distill] saved student to {path}")
    return path


def _validate(bundle, latents: torch.Tensor, validation_data: Dict[str, Any],
              output_dir: str, step: int, *, dependent_weights: float,
              sampler: Optional[DependentNoiseSampler], text_emb: torch.Tensor,
              seed: int, device: torch.device, rank0: bool = True) -> None:
    """DDIM-invert the training latents (blended with the dependent noise at
    ``dependent_weights``), store x_T, sample each validation prompt from it
    at ``guidance_scale`` and write the samples as one GIF grid (skipped
    with a note without imageio). On a mesh every rank runs the loops on
    its frames; rank 0 gathers, decodes and writes."""
    from videop2p_tpu_torch.parallel.mesh import frames_draw, gather_frames

    num_inv = int(validation_data.get("num_inv_steps", 50))
    num_steps = int(validation_data.get("num_inference_steps", 50))
    guidance = float(validation_data.get("guidance_scale", 12.5))
    use_inv = bool(validation_data.get("use_inv_latent", True))
    prompts: List[str] = list(validation_data.get("prompts", []))
    unet_fn = make_unet_fn(bundle.unet)
    sched = DDIMScheduler.create_sd()
    gen = torch.Generator(device).manual_seed(seed)
    videos = []
    with torch.no_grad(), phase_timer("validation"):
        if use_inv:
            x_t = ddim_inversion(
                unet_fn, sched, latents, text_emb, num_inference_steps=num_inv,
                dependent_weight=dependent_weights,
                dependent_sampler=sampler if dependent_weights > 0 else None,
                generator=gen)[-1]
            whole = gather_frames(x_t)
            if rank0:
                inv_dir = os.path.join(output_dir, "inv_latents")
                os.makedirs(inv_dir, exist_ok=True)
                np.save(os.path.join(inv_dir, f"ddim_latent-{step}.npy"), whole.cpu().numpy())
        else:
            x_t = frames_draw(lambda shape: torch.randn(shape, generator=gen, device=device),
                              latents.shape)
        uncond = encode_prompts(bundle, [""], device)[0]
        for prompt in prompts:
            cond = encode_prompts(bundle, [prompt], device)
            out = gather_frames(edit_sample(unet_fn, sched, x_t, cond, uncond,
                                            num_inference_steps=num_steps,
                                            guidance_scale=guidance))
            if rank0:
                frames = decode_video(bundle.vae, out).float()
                videos.append(((frames + 1) / 2)[0].cpu().numpy())
        _sync(device)
    if videos:
        try:
            import imageio  # noqa: F401
        except ImportError:
            print("[tune] imageio is not installed: no validation GIF written")
            return
        path = save_videos_grid(np.stack(videos),
                                os.path.join(output_dir, "samples", f"sample-{step}.gif"))
        print(f"[tune] validation saved {path}")


if __name__ == "__main__":
    from videop2p_tpu_torch.parallel.distributed import leave_process_group

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--tiny", action="store_true",
                        help="random-init tiny models (smoke mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions of the kernels")
    parser.add_argument("--distill_steps", type=int, default=0,
                        help="consistency-distillation steps to run after tuning "
                             "(0 = off); writes the few-step student to "
                             "<output_dir>/student/checkpoint-<N>")
    parser.add_argument("--distill_grid", type=int, default=50,
                        help="DDIM grid points the self-consistency chain walks "
                             "(the teacher's solver discretization)")
    parser.add_argument("--distill_lr", type=float, default=1e-4,
                        help="student learning rate (Stage 1's clipped AdamW)")
    parser.add_argument("--distill_ema", type=float, default=0.95,
                        help="EMA decay of the consistency target network")
    parser.add_argument("--distill_boundary_weight", type=float, default=1.0,
                        help="loss weight of the boundary term (final grid point, "
                             "target = the data x0)")
    add_dependent_args(parser)
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh dp,sp,tp of GPUs, one process each under torchrun "
                             "(frames/tensor sharding); dp must be 1")
    add_obs_args(parser)
    args = parser.parse_args()
    if args.attn_maps or args.quality or args.report:
        # the edit's flags (run_videop2p), as JAX's CLI says
        print("[tune] --attn_maps/--quality/--report are Stage-2 (editing) "
              "knobs — ignored by the tuning CLI")
    cfg = load_config(args.config)
    cfg["mesh"] = args.mesh or cfg.get("mesh")
    out_dir = main(**cfg, tiny=args.tiny, device=args.device,
                   dependent=args.dependent, num_frames=args.num_frames,
                   decay_rate=args.decay_rate, window_size=args.window_size,
                   ar_sample=args.ar_sample, ar_coeff=args.ar_coeff, eta=args.eta,
                   dependent_weights=args.dependent_weights, telemetry=args.telemetry,
                   ledger=args.ledger, latency=args.latency, incidents=args.incidents,
                   trace_analysis=args.trace_analysis,
                   program_analysis=not args.no_program_analysis,
                   device_telemetry=args.device_telemetry)
    distill = None
    # distillation runs on one GPU: after a mesh run, rank 0's
    if args.distill_steps > 0 and process_index() == 0:
        def distill():
            run_distillation(out_dir, cfg["train_data"], distill_steps=args.distill_steps,
                             distill_grid=args.distill_grid, distill_lr=args.distill_lr,
                             distill_ema=args.distill_ema,
                             distill_boundary_weight=args.distill_boundary_weight,
                             tiny=args.tiny, seed=cfg.get("seed"), device=args.device)
    # the run's ledger is closed: a rank of a torchrun world leaves in step
    # (rank 0 after its distillation, which enters no collective)
    leave_process_group(0, then=distill)
