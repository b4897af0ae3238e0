"""Stage-2 attention-controlled editing entry point (port of
``videop2p_tpu/cli/run_videop2p.py``).

Flow: frames → VAE encode (posterior mean) → CLIP text encode → controller
(refine or replace, equalizer, LocalBlend) → the edit → VAE decode → GIFs of
the reconstruction and the edit. The edit is one of:

  * official mode (no ``--fast``, the reference's): a DDIM inversion, then
    ``pipelines/sampling.py:official_edit``'s two phases as two programs:
    null-text optimization of the source stream's uncond embedding (a
    backward through the UNet per inner step, ``official_null_text``),
    then the controlled edit in the full CFG layout with those embeddings
    injected (``edit_sample``);
  * ``--fast``: by default the cached-source fast edit
    (``pipelines/fast.py:cached_fast_edit``): a DDIM inversion that
    captures the source stream's attention maps, then a controlled edit of
    the P − 1 edit streams only, stream 0 replaying the inversion exactly.
    It falls back to the live-source edit, as the JAX package does, when
    the captured maps exceed the budget;
  * ``--fast --live_source``: a plain DDIM inversion, then one
    ``edit_sample`` with the fast CFG layout (the source stream in the
    batch, replaying its cond-only prediction). ``--eta`` > 0 (stochastic
    DDIM steps, noise seeded from ``--seed``) takes this path in fast mode,
    as the JAX CLI does: the cached replay is deterministic.

The fork's dependent noise (``--dependent_p2p`` with ``--decay_rate``,
``--window_size``, ``--ar_sample``, ``--ar_coeff``, ``--dependent_weights``):
every UNet prediction of the inversion and of null-text optimization is
blended with frame-correlated noise (``core/noise.py``), and with ``--eta``
> 0 the edit's step noise is drawn from the same sampler.

The rest of the JAX CLI's Stage-2 surface: ``--null_text_mode hybrid``;
``--multi`` (per-frame conditioning); persisted inversion reuse, on by
default (``--no_reuse_inversion``, ``--inv_store``): a repeat run of the
same clip skips the inversion and, in official mode, null-text
optimization; ``--quant_mode w8|w8a8`` (int8 UNet weights, ``--fast``
only); ``--reuse_schedule uniform:K|custom:<p0,...>`` (deep-feature reuse
in the cached fast edit).

``--mesh dp,sp,tp`` runs the edit on a mesh of GPUs, one process each,
launched by ``torchrun --nproc_per_node N`` (NCCL; gloo with ``--device
cpu``): frames over ``sp`` (each rank encodes, inverts and edits its own
frames; the ring on the temporal sites, the frame-0 K/V broadcast, the
frame-pooled GroupNorm statistics all-reduced, null-text's loss and
gradient global), heads over ``tp`` (``cli/common.py:setup_mesh``); dp
must be 1. Rank 0 gathers the latents, decodes them and writes the GIFs,
the report and the run's ledger (each other rank writes
``<ledger stem>.rank<r>.jsonl``); persisted inversion reuse is off, and
``--attn_maps`` needs sp = 1 (its records are per rank, not gathered).
``VIDEOP2P_RING_VARIANT`` / ``VIDEOP2P_TP_COLLECTIVES`` pick the ring
schedule and the row-parallel reduction, as in JAX.

Observability (JAX's flags): ``--ledger PATH`` writes the run ledger
(``obs/ledger.py``; default ``<results>/run_ledger.jsonl`` when any of these
flags is set): phases, program calls, memory snapshots after each stage and
the ``artifacts`` event; ``--telemetry`` adds the loops' per-step
statistics as ``telemetry`` events; ``--latency`` each program's execute
timing (``cached_invert_edit``, ``ddim_inversion``, ``null_text_fused``,
``edit_sample``); ``--attn_maps`` the attention records (``attn_maps``
events, arrays in ``obs_sidecar_<name>.npz``); ``--quality`` the
edit-quality record; ``--report`` the HTML report; ``--incidents DIR`` a
crash bundle under DIR; ``--trace_analysis`` a ``torch.profiler`` capture of
the main program (``cached_invert_edit`` in the cached fast edit, else
``edit_sample``) mined into a ``trace_analysis`` event
(``obs/trace.py``); ``--device_telemetry`` (with ``--mesh``) the edit's
per-device statistics and cross-replica divergence (``device_telemetry``
events, ``obs/comm.py``). With a ledger, each program's first call is
analysed into a ``program_analysis`` event (``obs/introspect.py``), and
on a mesh its collectives into a ``comm_analysis`` event;
``--no_program_analysis`` skips that. A repeat run on one ledger gets
``regression_verdicts`` against the previous run (``obs/history.py``).
None of them changes an output bit.

The checkpoint is ``pretrained_model_path`` with the Stage-1 suffix of the
dependent settings appended (``cli/common.py:resolve_pipeline_dir``): a
diffusers-layout directory loads (``models/pipeline_io.py``), its scheduler
from its ``scheduler_config.json``; without one the models are random-init
at SD-1.5 width (seeded), with a warning. The GIFs go to
``<checkpoint>/results_dp{dependent_p2p}``, as the JAX CLI writes them.

Run:  python -m videop2p_tpu_torch.cli.run_videop2p \\
          --config configs/rabbit-jump-p2p.yaml [--fast [--live_source]] \\
          [--dependent --dependent_p2p --decay_rate 0.3 --window_size 4 \\
           --ar_sample --ar_coeff 0.1 --dependent_weights 0.2] [--eta 0.1] \\
          [--null_text_mode hybrid] [--multi] [--no_reuse_inversion] \\
          [--inv_store DIR] [--quant_mode w8] [--reuse_schedule uniform:2] \\
          [--ledger L] [--telemetry] [--attn_maps] [--quality] [--report] \\
          [--latency] [--incidents DIR] [--trace_analysis] [--no_program_analysis]
      torchrun --standalone --nproc_per_node 2 -m videop2p_tpu_torch.cli.run_videop2p \
          --config configs/rabbit-jump-p2p.yaml --fast --mesh 1,2,1 [--device_telemetry]

The run is on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from videop2p_tpu_torch.cli.common import (
    ModelBundle,
    add_dependent_args,
    add_obs_args,
    build_models,
    deterministic_convolutions,
    encode_prompts,
    load_config,
    make_run_ledger,
    parse_mesh,
    resolve_pipeline_dir,
    setup_mesh,
    validate_mesh,
)
from videop2p_tpu_torch.control.controllers import make_controller
from videop2p_tpu_torch.models.convert import quantize_unet_params
from videop2p_tpu_torch.models.quant import QUANT_MODES, validate_quant_mode
from videop2p_tpu_torch.core.noise import DependentNoiseSampler
from videop2p_tpu_torch.data.dataset import load_frame_sequence
from videop2p_tpu_torch.models.vae import decode_video, encode_video
from videop2p_tpu_torch.obs.ledger import instrumented_program
from videop2p_tpu_torch.obs.telemetry import (
    decode_null_text_stats,
    decode_step_stats,
    summarize_step_stats,
    to_host,
)
from videop2p_tpu_torch.pipelines.cached import capture_windows
from videop2p_tpu_torch.pipelines.fast import (
    CACHED_MAPS_BUDGET_GB,
    cached_fast_edit,
    capture_bytes,
    choose_cached_maps,
)
from videop2p_tpu_torch.pipelines.inversion import (
    NULL_TEXT_MODES,
    NULL_TEXT_PRECISIONS,
    check_null_text_options,
    ddim_inversion,
)
from videop2p_tpu_torch.pipelines.reuse import validate_reuse_schedule
from videop2p_tpu_torch.pipelines.sampling import (
    edit_sample,
    make_unet_fn,
    official_null_text,
)
from videop2p_tpu_torch.serve.store import load_persisted_inversion, save_persisted_inversion
from videop2p_tpu_torch.utils.inv_cache import content_fingerprint, inversion_cache_key
from videop2p_tpu_torch.utils.profiling import last_phase_seconds, phase_timer
from videop2p_tpu_torch.utils.video_io import save_video_gif

__all__ = ["ModelBundle", "build_models", "encode_prompts", "main",
           "inversion_determinants", "null_text_tag", "NUM_DDIM_STEPS",
           "GUIDANCE_SCALE", "MASK_TH"]

NUM_DDIM_STEPS = 50
GUIDANCE_SCALE = 7.5
MASK_TH = (0.3, 0.3)
_DTYPES = {"fp32": torch.float32, "no": torch.float32,
           "bf16": torch.bfloat16, "fp16": torch.bfloat16}


@contextlib.contextmanager
def _phase(name: str, timings: Dict[str, float], device: torch.device,
           peaks: Dict[str, float], **count):
    """Wall time of a phase, synchronised with the card on both ends, and on
    the card the phase's peak allocated memory in GiB. The phase goes
    through ``utils/profiling.py:phase_timer``, so an active run ledger
    records it (``count``: its ``count`` and ``unit``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with phase_timer(name, verbose=False, **count):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    if device.type == "cuda":
        peaks[name] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    timings[name] = last_phase_seconds(name)


def _word_token_records(prompts: Sequence[str], tokenizer) -> list:
    """Word → token positions of every prompt (the report's key for the
    per-word heatmaps)."""
    from videop2p_tpu_torch.control.schedules import get_word_inds

    recs, seen = [], set()
    for pi, text in enumerate(prompts):
        for word in text.split():
            if (pi, word) in seen:
                continue
            seen.add((pi, word))
            toks = get_word_inds(text, word, tokenizer)
            if len(toks):
                recs.append({"prompt": pi, "word": word, "tokens": [int(t) for t in toks]})
    return recs


def _ledger_device_stats(run_ledger, program: str, dev_stats, probe) -> None:
    """One loop's device-probe channels → a ``device_telemetry`` event (and
    a console warning when the replicas diverged; the divergence joins the
    zero-noise-floor COMM_RULES gate, ``obs/history.py``)."""
    from videop2p_tpu_torch.obs.comm import summarize_device_stats

    rec = summarize_device_stats(dev_stats, probe.device_ids)
    rec["divergence_axes"] = list(probe.divergence_axes)
    if run_ledger is not None:
        run_ledger.device_telemetry(program, rec)
    div = rec.get("divergence_max", 0.0)
    print(f"[p2p] device telemetry ({program}): {rec.get('devices')} devices, "
          f"divergence_max={div}" + ("  <-- REPLICAS DIVERGED (must be 0.0)" if div else ""))


def _telemetry_record(tel) -> Dict[str, Any]:
    return {"summary": summarize_step_stats(tel), "steps": decode_step_stats(tel)}


def _semantic_obs(run_ledger, *, output_dir: str, save_name: str, suffix: str,
                  prompts: Sequence[str], tokenizer, attn_records: Dict,
                  stream_map: Dict, quality: bool, report: bool, source01: np.ndarray,
                  videos: np.ndarray):
    """After decode (JAX's ``_semantic_obs``): the ``.npz`` sidecar, the
    ``attn_maps`` and ``quality`` events, the regression verdicts against
    the ledger's previous run and the HTML report. Returns ``(report path
    or None, sidecar path)``."""
    from videop2p_tpu_torch.obs.attention import save_obs_sidecar, summarize_attn_record

    sidecar_path = os.path.join(output_dir, f"obs_sidecar_{save_name}{suffix}.npz")
    sidecar: Dict[str, np.ndarray] = {}
    word_recs = _word_token_records(prompts, tokenizer)
    summaries = {}
    for scope, rec in attn_records.items():
        sidecar[f"attn_{scope}/cross_heat"] = np.asarray(rec["cross_heat"])
        for site, curve in sorted(rec.get("entropy", {}).items()):
            sidecar[f"attn_{scope}/entropy/{site}"] = np.asarray(curve)
        for k in ("mask_cov", "mask_heat", "blend_active"):
            if k in rec:
                sidecar[f"attn_{scope}/{k}"] = np.asarray(rec[k])
        summaries[scope] = summarize_attn_record(rec)

    # reference frames for the report's overlays, at most 128 px
    stride = max(1, int(videos.shape[-3]) // 128)

    def to_u8(v):
        return (np.clip(v[:, ::stride, ::stride], 0, 1) * 255).astype(np.uint8)

    sidecar["frames/source"] = to_u8(source01)
    sidecar["frames/recon"] = to_u8(videos[0])
    sidecar["frames/edit"] = to_u8(videos[1])

    quality_summary = None
    if quality:
        from videop2p_tpu_torch.obs.quality import edit_quality_record

        mask = None
        mh = attn_records.get("edit", {}).get("mask_heat")
        if mh is not None:
            mh = np.asarray(mh)  # (T, P, F, rh, rw), source stream first
            if mh.ndim == 5 and mh.shape[1] >= 2:
                m = np.clip(mh[-1, 1], 0.0, 1.0)  # final step, first edit
                F, H, W = videos.shape[1], videos.shape[2], videos.shape[3]
                yi = (np.arange(H) * m.shape[1] // max(H, 1)).clip(0, m.shape[1] - 1)
                xi = (np.arange(W) * m.shape[2] // max(W, 1)).clip(0, m.shape[2] - 1)
                mask = m[:F][:, yi][:, :, xi]
        quality_summary, curves = edit_quality_record(source01, videos[0], videos[1],
                                                      mask=mask)
        for k, v in curves.items():
            sidecar[f"quality/{k}"] = v

    save_obs_sidecar(sidecar_path, sidecar)
    for scope, summary in summaries.items():
        streams = stream_map.get(scope, [])
        run_ledger.event("attn_maps", scope=scope, program=f"attn_{scope}",
                         sidecar=sidecar_path, streams=streams,
                         words=[w for w in word_recs if w["prompt"] in streams], **summary)
    if quality_summary is not None:
        run_ledger.event("quality", program="edit_quality", sidecar=sidecar_path,
                         **quality_summary)
        print("[p2p] quality: " + ", ".join(f"{k}={v}" for k, v in quality_summary.items()))

    # regression verdicts against the ledger's previous run (the file
    # appends across runs); best effort, as JAX's
    try:
        from videop2p_tpu_torch.obs import history
        from videop2p_tpu_torch.obs.ledger import read_ledger

        recs = [history.extract_run(r) for r in history.split_runs(read_ledger(run_ledger.path))]
        if len(recs) >= 2:
            cur = recs[-1]
            base = history.RunHistory(recs[:-1]).baseline_for(cur) or recs[-2]
            res = history.evaluate_rules(base, cur)
            run_ledger.event("regression_verdicts", baseline_run_id=base.get("run_id"), **res)
            if not res["pass"]:
                print(f"[p2p] REGRESSIONS vs run {base.get('run_id')}: "
                      + ", ".join(v["rule"] for v in res["regressions"]))
    except Exception as e:  # noqa: BLE001 — observability never kills a run
        print(f"[p2p] regression verdicts skipped: {e}")

    report_path = None
    if report:
        from videop2p_tpu_torch.obs.report import write_report

        report_path = write_report(
            run_ledger.path, os.path.join(output_dir, f"report_{save_name}{suffix}.html"),
            sidecar_path)
        print(f"[p2p] edit report: {report_path}")
    return report_path, sidecar_path


def _frames_fingerprint(frames) -> str:
    """A content digest of in-memory frames: the clip's identity in the
    inversion key when no path names it."""
    arr = np.ascontiguousarray(np.asarray(frames))
    h = hashlib.sha256(f"{arr.shape}{arr.dtype}".encode())
    h.update(arr.tobytes())
    return "frames:" + h.hexdigest()[:16]


def inversion_determinants(*, image_path: str, prompt: str, steps: int, width: int,
                           video_len: int, dependent_p2p: bool, dependent_weights: float,
                           decay_rate: float, window_size: int, ar_sample: bool,
                           ar_coeff: float, seed: int, checkpoint_dir: str, tiny: bool,
                           mixed_precision: str, frames=None) -> Dict[str, Any]:
    """Everything that determines the inversion products: the JAX CLI's
    determinants (``run_videop2p.py:506-520``), the checkpoint and the clip
    by content, and ``impl="torch"``, so that a port run and a JAX run of
    the same clip never replay each other's floats. In-memory ``frames``
    are fingerprinted by their bytes."""
    return dict(
        image_path=os.path.abspath(image_path), prompt=prompt, steps=steps, width=width,
        video_len=video_len, dependent_p2p=dependent_p2p, dependent_weights=dependent_weights,
        decay_rate=decay_rate, window_size=window_size, ar_sample=ar_sample,
        ar_coeff=ar_coeff, seed=seed, checkpoint=content_fingerprint(checkpoint_dir),
        clip=(content_fingerprint(image_path) if frames is None
              else _frames_fingerprint(frames)),
        tiny=tiny, guidance=GUIDANCE_SCALE, mixed_precision=mixed_precision, impl="torch")


def null_text_tag(num_inner_steps: int, null_text_precision: str, null_text_mode: str) -> str:
    """The persisted null embeddings' name suffix: inner steps, precision
    and mode each give their own entry (JAX's ``run_videop2p.py:579-581``)."""
    return (f"_i{num_inner_steps}" + ("_mixed" if null_text_precision == "mixed" else "")
            + ("" if null_text_mode == "optimize" else f"_{null_text_mode}"))


def main(
    pretrained_model_path: str,
    image_path: str,
    prompt: str,
    prompts: Sequence[str],
    save_name: str,
    is_word_swap: bool,
    eq_params: Optional[Dict] = None,
    blend_word: Optional[Sequence[str]] = None,
    cross_replace_steps: float = 0.2,
    self_replace_steps: float = 0.5,
    video_len: int = 8,
    fast: bool = False,
    live_source: bool = False,
    mixed_precision: str = "fp32",
    device: str = "cuda",
    width: int = 512,
    tiny: bool = False,
    seed: int = 0,
    num_ddim_steps: int = NUM_DDIM_STEPS,
    frames: Optional[np.ndarray] = None,
    bundle: Optional[ModelBundle] = None,
    save_gifs: bool = True,
    num_inner_steps: int = 10,
    null_text_precision: str = "fp32",
    null_text_mode: str = "optimize",
    eta: float = 0.0,
    dependent: bool = False,
    dependent_p2p: bool = False,
    num_frames: int = 60,
    decay_rate: float = 0.1,
    window_size: int = 60,
    ar_sample: bool = False,
    ar_coeff: float = 0.1,
    dependent_weights: float = 0.0,
    multi: bool = False,
    quant_mode: str = "off",
    reuse_schedule: str = "off",
    reuse_inversion: bool = True,
    inv_store: Optional[str] = None,
    mesh: Optional[str] = None,
    telemetry: bool = False,
    ledger: Optional[str] = None,
    attn_maps: bool = False,
    quality: bool = False,
    report: bool = False,
    latency: bool = False,
    incidents: Optional[str] = None,
    device_telemetry: bool = False,
    trace_analysis: bool = False,
    program_analysis: bool = True,
    **unused,
) -> Dict[str, Any]:
    """Run the edit: official mode unless ``fast``; with ``fast`` the
    cached-source edit, or the live-source one with ``live_source``.
    ``frames`` (F, H, W, 3) uint8 replaces loading ``image_path``; ``bundle``
    replaces the models of the checkpoint directory (its modules must
    already be on ``device``; its scheduler config sets the scheduler).
    ``num_inner_steps``, ``null_text_precision`` ("fp32" or "mixed": the
    null-text forwards and backward on a bf16 clone of the UNet) and
    ``null_text_mode`` ("optimize", "amortized", or "hybrid": 3 Adam steps
    an outer step against the recorded trajectory) set official mode's
    null-text optimization.
    ``eta`` > 0 makes the edit's DDIM steps stochastic (in fast mode it
    takes the live-source edit).

    ``multi``: per-frame conditioning, each prompt's embedding repeated over
    the frames. ``quant_mode`` ("off", "w8", "w8a8"; ``--fast`` only: official
    mode differentiates through full-precision weights) quantizes the UNet
    at load (``models/convert.py:quantize_unet_params``; a given ``bundle``'s
    UNet is copied first). ``reuse_schedule`` ("off", "uniform:K",
    "custom:<p0,...>") reuses the deep feature across the cached edit's
    steps (``pipelines/reuse.py``); it needs the cached fast path (``--fast``,
    η = 0, no ``live_source``), and the maps-budget fallback turns it off.

    ``reuse_inversion`` (JAX's default True): the trajectory, and in
    official mode the null-text embeddings, persist under
    ``<results>/inv_cache/<key>`` (or under ``inv_store``, a root shared
    across results directories), keyed by
    :func:`inversion_determinants`; a repeat run of the same clip reuses
    them and skips the inversion and the null-text phase. As in JAX, the
    store is consulted only once the cached-maps decision is final and
    never on the cached fast path, which still saves its trajectory. It is
    off when ``bundle`` is given: a path no longer names the weights.
    ``mesh`` ("dp,sp,tp"): the run on a mesh of processes (the module
    docstring), the process group joined from ``torchrun``'s environment
    (``parallel/distributed.py``); ``VIDEOP2P_RING_VARIANT`` /
    ``VIDEOP2P_TP_COLLECTIVES`` set the ring schedule and the row-parallel
    reduction (``cli/common.py:setup_mesh``). A given ``bundle``'s UNet is
    copied before it is sharded.

    Observability (the module docstring's flags): ``ledger``, ``telemetry``,
    ``attn_maps``, ``quality``, ``report``, ``latency``, ``incidents``,
    ``trace_analysis``; any of them opens the run ledger.
    ``program_analysis=False`` skips the analysis of the programs' first
    calls. ``device_telemetry`` probes each rank's latents and the replicas'
    divergence after every edit step (needs ``mesh``; without one a note
    says it is ignored, as in JAX).

    The dependent noise, as the JAX CLI: a sampler over the clip's
    ``video_len`` frames in windows of ``min(window_size, video_len)``
    (``decay_rate``, ``ar_sample``, ``ar_coeff``) when ``dependent_p2p``, or
    ``dependent`` with ``eta`` > 0; with ``dependent_p2p`` the inversion's
    and null-text's predictions are blended with it at weight
    ``dependent_weights``, and an ``eta`` > 0 edit draws its step noise from
    it. ``num_frames`` is the Stage-1 flag, unused here. The checkpoint
    directory is ``pretrained_model_path`` resolved with those settings'
    suffix (``cli/common.py:resolve_pipeline_dir``). One generator a phase
    (inversion, null-text, edit) on ``device``, seeded from ``seed``.

    Returns the edited latents (stream 0 the source's reconstruction), the
    inversion's ``x_0`` and ``x_t``, the decoded videos (2, F, H, W, 3) in
    [0, 1], the mode run (``"official"``, ``"cached"`` or ``"live"``), the
    cached-maps decision, the null-text record (official mode:
    ``final_loss`` and ``inner_steps`` per outer step, else None, and None
    when the embeddings were reused), which persisted products were reused
    (``{"trajectory", "null_text"}``) and the key, the phase times in
    seconds, each phase's peak memory on the card, the UNet's weight bytes,
    the checkpoint directory, the results directory and the GIF paths
    written, and the run ledger's, the sidecar's and the report's paths
    (None when not written). On a mesh every rank returns the gathered
    latents, ``x_0`` and ``x_t``; the videos and GIFs are rank 0's (None and
    () on the others)."""
    del unused, num_frames
    dp, sp, tp = parse_mesh(mesh)
    if quant_mode != "off" and (sp > 1 or tp > 1):
        raise ValueError(
            f"quant_mode={quant_mode!r} is not supported on a model-parallel mesh: "
            "the quantized weights would need their own sharding rules")
    if attn_maps and sp > 1:
        raise ValueError(
            f"attn_maps on mesh {mesh!r}: with the frames split (sp={sp}) each rank "
            "records only its frames' attention (the ring's temporal sites none), and "
            "the records are not gathered yet; run --attn_maps with sp = 1")
    if mixed_precision not in _DTYPES:
        raise ValueError(f"mixed_precision must be one of {sorted(_DTYPES)}")
    if not fast:
        check_null_text_options(null_text_precision, null_text_mode)
    reuse_schedule = validate_reuse_schedule(reuse_schedule, num_ddim_steps)
    if reuse_schedule != "off" and not (fast and not live_source and eta == 0):
        raise ValueError(
            "reuse_schedule is a cached-fast-path knob: it needs --fast with "
            "eta=0 and the cached source (the deep-feature cache rides the "
            "cached edit)")
    quant_mode = validate_quant_mode(quant_mode)
    if quant_mode != "off" and not fast:
        raise ValueError(
            "quant_mode is an INFERENCE knob: full mode differentiates "
            "through the UNet (null-text optimization) and must see the "
            "full-precision weights — run it with --fast")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass --device cpu to run on the CPU")
    if mesh is not None:
        from videop2p_tpu_torch.parallel.distributed import initialize_distributed

        # one process per GPU: this one's is cuda:LOCAL_RANK
        initialize_distributed(device.type)
        validate_mesh(mesh, video_len)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    from videop2p_tpu_torch.parallel.distributed import process_index

    rank0 = process_index() == 0
    # full float32 products and convolutions (cuDNN's default for float32
    # convolutions is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = _DTYPES[mixed_precision]
    if tiny and width == 512:
        # the tiny VAE downsamples 2x: keep latents at the tiny UNet's 8x8
        width = 16
    pretrained_model_path = resolve_pipeline_dir(
        pretrained_model_path, dependent=dependent, decay_rate=decay_rate,
        window_size=window_size, ar_sample=ar_sample, ar_coeff=ar_coeff, eta=eta,
        dependent_weights=dependent_weights)
    output_dir = os.path.join(pretrained_model_path, f"results_dp{dependent_p2p}")
    suffix = "_fast" if fast else ""
    # one JSONL record of the run: phases, program calls, telemetry, memory
    run_ledger = make_run_ledger(
        os.path.join(output_dir, "run_ledger.jsonl"), ledger=ledger,
        meta={"cli": "run_videop2p", "fast": fast, "save_name": save_name,
              "prompt": prompt, "prompts": list(prompts),
              "null_text_precision": null_text_precision, "null_text_mode": null_text_mode},
        telemetry=telemetry, attn_maps=attn_maps, quality=quality, report=report,
        latency=latency, trace_analysis=trace_analysis, program_analysis=program_analysis,
        incidents=incidents, device=device, device_telemetry=device_telemetry)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else None

    @contextlib.contextmanager
    def maybe_trace(window: str):
        """--trace_analysis: a mined torch.profiler capture of the region
        (obs/trace.py), the card synchronized inside it; nothing otherwise."""
        if not trace_analysis:
            yield
            return
        from videop2p_tpu_torch.obs.trace import trace_window

        with trace_window(window, device=device):
            yield
            if sync is not None:
                sync()

    # {"inversion": record, "edit": record} of what --attn_maps captured
    attn_records: Dict[str, Any] = {}
    sampler = None
    if dependent_p2p or (dependent and eta > 0):
        sampler = DependentNoiseSampler.create(
            num_frames=video_len, decay_rate=decay_rate,
            window_size=min(window_size, video_len), ar_sample=ar_sample,
            ar_coeff=ar_coeff, device=device)
    dep_w = dependent_weights if dependent_p2p else 0.0
    # the walks draw from it only at a weight > 0, the edit only at η > 0
    p2p_sampler = sampler if dependent_p2p else None
    gens = {name: torch.Generator(device).manual_seed(seed + k)
            for k, name in enumerate(("edit", "inversion", "null_text"))}
    timings: Dict[str, float] = {}
    peaks: Dict[str, float] = {}

    # a given bundle is not named by any path: nothing is persisted for it;
    # nor on a mesh, whose ranks would race on one entry (JAX's rule)
    reuse_inversion = reuse_inversion and bundle is None and mesh is None
    if reuse_inversion:
        # before the key, as the JAX CLI: the checkpoint's fingerprint then
        # reads the same on the first run as on a repeat
        os.makedirs(output_dir, exist_ok=True)
    if bundle is None:
        with _phase("build_models", timings, device, peaks):
            bundle = build_models(pretrained_model_path, tiny=tiny, dtype=dtype,
                                  device=device, seed=seed)
            if quant_mode != "off":
                quantize_unet_params(bundle.unet, quant_mode)
    elif quant_mode != "off":
        bundle = dataclasses.replace(
            bundle, unet=quantize_unet_params(copy.deepcopy(bundle.unet), quant_mode))
    elif mesh is not None:
        bundle = dataclasses.replace(bundle, unet=copy.deepcopy(bundle.unet))
    device_mesh = device_probe = None
    if mesh is not None:
        with _phase("mesh_setup", timings, device, peaks):
            device_mesh = setup_mesh(bundle, mesh, video_len, device=device)
    if device_telemetry:
        if device_mesh is not None:
            from videop2p_tpu_torch.obs.comm import make_device_probe

            device_probe = make_device_probe(device_mesh)
            print(f"[p2p] device telemetry: probing {device_mesh.size} devices, "
                  f"divergence over {device_probe.divergence_axes}")
        else:
            print("[p2p] --device_telemetry needs --mesh — single-device runs have "
                  "no replicas to probe; flag ignored")
    unet_fn = make_unet_fn(bundle.unet)
    sched = bundle.make_scheduler()
    inv_key = inversion_cache_key(**inversion_determinants(
        image_path=image_path, prompt=prompt, steps=num_ddim_steps, width=width,
        video_len=video_len, dependent_p2p=dependent_p2p, dependent_weights=dep_w,
        decay_rate=decay_rate, window_size=window_size, ar_sample=ar_sample,
        ar_coeff=ar_coeff, seed=seed, checkpoint_dir=pretrained_model_path, tiny=tiny,
        mixed_precision=mixed_precision, frames=frames))
    if frames is None:
        frames = load_frame_sequence(image_path, size=width, num_frames=video_len)
    video = torch.as_tensor(np.asarray(frames), dtype=torch.float32,
                            device=device)[None] / 127.5 - 1.0
    from videop2p_tpu_torch.parallel.mesh import frames_slice, gather_frames
    # the disk layer's root: a shared --inv_store amortizes one inversion
    # across output directories (the keys are content-addressed)
    store_root = inv_store or output_dir
    meta = {"image_path": image_path, "prompt": prompt, "steps": num_ddim_steps,
            "width": width, "video_len": video_len, "fast": fast}

    with torch.no_grad():
        with _phase("vae_encode", timings, device, peaks):
            # on a frame-sharded mesh each rank encodes its own frames
            latents = encode_video(bundle.vae, frames_slice(video)).float()
        with _phase("text_encode", timings, device, peaks):
            cond_src = encode_prompts(bundle, [prompt], device)
            cond_all = encode_prompts(bundle, list(prompts), device)
            uncond = encode_prompts(bundle, [""], device)[0]
        if multi:
            # per-frame conditioning: each prompt's embedding over the frames
            cond_all = frames_slice(cond_all[:, None].repeat(1, video_len, 1, 1))
        blend_words = ((blend_word[0],), (blend_word[1],)) if blend_word else None
        ctx = make_controller(
            list(prompts), bundle.tokenizer, num_ddim_steps,
            is_replace_controller=bool(is_word_swap),
            cross_replace_steps=cross_replace_steps,
            self_replace_steps=self_replace_steps, blend_words=blend_words,
            equalizer_params=dict(eq_params) if eq_params else None,
            mask_th=MASK_TH, device=device)
        mode, decision, null_stats = "live", None, None
        if not fast:
            mode = "official"
        elif not live_source and eta == 0:
            # outside these windows the gates multiply the base maps out, so
            # nothing else is captured
            cross_len, self_window = capture_windows(ctx, num_ddim_steps)
            # the JAX CLI's override of the budget
            budget_gb = float(os.environ.get("VIDEOP2P_CACHED_MAPS_BUDGET_GB",
                                             CACHED_MAPS_BUDGET_GB))
            fits, tm_dtype, map_gb = choose_cached_maps(
                lambda dt: capture_bytes(
                    bundle.unet, (latents.shape[0], video_len, *latents.shape[2:]),
                    cond_src.shape[-2], cross_len=cross_len, self_window=self_window,
                    temporal_maps_dtype=dt),
                # the budget is per GPU: each holds its frames' share
                sp=sp, budget_gb=budget_gb)
            stored = "bfloat16" if tm_dtype is None else str(tm_dtype).replace("torch.", "")
            decision = {"fits": fits, "gib": map_gb, "budget_gib": budget_gb,
                        "temporal_maps_dtype": stored, "cross_len": cross_len,
                        "self_window": self_window}
            if fits:
                mode = "cached"
                print(f"[p2p] cached-source fast mode: cross window {cross_len} "
                      f"steps, self window {self_window}, maps {map_gb:.2f} GiB "
                      f"(budget {budget_gb:.1f} GiB), temporal maps "
                      f"stored {stored}")
            else:
                print(f"[p2p] cached-source maps need {map_gb:.1f} GiB even with "
                      f"1-byte temporal maps (> budget {budget_gb:.1f} "
                      "GiB) — falling back to the live source stream")
                if reuse_schedule != "off":
                    print("[p2p] reuse_schedule disabled with it — the deep-"
                          "feature cache rides the cached edit")
                    reuse_schedule = "off"
        # consulted only once the cached-maps decision is final, and never on
        # the cached path (its captured maps are not persisted: a repeat run
        # must take the same path to give the same output)
        null_tag = null_text_tag(num_inner_steps, null_text_precision, null_text_mode)
        reused = (load_persisted_inversion(store_root, inv_key, want_null=not fast,
                                           null_tag=null_tag)
                  if reuse_inversion and mode != "cached" else None)
        null_embeddings = None
        if mode == "cached":
            with _phase("cached_invert_edit", timings, device, peaks), \
                    maybe_trace("cached_invert_edit"):
                res = instrumented_program(cached_fast_edit, program="cached_invert_edit",
                                           sync=sync)(
                    unet_fn, sched, latents, cond_src, cond_all, uncond, ctx,
                    num_inference_steps=num_ddim_steps,
                    guidance_scale=GUIDANCE_SCALE, cross_len=cross_len,
                    self_window=self_window, temporal_maps_dtype=tm_dtype,
                    dependent_weight=dep_w, dependent_sampler=p2p_sampler,
                    generator=gens["inversion"], reuse_schedule=reuse_schedule,
                    telemetry=telemetry, attn_maps=attn_maps, device_probe=device_probe)
            trajectory, edited, extras = res[0], res[1], list(res[2:])
            if telemetry:
                tel = extras.pop(0)
                if run_ledger is not None:
                    run_ledger.telemetry("cached_invert_edit", _telemetry_record(tel))
            if device_probe is not None:
                _ledger_device_stats(run_ledger, "cached_invert_edit", extras.pop(0),
                                     device_probe)
            if attn_maps:
                attn_records = to_host(extras.pop(0))
            if run_ledger is not None:
                run_ledger.memory_snapshot(note="after_cached_edit")
            if reuse_inversion:
                save_persisted_inversion(store_root, inv_key, trajectory.cpu().numpy(),
                                         meta=meta)
        else:
            if reused is not None:
                traj_np, null_np = reused
                print(f"[p2p] reusing persisted inversion products (key {inv_key}) — "
                      "skipping DDIM inversion"
                      + (" and null-text optimization" if null_np is not None else ""))
                trajectory = torch.as_tensor(traj_np, device=device)
                if null_np is not None:
                    null_embeddings = torch.as_tensor(null_np, device=device)
            else:
                with _phase("ddim_inversion", timings, device, peaks):
                    trajectory = instrumented_program(ddim_inversion, program="ddim_inversion",
                                                      sync=sync)(
                        unet_fn, sched, latents, cond_src,
                        num_inference_steps=num_ddim_steps, dependent_weight=dep_w,
                        dependent_sampler=p2p_sampler, generator=gens["inversion"],
                        attn_maps=attn_maps)
                if attn_maps:
                    trajectory, inv_attn = trajectory
                    attn_records["inversion"] = to_host(inv_attn)
                if reuse_inversion:
                    save_persisted_inversion(store_root, inv_key,
                                             trajectory.cpu().numpy(), meta=meta)
            edit_tel = None
            if mode == "official":
                per_outer = {"optimize": num_inner_steps, "hybrid": 3,
                             "amortized": 1}[null_text_mode]

                def phase(name):  # official_null_text's "null_text_optimization"
                    return _phase(name, timings, device, peaks,
                                  count=num_ddim_steps * per_outer, unit="inner-step")

                if null_embeddings is None:
                    # the backward's convolutions in a fixed summation order:
                    # two runs of one clip give the same bits
                    with deterministic_convolutions():
                        null_embeddings, null_stats = official_null_text(
                            unet_fn, sched, trajectory, cond_src, uncond, phase,
                            num_inference_steps=num_ddim_steps,
                            guidance_scale=GUIDANCE_SCALE,
                            num_inner_steps=num_inner_steps,
                            null_text_precision=null_text_precision,
                            null_text_mode=null_text_mode,
                            dependent_weight=dep_w, dependent_sampler=p2p_sampler,
                            generator=gens["null_text"], telemetry=telemetry)
                    if run_ledger is not None:
                        run_ledger.telemetry("null_text_fused",
                                             decode_null_text_stats(null_stats))
                        run_ledger.memory_snapshot(note="after_null_text")
                    print(f"[p2p] null-text ({null_text_mode}/{null_text_precision}): "
                          f"{int(null_stats['inner_steps'].sum())} inner Adam steps "
                          f"across {num_ddim_steps} outer steps, final loss "
                          f"{float(null_stats['final_loss'][-1]):.3e}")
                    if reuse_inversion:
                        save_persisted_inversion(store_root, inv_key, None,
                                                 null_embeddings.cpu().numpy(),
                                                 null_tag=null_tag)
            # the edit alone is the program "edit_sample" (the null-text
            # phase above is its own program): the full CFG layout with the
            # null-text embeddings in official mode, the fast layout otherwise
            official = mode == "official"
            with _phase("edit_sample", timings, device, peaks), maybe_trace("edit_sample"):
                edited = instrumented_program(edit_sample, program="edit_sample",
                                              sync=sync)(
                    unet_fn, sched, trajectory[-1], cond_all, uncond,
                    num_inference_steps=num_ddim_steps, guidance_scale=GUIDANCE_SCALE,
                    ctx=ctx, source_uses_cfg=official, eta=eta, generator=gens["edit"],
                    null_uncond_embeddings=null_embeddings if official else None,
                    dependent_sampler=p2p_sampler, telemetry=telemetry,
                    attn_maps=attn_maps, device_probe=device_probe)
            if telemetry or attn_maps or device_probe is not None:
                edited, *extras = edited
                if telemetry:
                    edit_tel = extras.pop(0)
                if device_probe is not None:
                    _ledger_device_stats(run_ledger, "edit_sample", extras.pop(0),
                                         device_probe)
                if attn_maps:
                    attn_records["edit"] = to_host(extras.pop(0))
            if telemetry and run_ledger is not None:
                run_ledger.telemetry("edit_sample", _telemetry_record(edit_tel))
            if run_ledger is not None:
                run_ledger.memory_snapshot(note="after_edit")
        # rank 0 decodes the whole clip
        edited = gather_frames(edited)
        trajectory = gather_frames(trajectory, dim=2)
        videos = None
        if rank0:
            with _phase("vae_decode", timings, device, peaks):
                videos = (decode_video(bundle.vae, edited).float() + 1.0) / 2.0

    gifs = _write_gifs(videos, output_dir, save_name, fast) if save_gifs and rank0 else ()
    print("[p2p] phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
    report_path = sidecar_path = None
    if run_ledger is not None:
        if rank0 and (attn_records or quality or report):
            videos_np = videos.cpu().numpy()
            report_path, sidecar_path = _semantic_obs(
                run_ledger, output_dir=output_dir, save_name=save_name, suffix=suffix,
                prompts=list(prompts), tokenizer=bundle.tokenizer,
                attn_records=attn_records,
                # the prompt streams each capture's heat holds: the inversion
                # sees the source only; the cached edit drops the source
                # stream, the live and official edits keep all P
                stream_map={"inversion": [0],
                            "edit": (list(range(1, len(prompts))) if mode == "cached"
                                     else list(range(len(prompts))))},
                quality=quality, report=report,
                source01=((video[0] + 1.0) / 2.0).cpu().numpy(), videos=videos_np)
        run_ledger.event("artifacts", inversion_gif=gifs[0] if gifs else None,
                         edit_gif=gifs[1] if gifs else None, report=report_path)
        run_ledger.memory_snapshot(note="run_end")
        if device_mesh is not None:
            from videop2p_tpu_torch.parallel.distributed import gather_host_phases

            gather_host_phases(run_ledger)
        run_ledger.close()
        print(f"[p2p] run ledger: {run_ledger.path}")
        if getattr(run_ledger, "incidents", None) is not None:
            # the run ended without a crash: restore the hooks it armed
            run_ledger.incidents.close()
    if device_mesh is not None:
        from videop2p_tpu_torch.parallel.mesh import set_active_mesh

        set_active_mesh(None)
    return {"latents": edited, "x_0": trajectory[0], "x_t": trajectory[-1],
            "videos": videos, "mode": mode, "cached_maps": decision,
            "null_text": null_stats, "timings": timings, "peak_gib": peaks,
            "reused": {"trajectory": reused is not None,
                       "null_text": reused is not None and reused[1] is not None},
            "inv_key": inv_key, "unet_bytes": _module_bytes(bundle.unet),
            "checkpoint_dir": pretrained_model_path, "output_dir": output_dir,
            "gifs": gifs, "ledger": None if run_ledger is None else run_ledger.path,
            "sidecar": sidecar_path, "report": report_path,
            "mesh": None if device_mesh is None else device_mesh.spec()}


def _module_bytes(module: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers (a quantized UNet's
    1-byte weights and their scales included)."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def _write_gifs(videos: torch.Tensor, output_dir: str, save_name: str, fast: bool):
    """GIFs of the reconstruction and the edit, 4 fps, under ``output_dir``
    (names suffixed ``_fast`` in fast mode, as the JAX CLI's)."""
    frames = (videos.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    suffix = "_fast" if fast else ""
    paths = (os.path.join(output_dir, f"inversion{suffix}.gif"),
             os.path.join(output_dir, f"{save_name}{suffix}.gif"))
    for video, path in zip(frames, paths):
        save_video_gif(video, path)
    print(f"[p2p] wrote {paths[0]} and {paths[1]}")
    return paths


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="./configs/rabbit-jump-p2p.yaml")
    parser.add_argument("--fast", action="store_true",
                        help="the fast edit (default: official mode, null-text "
                             "optimization and the full-CFG edit)")
    parser.add_argument("--dependent_p2p", default=False, action="store_true",
                        help="blend the inversion's and null-text's predictions "
                             "with frame-correlated noise (--dependent_weights), "
                             "and draw an --eta > 0 edit's noise from it")
    parser.add_argument("--live_source", action="store_true",
                        help="keep the live source stream in fast mode "
                             "(default: the cached-source edit)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions of "
                             "the kernels")
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=sorted(_DTYPES),
                        help="model compute dtype (default fp32)")
    parser.add_argument("--tiny", action="store_true",
                        help="random-init tiny models (smoke mode)")
    parser.add_argument("--steps", type=int, default=NUM_DDIM_STEPS,
                        help="DDIM steps of the inversion and of the edit")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num_inner_steps", type=int, default=None,
                        help="official mode: inner Adam steps per outer step "
                             "(default 10, the reference's)")
    # defaults are None so that a config file's value wins when a flag is
    # unset (the JAX CLI's add_null_text_args)
    parser.add_argument("--null_text_precision", type=str, default=None,
                        choices=list(NULL_TEXT_PRECISIONS),
                        help="official mode: fp32 (default) or mixed (bf16 UNet "
                             "forwards and backward; scheduler, Adam and loss in "
                             "fp32)")
    parser.add_argument("--null_text_mode", type=str, default=None,
                        choices=list(NULL_TEXT_MODES),
                        help="official mode: optimize (default, the reference's "
                             "inner Adam loop), amortized (uncond := cond, one "
                             "forward per outer step) or hybrid (3 Adam steps per "
                             "outer step from the cond embedding, against the "
                             "recorded trajectory)")
    parser.add_argument("--multi", action="store_true",
                        help="per-frame text-embedding mode")
    parser.add_argument("--no_reuse_inversion", action="store_true",
                        help="do not persist/reuse inversion products "
                             "(trajectory + null embeddings) across runs")
    parser.add_argument("--inv_store", type=str, default=None,
                        help="shared content-addressed root for persisted "
                             "inversion products (serve/store.py's disk layer): "
                             "sweeps reuse one inversion per clip across cells; "
                             "default keeps the per-results-dir layout")
    parser.add_argument("--quant_mode", type=str, default="off", choices=list(QUANT_MODES),
                        help="UNet weight quantization at load (--fast only): w8 = "
                             "int8 weights + per-output-channel scales, dequantized "
                             "at use; w8a8 adds activation fake-quant at the "
                             "attention Dense boundaries")
    parser.add_argument("--reuse_schedule", type=str, default="off",
                        help="cross-step deep-feature reuse in the cached fast edit "
                             "('uniform:K' or 'custom:<p0,p1,...>'): listed steps "
                             "run the full UNet, the rest the shallow path on the "
                             "cached deep feature")
    parser.add_argument("--mesh", type=str, default=None,
                        help="mesh dp,sp,tp of GPUs, one process each under torchrun "
                             "(e.g. 1,2,1: frames over 2 GPUs); dp must be 1")
    # --dependent, --ar_sample, --decay_rate, --window_size, --ar_coeff,
    # --loss_sig, --num_frames, --eta (the edit's DDIM η, default 0; > 0
    # draws its noise from --seed) and --dependent_weights
    add_dependent_args(parser)
    add_obs_args(parser)
    args = parser.parse_args()
    cfg = load_config(args.config)
    for key in ("mixed_precision", "num_inner_steps", "null_text_precision",
                "null_text_mode"):
        if getattr(args, key) is not None:
            cfg[key] = getattr(args, key)
    # flags win over config for the keys both surfaces expose
    args.multi = args.multi or bool(cfg.pop("multi", False))
    args.mesh = args.mesh or cfg.pop("mesh", None)
    main(**cfg, fast=args.fast, live_source=args.live_source, device=args.device,
         tiny=args.tiny, seed=args.seed, num_ddim_steps=args.steps,
         dependent=args.dependent, dependent_p2p=args.dependent_p2p,
         num_frames=args.num_frames, decay_rate=args.decay_rate,
         window_size=args.window_size, ar_sample=args.ar_sample,
         ar_coeff=args.ar_coeff, eta=args.eta,
         dependent_weights=args.dependent_weights, multi=args.multi, mesh=args.mesh,
         quant_mode=args.quant_mode, reuse_schedule=args.reuse_schedule,
         reuse_inversion=not args.no_reuse_inversion, inv_store=args.inv_store,
         telemetry=args.telemetry, ledger=args.ledger, attn_maps=args.attn_maps,
         quality=args.quality, report=args.report, latency=args.latency,
         incidents=args.incidents, trace_analysis=args.trace_analysis,
         program_analysis=not args.no_program_analysis,
         device_telemetry=args.device_telemetry)
