"""What both CLI stages share: the models (``ModelBundle``, ``build_models``,
``encode_prompts``), the fork's dependent-noise flags, the Stage-1 ↔ Stage-2
checkpoint-path contract and the config reader (the port's own copy of
those of ``videop2p_tpu/cli/common.py``).

Stage 1 writes its tuned pipeline to ``<path><suffix>``, the suffix spelling
out the dependent-noise settings; Stage 2, given the same flags, resolves the
same directory and writes its results under it.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from videop2p_tpu_torch.models.convert import init_weights
from videop2p_tpu_torch.models.unet import UNet3DConditionModel, UNet3DConfig
from videop2p_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from videop2p_tpu_torch.utils.tokenizers import WordTokenizer, load_tokenizer

__all__ = ["ModelBundle", "build_models", "encode_prompts", "add_dependent_args",
           "add_obs_args", "dependent_suffix", "resolve_pipeline_dir", "parse_mesh",
           "validate_mesh", "setup_mesh", "load_config", "deterministic_convolutions", "make_run_ledger"]


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN held to its deterministic algorithms inside the block. A
    convolution's backward may otherwise sum with atomics in an order that
    changes from run to run: Stage 1 runs under it so that a resumed run
    repeats an uninterrupted one bit for bit, and Stage 2's null-text phase
    so that two official runs of one clip give the same bits."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def load_config(path: str) -> Dict[str, Any]:
    """A YAML config as a dict (needs PyYAML)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def add_dependent_args(parser: argparse.ArgumentParser) -> None:
    """The fork's flags, with the JAX CLI's defaults. Stage 2 parses
    ``--loss_sig`` and ``--num_frames`` and does not use them (the sampler
    takes the clip's frame count)."""
    parser.add_argument("--dependent", default=False, action="store_true")
    parser.add_argument("--ar_sample", default=False, action="store_true")
    parser.add_argument("--decay_rate", default=0.1, type=float)
    parser.add_argument("--window_size", default=60, type=int)
    parser.add_argument("--ar_coeff", default=0.1, type=float)
    parser.add_argument("--loss_sig", default=False, action="store_true")
    parser.add_argument("--num_frames", default=60, type=int)
    parser.add_argument("--eta", default=0.0, type=float)
    parser.add_argument("--dependent_weights", default=0.0, type=float)


def add_obs_args(parser: argparse.ArgumentParser) -> None:
    """The run CLIs' observability flags (JAX's ``add_obs_args``, with its
    defaults)."""
    parser.add_argument(
        "--telemetry", action="store_true",
        help="collect per-step telemetry in the pipelines' loops (loss curves, "
             "inner steps taken, latent abs-max / NaN counts, grad norms), kept on "
             "the device and read once after each loop; decoded into the run ledger")
    parser.add_argument(
        "--ledger", type=str, default=None,
        help="write a JSONL run ledger (phases, kernel builds, program calls, "
             "telemetry summaries, memory snapshots) to this path; default when "
             "any observability flag is set: <output dir>/run_ledger.jsonl")
    parser.add_argument(
        "--no_program_analysis", action="store_true",
        help="skip the automatic program analysis (obs/introspect.py: flops, "
             "transcendentals, bytes, memory, a fingerprint and an op histogram of "
             "each instrumented program, counted on its first call under a "
             "counting dispatch mode, which slows that call); the ledger then "
             "holds program_analysis_skipped events with reason 'disabled'")
    parser.add_argument(
        "--trace_analysis", action="store_true",
        help="capture a torch.profiler device trace around the main program "
             "(the fast edit's cached_invert_edit or the edit_sample program; one "
             "tuning chunk after the first) and mine its chrome trace "
             "(obs/trace.py): per-family device time, top kernels, idle gaps, as a "
             "trace_analysis ledger event and an .npz sidecar; implies a run ledger")
    parser.add_argument(
        "--latency", action="store_true",
        help="per-program execute-latency distributions (obs/timing.py): every "
             "instrumented program synchronizes the card after its call and "
             "records dispatch-return and synchronized wall times in bounded "
             "reservoirs, flushed as execute_timing ledger events; implies a run "
             "ledger. Trades the host/card overlap for a measured latency; the "
             "values are the same bits either way")
    parser.add_argument(
        "--attn_maps", action="store_true",
        help="capture per-step cross-attention observability in the edit's loops "
             "(obs/attention.py): pooled per-token heatmaps, per-site attention "
             "entropies, the LocalBlend mask series; the arrays go to an .npz "
             "sidecar referenced by attn_maps ledger events; outputs unchanged")
    parser.add_argument(
        "--quality", action="store_true",
        help="compute edit-quality metrics after decode (obs/quality.py): "
             "reconstruction PSNR/SSIM against the input frames, background PSNR "
             "outside the blend mask, adjacent-frame consistency; a quality ledger "
             "event gated by the quality rules")
    parser.add_argument(
        "--report", action="store_true",
        help="render a self-contained HTML edit report (per-word heatmaps, mask "
             "overlays, null-text loss sparkline, quality table, regression "
             "verdicts) next to the run's outputs; python -m "
             "videop2p_tpu_torch.obs.report re-renders it from the ledger")
    parser.add_argument(
        "--device_telemetry", action="store_true",
        help="per-device observability of a --mesh run (obs/comm.py): each rank's "
             "latent abs-max/mean/NaN statistics and the cross-replica divergence "
             "after every edit step (device_telemetry events), the tuned "
             "parameters' divergence after Stage 1 (a divergence event), both "
             "must be 0.0 — requires --mesh; implies a run ledger")
    parser.add_argument(
        "--incidents", type=str, default=None, metavar="DIR",
        help="arm the incident plane (obs/incident.py) on the run ledger: a "
             "flight recorder tees its most recent events into a bounded ring, "
             "and an unhandled crash or SIGUSR1 writes a capture bundle under DIR")


def dependent_suffix(*, dependent: bool, decay_rate: float, window_size: int,
                     ar_sample: bool, ar_coeff: float, eta: float,
                     dependent_weights: float) -> str:
    """The checkpoint directory's suffix: every setting in its Python
    ``str`` spelling, e.g. ``_dependentTrue_dr0.3_ws4_arTrue_ac0.1_eta0.0_dw0.2``."""
    return "_dependent{d}_dr{dr}_ws{ws}_ar{ar}_ac{ac}_eta{e}_dw{dw}".format(
        d=dependent, dr=decay_rate, ws=window_size, ar=ar_sample, ac=ar_coeff,
        e=eta, dw=dependent_weights)


def _is_pipeline_dir(path: str) -> bool:
    return os.path.isdir(os.path.join(path, "unet")) or os.path.isfile(
        os.path.join(path, "model_index.json"))


def resolve_pipeline_dir(base_path: str, **suffix_kwargs) -> str:
    """The checkpoint directory for ``base_path`` and the settings of
    :func:`dependent_suffix`: the suffixed directory when it holds a
    pipeline, else ``base_path`` when it does (a caller that already holds
    the suffixed directory), else the suffixed directory (loading then finds
    no checkpoint and says so)."""
    suffixed = base_path + dependent_suffix(**suffix_kwargs)
    if _is_pipeline_dir(suffixed):
        return suffixed
    if _is_pipeline_dir(base_path):
        if suffixed != base_path:
            print(f"[resolve_pipeline_dir] {base_path!r} is already a pipeline "
                  "dir — not appending the dependent suffix")
        return base_path
    return suffixed


@dataclass
class ModelBundle:
    """The three models of the edit, their tokenizer, the checkpoint's
    scheduler config (empty: the SD scheduler) and the checkpoint directory
    they were loaded from (None: random init)."""

    unet: UNet3DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextEncoder
    tokenizer: Any = field(default_factory=WordTokenizer)
    scheduler_config: Dict[str, Any] = field(default_factory=dict)
    source_dir: Optional[str] = None

    def make_scheduler(self) -> DDIMScheduler:
        if self.scheduler_config:
            return DDIMScheduler.from_config(self.scheduler_config)
        return DDIMScheduler.create_sd()


def _random_models(ucfg: UNet3DConfig, vcfg: VAEConfig, ccfg: CLIPTextConfig, *,
                   dtype: torch.dtype, device, seed: int, need=(True, True, True)) -> list:
    """Seeded random-init UNet, VAE and text encoder on ``device`` (seeds
    ``seed``, ``seed + 1``, ``seed + 2``; None where ``need`` is False)."""
    out = []
    for i, (cls, cfg) in enumerate(((UNet3DConditionModel, ucfg), (AutoencoderKL, vcfg),
                                    (CLIPTextEncoder, ccfg))):
        model = None
        if need[i]:
            with torch.device(device):
                model = init_weights(cls(cfg), seed + i).to(dtype).eval()
        out.append(model)
    return out


def build_models(pretrained_model_path: Optional[str] = None, *, tiny: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda", seed: int = 0,
                 frame_attention: str = "auto",
                 gradient_checkpointing: bool = False) -> ModelBundle:
    """The models, on ``device``. A ``pretrained_model_path`` holding a
    ``unet/`` is a diffusers-layout checkpoint: it loads
    (``models/pipeline_io.py``) with its tokenizer and scheduler config; a
    VAE or text encoder it lacks is random-init (a Stage-1 run from random
    weights saves only the UNet), with a warning. Otherwise seeded random
    init, the SD-1.5 shapes (``UNet3DConfig.sd15()``) or the tiny test
    shapes, with a warning when a path was given. The weights depend on
    ``seed`` only; ``frame_attention`` picks the UNet's frame-attention
    implementation (``UNet3DConfig.frame_attention``: "auto", "flash_rect",
    "flash", "chunked" or "dense"), ``gradient_checkpointing`` its
    block-level recompute (Stage 1)."""
    if pretrained_model_path is not None and os.path.isdir(
            os.path.join(pretrained_model_path, "unet")):
        from videop2p_tpu_torch.models.pipeline_io import load_pipeline

        loaded = load_pipeline(pretrained_model_path, dtype=dtype, device=device,
                               frame_attention=frame_attention,
                               gradient_checkpointing=gradient_checkpointing, seed=seed)
        if loaded.inflation_report["kept_init"]:
            print(f"[build_models] inflated 2D checkpoint: "
                  f"{len(loaded.inflation_report['kept_init'])} temporal params keep init")
        vae, text = loaded.vae, loaded.text_encoder
        if vae is None or text is None:
            missing = "/".join(name for name, m in (("vae", vae), ("text_encoder", text))
                               if m is None)
            warnings.warn(f"checkpoint {pretrained_model_path!r} has no {missing} — "
                          "backfilling with RANDOM-INIT components", stacklevel=2)
            ucfg = loaded.unet.config
            small = ucfg.block_out_channels[0] < 64  # a tiny-shaped checkpoint
            vcfg = VAEConfig.tiny() if small else VAEConfig()
            ccfg = (CLIPTextConfig.tiny(hidden_size=ucfg.cross_attention_dim) if small
                    else CLIPTextConfig())
            _, new_vae, new_text = _random_models(
                ucfg, vcfg, ccfg, dtype=dtype, device=device, seed=seed,
                need=(False, vae is None, text is None))
            vae, text = vae or new_vae, text or new_text
        return ModelBundle(unet=loaded.unet, vae=vae, text_encoder=text,
                           tokenizer=load_tokenizer(pretrained_model_path),
                           scheduler_config=loaded.scheduler_config,
                           source_dir=pretrained_model_path)
    if pretrained_model_path is not None:
        warnings.warn(f"no checkpoint at {pretrained_model_path!r} — building RANDOM-INIT "
                      "models (smoke/benchmark mode; outputs will be noise)", stacklevel=2)
    ccfg = CLIPTextConfig.tiny() if tiny else CLIPTextConfig()
    unet_kw = dict(frame_attention=frame_attention,
                   gradient_checkpointing=gradient_checkpointing)
    ucfg = (UNet3DConfig.tiny(cross_attention_dim=ccfg.hidden_size, **unet_kw) if tiny
            else UNet3DConfig.sd15(**unet_kw))
    vcfg = VAEConfig.tiny() if tiny else VAEConfig()
    unet, vae, text = _random_models(ucfg, vcfg, ccfg, dtype=dtype, device=device, seed=seed)
    return ModelBundle(unet=unet, vae=vae, text_encoder=text)


@torch.no_grad()
def encode_prompts(bundle: ModelBundle, prompts: Sequence[str], device) -> torch.Tensor:
    """(P, 77, D) text embeddings."""
    ids = torch.tensor([bundle.tokenizer.encode_padded(p) for p in prompts],
                       dtype=torch.long, device=device)
    return bundle.text_encoder(ids)


def parse_mesh(mesh_spec: Optional[str]) -> Tuple[int, int, int]:
    """A ``dp,sp,tp`` mesh spec as a shape; None or empty is (1, 1, 1)."""
    if not mesh_spec:
        return (1, 1, 1)
    shape = tuple(int(t) for t in str(mesh_spec).split(","))
    if len(shape) != 3:
        raise ValueError(f"--mesh must be dp,sp,tp — got {mesh_spec!r}")
    return shape


def validate_mesh(mesh_spec: Optional[str], video_len: int) -> Tuple[int, int, int]:
    """The checks a run CLI makes before it builds anything (JAX's
    ``setup_mesh`` checks): dp = 1 for single-clip flows, sp divides the
    clip's frames, and the mesh is the world of the ``torchrun`` launch.
    Returns the shape."""
    from videop2p_tpu_torch.parallel.mesh import check_world

    dp, sp, tp = shape = parse_mesh(mesh_spec)
    if dp != 1:
        raise ValueError(
            "single-clip flows run batch 1 — use dp=1 and put GPUs on the "
            f"frame/tensor axes, got dp={dp}")
    if video_len % sp:
        raise ValueError(f"sp axis {sp} must divide video_len {video_len}")
    check_world(shape)
    return shape


def setup_mesh(bundle: ModelBundle, mesh_spec: str, video_len: int,
               ring_variant: Optional[str] = None, tp_collectives: Optional[str] = None,
               device=None):
    """Parse a ``dp,sp,tp`` mesh spec and prepare the bundle's UNet for it
    (JAX's ``setup_mesh``): the process mesh (its size must be the world
    size of the ``torchrun`` launch, see
    ``parallel/distributed.py:initialize_distributed``) with its groups'
    communicators built (``parallel/mesh.py:warm_collectives``), and on a sharded
    axis the UNet's seams — the sharded GroupNorm on every norm; with
    ``sp`` > 1 the ring on the uncontrolled temporal sites, the K/V gather
    on the controlled ones and the frame-0 K/V broadcast before the
    frame-attention kernel; with ``tp`` > 1 the parameters split by JAX's
    rule, the column-parallel entries, the row-parallel outputs and the
    head-mean of the stored maps. The mesh becomes the active one (the
    pipelines' global losses and noise draws read it). Returns it. Both
    CLIs share this; single-clip flows need dp = 1, and sp must divide the
    clip's frames.

    ``ring_variant`` picks the ring schedule (``overlap``, ``bidir``,
    ``serial``; None reads ``VIDEOP2P_RING_VARIANT``), ``tp_collectives``
    the row-parallel reduction (``gspmd`` all-reduces, ``psum_scatter``
    reduce-scatters over the tokens and all-gathers; None reads
    ``VIDEOP2P_TP_COLLECTIVES``, default ``gspmd``)."""
    from videop2p_tpu_torch.parallel import (
        RING_VARIANTS,
        TP_COLLECTIVES,
        default_ring_variant,
        make_hybrid_mesh,
        make_megatron_out_dot,
        make_ring_temporal_fn,
        make_sharded_frame_attention_fn,
        make_sharded_group_norm_fn,
        set_active_mesh,
        shard_unet,
    )
    from videop2p_tpu_torch.parallel.mesh import (
        make_head_mean_fn,
        make_kv_gather_fn,
        make_tensor_copy_fn,
        warm_collectives,
    )

    if ring_variant is None:
        ring_variant = default_ring_variant()
    if ring_variant not in RING_VARIANTS:
        raise ValueError(f"ring_variant must be one of {RING_VARIANTS}, got {ring_variant!r}")
    if tp_collectives is None:
        tp_collectives = os.environ.get("VIDEOP2P_TP_COLLECTIVES", "gspmd").strip().lower()
    if tp_collectives not in TP_COLLECTIVES:
        raise ValueError(f"tp_collectives must be one of {TP_COLLECTIVES}, "
                         f"got {tp_collectives!r}")
    dp, sp, tp = shape = validate_mesh(mesh_spec, video_len)
    mesh = make_hybrid_mesh(dp, sp, tp, device=device)
    warm_s = warm_collectives(mesh)
    print(f"[mesh] data={dp} frames={sp} tensor={tp} (rank {mesh.rank}); collectives "
          f"warmed in {warm_s:.3f} s")
    unet = bundle.unet
    seams = {}
    if sp > 1 or tp > 1:
        seams["group_norm_fn"] = make_sharded_group_norm_fn(mesh)
    if sp > 1:
        seams.update(
            temporal_attention_fn=make_ring_temporal_fn(mesh, variant=ring_variant),
            kv_gather_fn=make_kv_gather_fn(mesh),
            frame_attention_fn=make_sharded_frame_attention_fn(mesh))
    if tp > 1:
        shard_unet(unet, mesh)
        seams.update(
            tp_copy_fn=make_tensor_copy_fn(mesh),
            row_parallel_dot=make_megatron_out_dot(mesh, tp_collectives),
            temporal_row_parallel_dot=make_megatron_out_dot(mesh, "gspmd"),
            head_mean_fn=make_head_mean_fn(mesh))
    if seams:
        unet.set_seams(**seams)
    set_active_mesh(mesh)
    return mesh


def make_run_ledger(default_path: str, *, ledger: Optional[str] = None,
                    meta: Optional[Dict[str, Any]] = None, telemetry: bool = False,
                    attn_maps: bool = False, quality: bool = False, report: bool = False,
                    latency: bool = False, trace_analysis: bool = False,
                    program_analysis: bool = True, enable: bool = False,
                    set_latency_env: bool = True, incidents: Optional[str] = None,
                    device=None, device_telemetry: bool = False):
    """The observability flags → an activated
    :class:`~videop2p_tpu_torch.obs.RunLedger` (JAX's wiring, shared by both
    run CLIs and the serving engine), or None when nothing asked for one.

    Any flag implies a ledger, at ``ledger`` or ``default_path``;
    ``enable`` forces one. ``latency`` turns execute timing on for the
    ledger and, with ``set_latency_env``, process-wide
    (``VIDEOP2P_OBS_LATENCY``) until the ledger closes, which restores the
    variable's previous value; a long-lived engine passes
    ``set_latency_env=False`` to keep it scoped to its ledger.
    ``trace_analysis`` (the caller's device traces) implies a ledger.
    ``program_analysis=False`` sets the analysis kill switch
    (``VIDEOP2P_OBS_NO_ANALYSIS=1``) while the ledger is open, restored at
    its close as the latency variable is (without a ledger nothing is
    analysed anyway).
    In a multi-process run rank ``r`` > 0 writes ``<stem>.rank<r>.jsonl``.
    ``device_telemetry`` (a mesh run's per-device probe) implies a ledger.
    ``incidents`` arms an :class:`~videop2p_tpu_torch.obs.IncidentManager`
    with crash hooks on the ledger (its flight ring tees the events; an
    unhandled crash or SIGUSR1 writes a bundle under that directory) for the
    rest of the process. ``device`` is the device the run computes on."""
    if not (enable or telemetry or ledger or attn_maps or quality or report or latency
            or trace_analysis or incidents or device_telemetry):
        return None
    scoped = {}
    if latency and set_latency_env:
        scoped["VIDEOP2P_OBS_LATENCY"] = "1"
    if not program_analysis:
        scoped["VIDEOP2P_OBS_NO_ANALYSIS"] = "1"
    prev_env = {k: os.environ.get(k) for k in scoped}
    os.environ.update(scoped)
    from videop2p_tpu_torch.obs import RunLedger

    base_meta = {"telemetry": bool(telemetry), "attn_maps": bool(attn_maps),
                 "quality": bool(quality), "device_telemetry": bool(device_telemetry),
                 "latency": bool(latency), "trace_analysis": bool(trace_analysis)}
    base_meta.update(meta or {})
    path = ledger or default_path
    from videop2p_tpu_torch.parallel.distributed import process_count, process_index

    if process_count() > 1:
        # one file per process (JAX's one ledger per host); rank 0's is the
        # run's, and gather_host_phases brings the others' phases into it
        base_meta.update(process_index=process_index(), process_count=process_count())
        if process_index() > 0:
            stem = path[:-len(".jsonl")] if path.endswith(".jsonl") else path
            path = f"{stem}.rank{process_index()}.jsonl"
    led = RunLedger(path, meta=base_meta, latency=latency,
                    device=device).activate()
    if scoped:
        def restore_env():
            for k, v in prev_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        led.on_close(restore_env)
    if incidents:
        from videop2p_tpu_torch.obs.incident import IncidentManager

        mgr = IncidentManager(str(incidents), crash_hooks=True)
        mgr.attach_ledger(led)
        led.incidents = mgr
    return led
