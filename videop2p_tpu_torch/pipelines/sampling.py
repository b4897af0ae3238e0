"""The attention-controlled denoising loop (port of ``make_unet_fn``,
``edit_sample``, ``_edit_sample_cached`` and ``official_edit``,
``videop2p_tpu/pipelines/sampling.py:135-951``).

A Python loop over the DDIM steps. The batch puts U uncond streams ahead of
the P cond streams: in the full CFG layout (``source_uses_cfg=True``, the
official mode) U = P, and the source stream's uncond slot can take a
per-step null-text embedding; in the fast layout U = P − 1 (the source
stream replays its cond-only prediction, so its uncond forward is not run).
The controller sees every cross/temporal site through :class:`AttnControl`;
LocalBlend runs after each scheduler step on the running sum of the
blend-site maps. Latents and scheduler math stay float32. The pipeline
works in latent space only.

With a ``cached_source`` the source stream leaves the batch: its latents
replay the inversion trajectory and its maps come from the capture
(:mod:`videop2p_tpu_torch.pipelines.cached`), so only the E = P − 1 edit
streams run the UNet, behind their E uncond streams; a ``reuse_schedule``
(:mod:`videop2p_tpu_torch.pipelines.reuse`) then runs the full UNet on its
listed steps only and the shallow path on the others.

Observability (the JAX package's seams, off by default): ``telemetry``
collects each step's latent statistics and controller gates
(``obs/telemetry.py``), ``attn_maps`` each step's attention record and the
LocalBlend mask series (``obs/attention.py``). Both stay on the device
until the loop ends and change no output bit.

Per-frame ("multi") conditioning: cond embeddings of shape (P, F, L, D),
the uncond and null-text embeddings broadcast per frame. A SpatialReplace
controller (``ControlContext.spatial_replace_until``) copies the source
stream's latent into every edit stream after the first steps.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable, ContextManager, Optional, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.control.controllers import ControlContext
from videop2p_tpu_torch.control.local_blend import blend_mask, local_blend
from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.core.noise import DependentNoiseSampler
from videop2p_tpu_torch.models.attention import AttnControl
from videop2p_tpu_torch.obs.attention import (
    ATTN_HEAT_RES,
    attn_step_record,
    resize_linear,
    stack_attn_steps,
)
from videop2p_tpu_torch.obs.telemetry import latent_stats, stack_step_stats
from videop2p_tpu_torch.parallel.mesh import frames_draw
from videop2p_tpu_torch.pipelines.cached import (
    CachedSource,
    check_subset_windows,
    validate_step_positions,
)
from videop2p_tpu_torch.pipelines.reuse import parse_reuse_schedule
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store
from videop2p_tpu_torch.utils import cuda_graphs as graphs_mod
from videop2p_tpu_torch.utils.cuda_graphs import StepInputs, index_step

__all__ = ["edit_sample", "make_unet_fn", "official_edit", "official_null_text",
           "unet_module", "UNetFn"]

# (sample, t, text, control, *, store) -> (eps, store or None)
UNetFn = Callable[..., Tuple[torch.Tensor, Optional[dict]]]


def _controller_gates(ctx: Optional[ControlContext], i: int, device, step=None) -> dict:
    """The controller's edit activity at step ``i``, as 0-d tensors on
    ``device``: the mean cross-replace gate and whether the self/temporal
    replacement window covers the step (made on the device: no copy from
    the host inside the loop). ``step``: ``i`` as a 0-d int64 tensor on the
    device, which then picks the gate."""
    if ctx is None:
        return {"cross_gate_mean": torch.zeros((), device=device),
                "self_edit_active": torch.zeros((), dtype=torch.int32, device=device)}
    lo, hi = ctx.self_replace_range
    gate = index_step(ctx.cross_replace_alpha, i if step is None else step)
    return {"cross_gate_mean": gate.float().mean(),
            "self_edit_active": torch.full((), int(lo <= i < hi), dtype=torch.int32,
                                           device=device)}


def _mask_series_entry(maps_sum: torch.Tensor, blend_cfg, step_index: int,
                       latent_hw) -> dict:
    """The LocalBlend channels of one step: the mask the blend used, pooled
    to ``ATTN_HEAT_RES``, its coverage per stream and frame, and whether
    the blend gate was open."""
    mask = blend_mask(maps_sum, blend_cfg, latent_hw).float()
    return {"mask_cov": mask.mean(dim=(2, 3)),
            "mask_heat": resize_linear(mask, ATTN_HEAT_RES),
            "blend_active": torch.full((), int(step_index >= blend_cfg.start_blend),
                                       dtype=torch.int32, device=mask.device)}


def _pack_step_outputs(latents: torch.Tensor, telemetry: bool, tel: list,
                       attn_maps: bool, attn: list, dev: Optional[list] = None):
    """``latents``, then the stacked records asked for, in JAX's order:
    ``(latents[, tel][, dev][, attn])`` (``dev``: the device probe's
    per-step channels, None without a probe); the latents alone when none
    is."""
    out = (latents,)
    if telemetry:
        out += (stack_step_stats(tel),)
    if dev is not None:
        out += (stack_step_stats(dev),)
    if attn_maps:
        out += (stack_attn_steps(attn),)
    return out if len(out) > 1 else latents


def make_unet_fn(model) -> UNetFn:
    """Adapter from the UNet module to the pipelines' callable contract:
    ``fn(sample, t, text, control=None, *, store=True)`` returns
    ``(eps, store)``, the store being the dict of head-mean maps of the
    controlled sites (None when ``store=False``). ``deep_mode`` /
    ``deep_feature`` forward the UNet's deep-feature reuse seam: under
    ``"capture"`` the first element is ``(eps, deep feature)``."""

    def fn(sample, t, text, control=None, *, store: bool = True, deep_mode: str = "full",
           deep_feature=None):
        maps = {} if store else None
        if deep_mode == "full":
            return model(sample, t, text, control, maps), maps
        return model(sample, t, text, control, maps, deep_mode=deep_mode,
                     deep_feature=deep_feature), maps

    # the module, so that null-text optimization can freeze its parameters
    fn.module = model
    return fn


def unet_module(unet_fn: UNetFn) -> torch.nn.Module:
    """The UNet module behind a :func:`make_unet_fn` callable; raises on a
    callable that does not carry one."""
    module = getattr(unet_fn, "module", None)
    if not isinstance(module, torch.nn.Module):
        raise TypeError(
            "unet_fn must come from make_unet_fn: null-text optimization "
            "freezes its module's parameters, so that the backward keeps no "
            "weight gradients")
    return module


@torch.no_grad()
def edit_sample(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                cond_embeddings: torch.Tensor, uncond_embeddings: torch.Tensor, *,
                num_inference_steps: int = 50, guidance_scale: float = 7.5,
                ctx: Optional[ControlContext] = None, source_uses_cfg: bool = True,
                eta: float = 0.0, generator: Optional[torch.Generator] = None,
                variance_noise: Optional[torch.Tensor] = None,
                null_uncond_embeddings: Optional[torch.Tensor] = None,
                cached_source: Optional[CachedSource] = None,
                dependent_sampler: Optional[DependentNoiseSampler] = None,
                step_positions=None, reuse_schedule: Optional[str] = None,
                student_head: Optional[dict] = None, telemetry: bool = False,
                attn_maps: bool = False, device_probe: Optional[Callable] = None,
                cuda_graphs: Optional[bool] = None):
    """Run the controlled denoise; returns final latents (P, F, h, w, C).

    ``latents``: x_T, (1, F, h, w, C) (shared by all streams) or (P, …);
    ``cond_embeddings`` (P, L, D), source prompt first, or (P, F, L, D) per
    frame ("multi" conditioning: the uncond then broadcasts per frame, and
    null-text embeddings may be (steps, F, L, D)); ``uncond_embeddings``
    (L, D) or (1, L, D), the raw uncond of every stream.

      * ``source_uses_cfg=True`` (JAX's default, the official mode): every
        stream runs CFG against its uncond stream (U = P);
        ``source_uses_cfg=False`` is the ``--fast`` layout (U = P − 1).
      * ``null_uncond_embeddings``: null-text optimization's per-step
        embeddings, (steps, L, D) or (steps, 1, L, D), injected into the
        source stream's uncond slot at each step; the edit streams keep the
        raw uncond (JAX: sampling.py:342-368).
      * ``eta`` > 0: the stochastic DDIM step; its noise is
        ``variance_noise[i]`` at step i when given ((steps, P, F, h, w, C),
        e.g. JAX's draws in a test), else drawn from ``generator`` (the
        CLI's, seeded from ``--seed``): frame-correlated through
        ``dependent_sampler`` when one is given (the fork's dependent
        noise, JAX: sampling.py:441-447), else i.i.d. normal; one of
        ``variance_noise`` and ``generator`` is required.
      * ``cached_source``: the cached-source mode (fast layout, η = 0, no
        null-text embeddings); its capture must cover
        ``num_inference_steps`` steps, and stream 0 of the output is its
        x_0.
      * ``step_positions`` (cached mode only): ``num_inference_steps``
        strictly increasing positions into the capture's base edit-step grid
        (``DDIMScheduler.subset_positions`` makes them): the edit visits only
        those base timesteps of one inversion, reading the source replay and
        the captured maps at them and stepping the non-uniform grid through
        explicit ``prev_timestep``. The controller is built for the subset's
        step count; its open gates must map inside the captured windows
        (``pipelines/cached.py:check_subset_windows``).
      * ``reuse_schedule`` (cached mode only): ``"uniform:K"`` or
        ``"custom:<p0,...>"`` marks the steps that run the full UNet
        (capturing its deep feature); the others run the shallow path on the
        last full step's deep feature, LocalBlend re-adding that step's
        edit-stream maps. ``"off"`` / None is the plain loop.
      * ``student_head`` (cached mode only): the consistency-distilled
        student's time head (``train/distill.py``), which modulates the edit
        streams' ε before CFG; pass the student's parameters in the UNet.
        None is the teacher's loop.
      * ``telemetry``: also return the stacked per-step statistics of the
        latents after each step (the edit streams only in cached mode) with
        the controller's gates (``cross_gate_mean``, ``self_edit_active``).
      * ``attn_maps``: also return the stacked per-step attention record
        (``obs/attention.py:attn_step_record`` over the conditional
        streams: all P live, the E edit streams cached) and, with
        LocalBlend, the mask series (``mask_cov``, ``mask_heat``,
        ``blend_active``; all streams, source first). The UNet is then asked
        for its store at every step; storing reads the probabilities and
        changes no output. It refuses a ``reuse_schedule`` (a shallow step
        stores nothing).
      * ``device_probe`` (``obs/comm.py:make_device_probe``, on a mesh):
        also return its per-step channels of the latents after each step
        (the edit streams in cached mode) — each rank's local statistics
        and the cross-replica divergence.
      * ``cuda_graphs``: the steps (of the live loop and of the cached
        one) are step bodies over device buffers, keyed by their branch
        pattern and replayed as CUDA graphs (``utils/cuda_graphs.py``) when
        None (the default) on a CUDA device, on one card or a mesh; False keeps the
        eager loop (the same bits); a runner (``StepGraphs``, e.g. a
        program set's ``KeptRunner``) runs them through it.

    With any, the return is ``(latents[, tel][, dev][, attn])``."""
    if cond_embeddings.dim() not in (3, 4):
        raise ValueError(f"cond_embeddings must be (P, L, D) or (P, F, L, D), got "
                         f"{tuple(cond_embeddings.shape)}")
    multi = cond_embeddings.dim() == 4
    P = cond_embeddings.shape[0]
    latents = latents.float()
    if latents.shape[0] == 1 and P > 1:
        latents = latents.expand(P, *latents.shape[1:])
    elif latents.shape[0] != P:
        raise ValueError(f"latents batch {latents.shape[0]} != num prompts {P}")
    video_length = latents.shape[1]
    latent_hw = tuple(latents.shape[2:4])
    text_len = cond_embeddings.shape[-2]
    if multi and cond_embeddings.shape[1] != video_length:
        raise ValueError(f"per-frame cond_embeddings {tuple(cond_embeddings.shape)} do not "
                         f"match video_length {video_length}")
    if uncond_embeddings.dim() == 3 and uncond_embeddings.shape[0] == 1:
        uncond_embeddings = uncond_embeddings[0]
    if uncond_embeddings.dim() != 2:
        raise ValueError(
            f"uncond_embeddings must be (L, D) or (1, L, D), got "
            f"{tuple(uncond_embeddings.shape)}; per-step null-text embeddings "
            "go in null_uncond_embeddings")
    if multi:
        # every stream's uncond, per frame
        uncond_embeddings = uncond_embeddings[None].expand(
            video_length, *uncond_embeddings.shape)

    if step_positions is not None and cached_source is None:
        raise ValueError(
            "step_positions is the cached fast path's step-reduction seam: "
            "it requires cached_source")
    if reuse_schedule not in (None, "off"):
        if cached_source is None:
            raise ValueError(
                "reuse_schedule is the cached fast path's deep-feature reuse seam: "
                "it requires cached_source")
        if attn_maps:
            raise ValueError(
                "attn_maps capture reads every step's attention store and "
                "shallow reuse steps do not produce one — run attention "
                "capture with reuse_schedule='off'")
    if student_head is not None and cached_source is None:
        raise ValueError(
            "student_head is the cached fast path's few-step student seam — "
            "it requires cached_source")
    if cached_source is not None:
        if source_uses_cfg:
            raise ValueError("cached_source requires fast mode (source_uses_cfg=False)")
        if null_uncond_embeddings is not None:
            raise ValueError(
                "cached_source replays the source exactly: null-text "
                "embeddings have nothing left to correct and are not injected")
        if eta > 0:
            raise ValueError(
                "cached_source requires eta=0: η-variance noise would make the "
                "live source stream stochastic while the cached replay is "
                "deterministic")
        if step_positions is not None:
            step_positions = validate_step_positions(step_positions,
                                                     cached_source.num_steps)
            if len(step_positions) != num_inference_steps:
                raise ValueError(
                    f"step_positions has {len(step_positions)} entries, edit "
                    f"runs {num_inference_steps}")
        elif cached_source.num_steps != num_inference_steps:
            raise ValueError(
                f"cached trajectory covers {cached_source.num_steps} steps, "
                f"edit runs {num_inference_steps} (pass step_positions for a "
                "timestep-subset fast path from one inversion)")
        return _edit_sample_cached(
            unet_fn, scheduler, latents, cond_embeddings, uncond_embeddings,
            cached_source, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, ctx=ctx, step_positions=step_positions,
            reuse_schedule=reuse_schedule, student_head=student_head,
            telemetry=telemetry, attn_maps=attn_maps, device_probe=device_probe,
            cuda_graphs=cuda_graphs)

    # the source stream's uncond at each step: the null-text sequence when
    # given, else the raw uncond
    if null_uncond_embeddings is not None:
        if null_uncond_embeddings.dim() == 4 and null_uncond_embeddings.shape[1] == 1:
            null_uncond_embeddings = null_uncond_embeddings[:, 0]
        if not multi and null_uncond_embeddings.dim() == 4:
            raise ValueError(
                "null-text embeddings must be optimized on the batch-1 source "
                f"stream, got shape {tuple(null_uncond_embeddings.shape)}")
        if multi and null_uncond_embeddings.dim() == 3:
            # one (L, D) a step, broadcast over the frames
            null_uncond_embeddings = null_uncond_embeddings[:, None].expand(
                null_uncond_embeddings.shape[0], video_length,
                *null_uncond_embeddings.shape[1:])
        expected = (num_inference_steps, *uncond_embeddings.shape)
        if tuple(null_uncond_embeddings.shape) != expected:
            raise ValueError(
                f"null-text embeddings must have shape {expected}, got "
                f"{tuple(null_uncond_embeddings.shape)}")
    if variance_noise is not None:
        expected = (num_inference_steps, *latents.shape)
        if tuple(variance_noise.shape) != expected:
            raise ValueError(f"variance_noise must have shape {expected}, got "
                             f"{tuple(variance_noise.shape)}")
    if eta > 0 and variance_noise is None and generator is None:
        raise ValueError("eta > 0 needs a generator or variance_noise")

    return _edit_sample_live(
        unet_fn, scheduler, latents, cond_embeddings, uncond_embeddings,
        num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, ctx=ctx,
        source_uses_cfg=source_uses_cfg, eta=eta, generator=generator,
        variance_noise=variance_noise,
        null_uncond_embeddings=null_uncond_embeddings if source_uses_cfg else None,
        dependent_sampler=dependent_sampler, telemetry=telemetry, attn_maps=attn_maps,
        device_probe=device_probe, cuda_graphs=cuda_graphs)


def _edit_sample_live(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                      cond_embeddings: torch.Tensor, uncond_embeddings: torch.Tensor, *,
                      num_inference_steps: int, guidance_scale: float,
                      ctx: Optional[ControlContext], source_uses_cfg: bool, eta: float,
                      generator: Optional[torch.Generator],
                      variance_noise: Optional[torch.Tensor],
                      null_uncond_embeddings: Optional[torch.Tensor],
                      dependent_sampler: Optional[DependentNoiseSampler], telemetry: bool,
                      attn_maps: bool, device_probe: Optional[Callable],
                      cuda_graphs=None):
    """The live loop (every stream in the batch; arguments checked by
    :func:`edit_sample`). Each step is a step body over device buffers: the
    step's timesteps and index, the latents, LocalBlend's running sum, the
    η noise (drawn before the body in the eager order: the body draws
    nothing) and the source stream's null-text embedding (gathered from the
    table at the step's index); keyed by its branch pattern: LocalBlend's
    first step, its gate, SpatialReplace and the temporal window."""
    P = cond_embeddings.shape[0]
    U = P if source_uses_cfg else P - 1
    N = num_inference_steps
    video_length = latents.shape[1]
    latent_hw = tuple(latents.shape[2:4])
    text_len = cond_embeddings.shape[-2]
    device = latents.device
    use_blend = ctx is not None and ctx.blend is not None
    timesteps = scheduler.timesteps(N)
    ratio = scheduler.num_train_timesteps // N

    def draw(noise: torch.Tensor, i: int) -> None:
        """Step ``i``'s η noise into its buffer, as the eager loop drew it."""
        if variance_noise is not None:
            noise.copy_(variance_noise[i])
        elif dependent_sampler is not None:
            noise.copy_(frames_draw(lambda shape: dependent_sampler.sample_like(
                noise.new_empty(shape), generator), noise.shape))
        else:
            noise.copy_(frames_draw(lambda shape: torch.randn(
                shape, generator=generator, device=noise.device), noise.shape))

    tel, attn, dev = [], [], []
    with graphs_mod.step_graphs(cuda_graphs, device, "live_edit") as graphs:
        ctx = graphs.inputs("ctx", ctx)
        cond = graphs.inputs("cond", cond_embeddings)
        raw = graphs.inputs("uncond", uncond_embeddings)
        null = graphs.inputs("null", null_uncond_embeddings)
        inputs = graphs.inputs("steps", StepInputs(
            {"t": timesteps, "prev": timesteps - ratio, "step": range(N)}, device))
        x = graphs.scratch("latents", lambda: torch.empty(latents.shape, device=device))
        x.copy_(latents)
        noise = (graphs.scratch("noise", lambda: torch.empty(latents.shape, device=device))
                 if eta > 0 else None)
        state = graphs.scratch("state", dict)

        def body(i: int):
            """Step ``i``'s work: ``i`` only decides the branches its
            variant key fixes; every per-step value comes from ``inputs``."""
            uncond = raw.expand(U, *raw.shape)
            if null is not None:
                uncond = torch.cat([index_step(null, inputs.step)[None].to(raw.dtype),
                                    uncond[1:]])
            text = torch.cat([uncond, cond], dim=0)
            latent_in = torch.cat([x[P - U:], x], dim=0)
            control = AttnControl(ctx, i, U, step=inputs.step) if ctx is not None else None
            eps_all, store = unet_fn(latent_in, inputs.t, text, control,
                                     store=use_blend or attn_maps)
            eps_all = eps_all.float()
            eps_uncond, eps_text = eps_all[:U], eps_all[U:]
            if source_uses_cfg:
                eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            else:
                eps_edit = eps_uncond + guidance_scale * (eps_text[1:] - eps_uncond)
                eps = torch.cat([eps_text[:1], eps_edit], dim=0)
            new, _ = scheduler.step(eps, inputs.t, x, N, eta=eta, variance_noise=noise,
                                    prev_timestep=inputs.prev)
            if use_blend:
                maps = blend_maps_from_store(
                    store, latent_hw=latent_hw, video_length=video_length,
                    num_prompts=P, text_len=text_len, num_uncond=U).float()
                if i == 0:
                    _keep(state, "maps_sum", maps)
                else:
                    state["maps_sum"].add_(maps)
                new = local_blend(new, state["maps_sum"], ctx.blend, i)
            if ctx is not None and i < ctx.spatial_replace_until:
                # SpatialReplace: every edit stream takes the source's latent
                new = new[:1].expand_as(new)
            x.copy_(new)
            out = {}
            if telemetry:
                out["tel"] = dict(latent_stats(x),
                                  **_controller_gates(ctx, i, device, step=inputs.step))
            if device_probe is not None:
                out["dev"] = device_probe(x)
            if attn_maps:
                rec = attn_step_record(store, num_uncond=U, num_cond=P,
                                       video_length=video_length, text_len=text_len,
                                       latent_hw=latent_hw)
                if use_blend:
                    rec.update(_mask_series_entry(state["maps_sum"], ctx.blend, i, latent_hw))
                out["attn"] = rec
            return out

        for i in range(N):
            inputs.load(i)
            if noise is not None:
                draw(noise, i)
            out = graphs.kept(graphs.run(_variant(ctx, i, use_blend), body, i))
            if telemetry:
                tel.append(out["tel"])
            if device_probe is not None:
                dev.append(out["dev"])
            if attn_maps:
                attn.append(out["attn"])
        result = graphs.own(x)
    return _pack_step_outputs(result, telemetry, tel, attn_maps, attn,
                              dev if device_probe is not None else None)


def _keep(state: dict, name: str, value: torch.Tensor) -> None:
    """``state[name] = value``, into the buffer when there is one (a step
    body's graph holds its address)."""
    if name in state:
        state[name].copy_(value)
    else:
        state[name] = value


def _variant(ctx: Optional[ControlContext], i: int, use_blend: bool, full=None) -> tuple:
    """Every Python-level branch of a controlled loop's step ``i``: the
    first step (LocalBlend's running sum starts there), a reuse schedule's
    full or shallow step, the blend gate, SpatialReplace and the temporal
    window."""
    if ctx is None:
        return (i == 0, full)
    lo, hi = ctx.self_replace_range
    return (i == 0, full, use_blend and i >= ctx.blend.start_blend,
            i < ctx.spatial_replace_until, lo <= i < hi)


def _edit_sample_cached(unet_fn: UNetFn, scheduler: DDIMScheduler,
                        latents: torch.Tensor, cond_embeddings: torch.Tensor,
                        uncond_embeddings: torch.Tensor, cached: CachedSource, *,
                        num_inference_steps: int, guidance_scale: float,
                        ctx: Optional[ControlContext], step_positions=None,
                        reuse_schedule: Optional[str] = None,
                        student_head: Optional[dict] = None, telemetry: bool = False,
                        attn_maps: bool = False, device_probe: Optional[Callable] = None,
                        cuda_graphs: Optional[bool] = None):
    """The cached-source loop: the batch is E uncond + E edit streams, the
    controllers read the captured base maps of each step, and LocalBlend
    sums the source's captured blend maps with the edit streams' live ones,
    source first. Deterministic: η = 0. ``step_positions`` (validated)
    walks a timestep subset of the capture's base grid: step j runs at base
    position ``step_positions[j]`` and lands on the next one (the last on
    the base walk's terminal target), the controller's gates in subset-step
    space. ``reuse_schedule``: a full step captures the deep feature and,
    with LocalBlend, its edit-stream maps; a shallow step reuses both.
    ``student_head``: the few-step student's time head
    (``train/distill.py``) modulates the edit streams' ε before CFG.
    ``telemetry`` / ``attn_maps``: :func:`edit_sample`'s records, over the
    edit streams (the source stream is the capture's replay; its maps show
    in the capture's own record); the mask series keeps all streams.

    Each step is a step body over device buffers (the step's timesteps,
    its indices into the capture, the edit latents, LocalBlend's running
    sum, the reuse schedule's deep feature), keyed by its branch pattern:
    the first step, full or shallow, the blend gate, SpatialReplace and the
    temporal window."""
    P = cond_embeddings.shape[0]
    E = U = P - 1
    if E < 1:
        raise ValueError("cached_source needs at least one edit prompt")
    video_length = latents.shape[1]
    latent_hw = tuple(latents.shape[2:4])
    text_len = cond_embeddings.shape[-2]
    base_steps = cached.num_steps
    N = num_inference_steps
    ratio = scheduler.num_train_timesteps // N
    if step_positions is None:
        positions = np.arange(N)
        timesteps = scheduler.timesteps(N)
        prev_timesteps = timesteps - ratio
    else:
        positions = np.asarray(step_positions, dtype=np.int64)
        base_ts = scheduler.timesteps(base_steps)
        timesteps = base_ts[positions]
        ratio = scheduler.num_train_timesteps // base_steps
        prev_timesteps = np.append(timesteps[1:], base_ts[-1] - ratio)
        check_subset_windows(ctx, cached, positions, N)
    # the source latent after step i: the next visited grid point, x_0 last
    src_after = np.append(positions[1:], base_steps)
    text = torch.cat([uncond_embeddings.expand(E, *uncond_embeddings.shape),
                      cond_embeddings[1:]], dim=0)
    if ctx is not None and ctx.kind != "empty":
        # an open gate window without maps would skip the edit at every
        # site of that kind: refuse it
        lo, hi = cached.self_window
        if cached.cross_len > 0 and not cached.cross_maps:
            raise ValueError(
                f"capture declares a {cached.cross_len}-step cross window but "
                "has no cross maps")
        if hi > lo and not cached.temporal_maps:
            raise ValueError(
                f"capture declares self window {cached.self_window} but has "
                "no temporal maps")
    use_blend = ctx is not None and ctx.blend is not None
    if use_blend and cached.blend_seq is None:
        raise ValueError(
            "LocalBlend is configured but the capture has no blend_seq: run "
            "ddim_inversion_captured(capture_blend=True)")
    full_steps = (None if reuse_schedule in (None, "off")
                  else parse_reuse_schedule(reuse_schedule, N))
    device = latents.device
    base = [cached.base_indices(int(p)) for p in positions]
    tel, attn, dev = [], [], []
    with graphs_mod.step_graphs(cuda_graphs, device, "cached_edit") as graphs:
        ctx = graphs.inputs("ctx", ctx)
        cached = graphs.inputs("cached", cached)
        text = graphs.inputs("text", text)
        student_head = graphs.inputs("student_head", student_head)
        inputs = graphs.inputs("steps", StepInputs(
            {"t": timesteps, "prev": prev_timesteps, "step": range(N), "base": positions,
             "src": src_after, "cross": [c for c, _ in base],
             "temporal": [t for _, t in base]}, device))
        edit_latents = graphs.scratch("edit_latents", lambda: torch.empty(
            latents[1:].shape, dtype=latents.dtype, device=device))
        edit_latents.copy_(latents[1:])
        # LocalBlend's running sum, and the reuse schedule's deep feature and
        # edit maps of the last full step: made by the first step, then
        # updated in place
        state = graphs.scratch("state", dict)

        def edit_maps_of(store):
            return blend_maps_from_store(
                store, latent_hw=latent_hw, video_length=video_length,
                num_prompts=E, text_len=text_len, num_uncond=U).float()

        def body(i: int, full: Optional[bool]):
            """Step ``i``'s work: ``i`` only decides the branches its variant
            key fixes; every per-step value comes from ``inputs``."""
            latent_in = torch.cat([edit_latents, edit_latents], dim=0)
            control = None
            if ctx is not None:
                control = AttnControl(ctx, i, U, step=inputs.step, cached_source=True,
                                      cached_base=cached.base_tree_at(inputs.cross,
                                                                      inputs.temporal))
            store = None
            if full is None:
                eps_all, store = unet_fn(latent_in, inputs.t, text, control,
                                         store=use_blend or attn_maps)
                edit_maps = edit_maps_of(store) if use_blend else None
            elif full:
                (eps_all, deep), store = unet_fn(latent_in, inputs.t, text, control,
                                                 store=use_blend, deep_mode="capture")
                _keep(state, "deep", deep)
                edit_maps = None
                if use_blend:
                    _keep(state, "last_maps", edit_maps_of(store))
                    edit_maps = state["last_maps"]
            else:
                # the shallow path re-adds the last full step's edit maps
                eps_all, _ = unet_fn(latent_in, inputs.t, text, control, store=False,
                                     deep_mode="shallow", deep_feature=state["deep"])
                edit_maps = state.get("last_maps")
            if student_head is not None:
                # only the edit streams run the UNet; the source stream is the
                # capture's replay below, so src_err == 0.0 is untouched
                from videop2p_tpu_torch.train.distill import apply_time_head

                eps_all = apply_time_head(student_head, eps_all, inputs.t)
            eps_all = eps_all.float()
            eps_uncond, eps_text = eps_all[:E], eps_all[E:]
            eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
            new, _ = scheduler.step(eps, inputs.t, edit_latents, N, prev_timestep=inputs.prev)
            source_after = index_step(cached.src_latents, inputs.src)
            out = {}
            if use_blend:
                maps = torch.cat([index_step(cached.blend_seq, inputs.base), edit_maps], dim=0)
                if i == 0:
                    _keep(state, "maps_sum", maps)
                else:
                    state["maps_sum"].add_(maps)
                full_latents = torch.cat([source_after, new], dim=0)
                new = local_blend(full_latents, state["maps_sum"], ctx.blend, i)[1:]
            if ctx is not None and i < ctx.spatial_replace_until:
                new = source_after.expand_as(new)
            edit_latents.copy_(new)
            if telemetry:
                out["tel"] = dict(latent_stats(edit_latents),
                                  **_controller_gates(ctx, i, device, step=inputs.step))
            if device_probe is not None:
                out["dev"] = device_probe(edit_latents)
            if attn_maps:
                rec = attn_step_record(store, num_uncond=U, num_cond=E,
                                       video_length=video_length, text_len=text_len,
                                       latent_hw=latent_hw)
                if use_blend:
                    rec.update(_mask_series_entry(state["maps_sum"], ctx.blend, i, latent_hw))
                out["attn"] = rec
            return out

        for i in range(N):
            inputs.load(i)
            full = None if full_steps is None else bool(full_steps[i])
            out = graphs.kept(graphs.run(_variant(ctx, i, use_blend, full), body, i, full))
            if telemetry:
                tel.append(out["tel"])
            if device_probe is not None:
                dev.append(out["dev"])
            if attn_maps:
                attn.append(out["attn"])
        # stream 0 is the capture's x_0, copied without arithmetic
        result = torch.cat([cached.src_latents[-1], edit_latents], dim=0)
    return _pack_step_outputs(result, telemetry, tel, attn_maps, attn,
                              dev if device_probe is not None else None)


def official_edit(unet_fn: UNetFn, scheduler: DDIMScheduler, trajectory: torch.Tensor,
                  cond_embeddings: torch.Tensor, uncond_embedding: torch.Tensor, *,
                  num_inference_steps: int = 50, guidance_scale: float = 7.5,
                  ctx: Optional[ControlContext] = None, num_inner_steps: int = 10,
                  epsilon: float = 1e-5, null_text_precision: str = "fp32",
                  null_text_mode: str = "optimize", hybrid_inner_steps: int = 3,
                  early_stop: bool = True,
                  eta: float = 0.0, generator: Optional[torch.Generator] = None,
                  dependent_weight: float = 0.0,
                  dependent_sampler: Optional[DependentNoiseSampler] = None,
                  null_text_generator: Optional[torch.Generator] = None,
                  source_embedding: Optional[torch.Tensor] = None,
                  phase: Optional[Callable[[str], ContextManager]] = None,
                  null_embeddings: Optional[torch.Tensor] = None,
                  telemetry: bool = False, attn_maps: bool = False,
                  cuda_graphs: Optional[bool] = None):
    """The official mode: null-text optimization of the source stream's
    uncond embedding against ``trajectory`` (N + 1, 1, F, h, w, C), then the
    controlled full-CFG edit from its x_T with those embeddings injected
    (JAX: ``official_edit``, sampling.py:829-951, one jitted program there;
    two eager calls here).

    ``dependent_weight`` / ``dependent_sampler`` / ``null_text_generator``
    go to the null-text phase (its dependent-noise blend); with η > 0 the
    edit also draws its step noise through ``dependent_sampler`` (from
    ``generator``), as JAX's ``official_edit`` does.

    Under ``null_text_precision="mixed"`` a UNet that is not bf16 runs the
    null-text phase on a bf16 clone of ``unet_fn``'s module, dropped before
    the edit (JAX: the CLI's ``bundle.unet.clone(dtype=bf16)``).
    ``source_embedding`` (1, L, D) conditions the null-text phase in place of
    ``cond_embeddings[:1]`` (the CLI's source ``prompt``). ``phase``,
    when given, maps a phase name ("null_text_optimization",
    "edit_sample") to a context manager entered around that phase (the
    CLI's timer). ``null_embeddings`` (N, 1, L, D), e.g. persisted by an
    earlier run, skip the null-text phase.

    ``telemetry`` / ``attn_maps`` go to the edit (:func:`edit_sample`),
    and ``telemetry`` to the null-text phase too (its record gains
    ``latent_stats``). ``cuda_graphs`` goes to both phases.

    Returns ``(latents (P, F, h, w, C), {"final_loss", "inner_steps"})``,
    the null-text record of each outer step (None when ``null_embeddings``
    were given); with ``telemetry`` or ``attn_maps`` the first element is
    :func:`edit_sample`'s ``(latents[, tel][, attn])``."""
    if phase is None:
        phase = lambda name: contextlib.nullcontext()  # noqa: E731
    if uncond_embedding.dim() == 3 and uncond_embedding.shape[0] == 1:
        uncond_embedding = uncond_embedding[0]
    if uncond_embedding.dim() != 2:
        raise ValueError(f"uncond_embedding must be (L, D) or (1, L, D), got "
                         f"{tuple(uncond_embedding.shape)}")
    stats = None
    if null_embeddings is not None:
        null_seq = null_embeddings
    else:
        null_seq, stats = official_null_text(
            unet_fn, scheduler, trajectory,
            cond_embeddings[:1] if source_embedding is None else source_embedding,
            uncond_embedding, phase, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, num_inner_steps=num_inner_steps,
            epsilon=epsilon, null_text_precision=null_text_precision,
            null_text_mode=null_text_mode, hybrid_inner_steps=hybrid_inner_steps,
            early_stop=early_stop, dependent_weight=dependent_weight,
            dependent_sampler=dependent_sampler, generator=null_text_generator,
            telemetry=telemetry, cuda_graphs=cuda_graphs)
    with phase("edit_sample"):
        out = edit_sample(unet_fn, scheduler, trajectory[-1], cond_embeddings,
                          uncond_embedding, num_inference_steps=num_inference_steps,
                          guidance_scale=guidance_scale, ctx=ctx, source_uses_cfg=True,
                          eta=eta, generator=generator, null_uncond_embeddings=null_seq,
                          dependent_sampler=dependent_sampler if eta > 0 else None,
                          telemetry=telemetry, attn_maps=attn_maps, cuda_graphs=cuda_graphs)
    return out, stats


def official_null_text(unet_fn: UNetFn, scheduler: DDIMScheduler, trajectory: torch.Tensor,
                     cond: torch.Tensor, uncond_embedding: torch.Tensor, phase, *,
                     null_text_precision: str, telemetry: bool = False, **kw):
    """The official mode's null-text phase, inside ``phase(
    "null_text_optimization")``: ``null_text_optimization`` of
    ``uncond_embedding`` (L, D) under the source embedding ``cond``, on a
    bf16 clone of the UNet under "mixed" precision when the UNet is not
    bf16, called as the instrumented program "null_text_fused" (the JAX
    package's label of its one-program null-text run). Returns the
    embeddings (N, 1, L, D) and the record ``{"final_loss",
    "inner_steps"}``, with ``telemetry`` also ``"latent_stats"``: each
    outer step's latent statistics, on the device."""
    from videop2p_tpu_torch.obs.ledger import instrumented_program
    from videop2p_tpu_torch.pipelines.inversion import null_text_optimization

    with phase("null_text_optimization"):
        null_fn = unet_fn
        module = unet_module(unet_fn)
        if (null_text_precision == "mixed"
                and next(module.parameters()).dtype != torch.bfloat16):
            null_fn = make_unet_fn(copy.deepcopy(module).to(torch.bfloat16))
        sync = ((lambda: torch.cuda.synchronize(trajectory.device))
                if trajectory.device.type == "cuda" else None)
        out = instrumented_program(null_text_optimization, program="null_text_fused",
                                   sync=sync)(
            null_fn, scheduler, trajectory, cond, uncond_embedding[None],
            null_text_precision=null_text_precision, return_losses=True,
            return_inner_steps=True, telemetry=telemetry, **kw)
        del null_fn
    stats = {"final_loss": out[1], "inner_steps": out[2]}
    if telemetry:
        stats["latent_stats"] = out[3]
    return out[0], stats
