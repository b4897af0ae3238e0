"""DDIM inversion and null-text optimization (port of ``ddim_inversion``,
``ddim_inversion_captured`` and ``null_text_optimization``,
``videop2p_tpu/pipelines/inversion.py:86-757``), with the JAX package's
observability seams: ``attn_maps`` on the two inversions (the source
stream's per-step attention record, ``obs/attention.py``) and
``telemetry`` on null-text optimization (each outer step's latent
statistics, ``obs/telemetry.py``), both stacked on the device and read by
the caller after the loop.

Inversion walks clean latents x_0 to noise x_T with forward DDIM steps,
conditional only (guidance 1), and returns the whole trajectory; the
captured form also collects what the cached-source edit reads in place of a
live source stream. Null-text optimization then fits, step by step, the
unconditional embedding under which the CFG denoise replays that trajectory.

All three take the fork's dependent noise: with ``dependent_weight`` w > 0
every UNet prediction ε̂ becomes (1 − w)·ε̂ + w·n, n a fresh draw of
``dependent_sampler`` from ``generator`` (one seeded with 0 on the latents'
device when None, as JAX's default key), in the draw order of the JAX
package's key splits.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.core.noise import DependentNoiseSampler, step_generator
from videop2p_tpu_torch.models.attention import BASE_STORE, AttnControl
from videop2p_tpu_torch.obs.attention import attn_step_record
from videop2p_tpu_torch.obs.ledger import instrumented_program
from videop2p_tpu_torch.obs.telemetry import latent_stats, stack_step_stats
from videop2p_tpu_torch.parallel.mesh import frames_draw, global_mean, reduce_frame_grads
from videop2p_tpu_torch.pipelines.cached import CachedSource, filter_site_tree
from videop2p_tpu_torch.pipelines.sampling import UNetFn, unet_module
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["ddim_inversion", "ddim_inversion_captured", "null_text_optimization",
           "adam_update", "check_null_text_options", "NULL_TEXT_PRECISIONS",
           "NULL_TEXT_MODES"]

NULL_TEXT_PRECISIONS = ("fp32", "mixed")
NULL_TEXT_MODES = ("optimize", "amortized", "hybrid")
# optax.adam's defaults, which the JAX package's null-text loop takes
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def _dependent_generator(weight: float, sampler: Optional[DependentNoiseSampler],
                         generator: Optional[torch.Generator],
                         device: torch.device) -> Optional[torch.Generator]:
    """Raise when ``weight`` > 0 has no sampler; the generator the draws take
    (None when nothing is drawn)."""
    if weight <= 0.0:
        return None
    if sampler is None:
        raise ValueError("dependent_weight > 0 requires dependent_sampler")
    return generator if generator is not None else torch.Generator(device).manual_seed(0)


def _dependent_blend(eps: torch.Tensor, weight: float,
                     sampler: Optional[DependentNoiseSampler],
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """(1 − w)·ε + w·n with n one draw of ``sampler`` shaped and typed like ε
    (the blend runs in ε's dtype); ε itself when w ≤ 0. On a frame-sharded
    mesh the draw is the whole clip's, this rank's frames kept."""
    if weight <= 0.0:
        return eps
    noise = frames_draw(lambda shape: sampler.sample_like(eps.new_empty(shape), generator),
                        eps.shape)
    return (1.0 - weight) * eps + weight * noise


@torch.no_grad()
def ddim_inversion(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                   cond_embedding: torch.Tensor, *,
                   num_inference_steps: int = 50, dependent_weight: float = 0.0,
                   dependent_sampler: Optional[DependentNoiseSampler] = None,
                   generator: Optional[torch.Generator] = None, attn_maps: bool = False):
    """``latents`` (B, F, h, w, C) clean scaled latents, ``cond_embedding``
    (B, L, D) source-prompt embedding → the trajectory
    (num_steps + 1, B, F, h, w, C) in float32, ``[0] = x_0``, ``[-1] = x_T``.
    Latents stay float32 whatever the UNet's compute dtype. With
    ``dependent_weight`` > 0 each step's prediction is blended with one draw
    of ``dependent_sampler``. ``attn_maps``: return ``(trajectory, attn)``,
    ``attn`` the stacked per-step attention record of the walk
    (:func:`_inversion_attn_record`), step axis x_0 → x_T."""
    latent = latents.float()
    generator = _dependent_generator(dependent_weight, dependent_sampler, generator,
                                     latent.device)
    trajectory = [latent]
    attn_steps = []
    for t in scheduler.timesteps(num_inference_steps)[::-1]:
        eps, store = unet_fn(latent, int(t), cond_embedding, None, store=attn_maps)
        eps = _dependent_blend(eps, dependent_weight, dependent_sampler, generator)
        latent = scheduler.next_step(eps, int(t), latent, num_inference_steps)
        trajectory.append(latent)
        if attn_maps:
            attn_steps.append(_inversion_attn_record(store, latent, cond_embedding))
    if attn_maps:
        return torch.stack(trajectory), stack_step_stats(attn_steps)
    return torch.stack(trajectory)


def _inversion_attn_record(store, latent: torch.Tensor, cond_embedding: torch.Tensor):
    """One inversion step's attention record: the conditional stream(s)
    only (no uncond stream runs)."""
    return attn_step_record(store, num_uncond=0, num_cond=latent.shape[0],
                            video_length=latent.shape[1], text_len=cond_embedding.shape[-2],
                            latent_hw=tuple(latent.shape[2:4]))


def _encode_temporal(leaf: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A captured bf16 temporal map in its storage dtype: as it is, float8
    by conversion, or int8 as round(p·127) (``CachedSource.base_tree_at``
    decodes)."""
    if dtype is None:
        return leaf
    if dtype.is_floating_point:
        return leaf.to(dtype)
    return torch.clamp(torch.round(leaf.float() * 127.0), -127.0, 127.0).to(dtype)


@torch.no_grad()
def ddim_inversion_captured(
    unet_fn: UNetFn,
    scheduler: DDIMScheduler,
    latents: torch.Tensor,
    cond_embedding: torch.Tensor,
    *,
    num_inference_steps: int = 50,
    cross_len: int = 0,
    self_window: Tuple[int, int] = (0, 0),
    capture_blend: bool = False,
    temporal_maps_dtype: Optional[torch.dtype] = None,
    dependent_weight: float = 0.0,
    dependent_sampler: Optional[DependentNoiseSampler] = None,
    generator: Optional[torch.Generator] = None,
    attn_maps: bool = False,
):
    """:func:`ddim_inversion` that also captures what a cached-source edit
    reads (see :mod:`videop2p_tpu_torch.pipelines.cached`):

      * the full per-head maps of the attn2 sites for edit steps
        [0, ``cross_len``), i.e. inversion steps [N − cross_len, N);
      * those of the attn_temp sites for edit steps [lo, hi) =
        ``self_window``, i.e. inversion steps [N − hi, N − lo), stored in
        ``temporal_maps_dtype`` (None: bf16; ``torch.float8_e4m3fn``; or
        ``torch.int8`` as round(p·127));
      * with ``capture_blend``, the source's LocalBlend maps at every step.

    The dependent-noise arguments are :func:`ddim_inversion`'s, one draw a
    step in walk order. The walk is split at the window edges; edit step *i*
    reads what inversion step N − 1 − i captured. Each captured map is written at its
    edit-step index into a buffer allocated at the first capture, so no
    per-step copies pile up. Returns ``(trajectory, CachedSource)``, and
    with ``attn_maps`` a third element: the source stream's stacked
    per-step attention record, in walk order (in the cached fast edit the
    only place the source's maps show, its stream having left the edit
    batch)."""
    N = num_inference_steps
    lo, hi = self_window
    if not 0 <= lo <= hi <= N:
        raise ValueError(f"self_window {self_window} outside [0, {N}]")
    if not 0 <= cross_len <= N:
        raise ValueError(f"cross_len {cross_len} outside [0, {N}]")
    latent = latents.float()
    generator = _dependent_generator(dependent_weight, dependent_sampler, generator,
                                     latent.device)
    video_length = latent.shape[1]
    latent_hw = tuple(latent.shape[2:4])
    text_len = cond_embedding.shape[-2]
    timesteps = scheduler.timesteps(N)[::-1]
    cross: Dict[str, torch.Tensor] = {}
    temporal: Dict[str, torch.Tensor] = {}
    blend_seq = None

    def put(buffers, store, site, index, length, encode):
        for path, leaf in filter_site_tree(store[BASE_STORE], site).items():
            leaf = encode(leaf)
            if path not in buffers:
                buffers[path] = leaf.new_empty((length, *leaf.shape))
            buffers[path][index] = leaf

    trajectory = [latent]
    attn_steps = []
    bounds = sorted({0, N - hi, N - lo, N - cross_len, N})
    for s, e in zip(bounds[:-1], bounds[1:]):
        want_cross = s >= N - cross_len
        want_temporal = s >= N - hi and e <= N - lo
        capture = want_cross or want_temporal
        control = AttnControl(None, 0, capture=True) if capture else None
        for j in range(s, e):
            t = int(timesteps[j])
            eps, store = unet_fn(latent, t, cond_embedding, control,
                                 store=capture or capture_blend or attn_maps)
            eps = _dependent_blend(eps, dependent_weight, dependent_sampler, generator)
            latent = scheduler.next_step(eps, t, latent, N)
            trajectory.append(latent)
            if attn_maps:
                attn_steps.append(_inversion_attn_record(store, latent, cond_embedding))
            i = N - 1 - j  # the edit step that reads this capture
            if capture_blend:
                maps = blend_maps_from_store(
                    store, latent_hw=latent_hw, video_length=video_length,
                    num_prompts=1, text_len=text_len, num_uncond=0).float()
                if blend_seq is None:
                    blend_seq = maps.new_empty((N, *maps.shape))
                blend_seq[i] = maps
            if want_cross:
                put(cross, store, "attn2", i, cross_len, lambda a: a)
            if want_temporal:
                put(temporal, store, "attn_temp", i - lo, hi - lo,
                    lambda a: _encode_temporal(a, temporal_maps_dtype))
    trajectory = torch.stack(trajectory)
    cached = CachedSource(
        src_latents=torch.flip(trajectory, dims=(0,)),
        cross_maps=cross or None, temporal_maps=temporal or None,
        blend_seq=blend_seq, cross_len=cross_len, self_window=(lo, hi))
    if attn_maps:
        return trajectory, cached, stack_step_stats(attn_steps)
    return trajectory, cached


def adam_update(param: torch.Tensor, grad: torch.Tensor, state: Optional[tuple],
                lr: float) -> Tuple[torch.Tensor, tuple]:
    """One step of ``optax.adam(1.0)`` (b1 0.9, b2 0.999, eps 1e-8, no
    eps_root), its update scaled by ``lr`` and applied: returns the new
    parameter and the state ``(mu, nu, count)``; ``state`` None is a fresh
    one. In the parameter's dtype, as optax computes it."""
    if state is None:
        state = (torch.zeros_like(param), torch.zeros_like(param), 0)
    mu, nu, count = state
    mu = (1 - _ADAM_B1) * grad + _ADAM_B1 * mu
    nu = (1 - _ADAM_B2) * grad ** 2 + _ADAM_B2 * nu
    count += 1
    # 1 − decay**count in float32, as optax's bias correction
    c1 = float(np.float32(1) - np.float32(_ADAM_B1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(_ADAM_B2) ** np.float32(count))
    update = -((mu / c1) / (torch.sqrt(nu / c2) + _ADAM_EPS))
    return param + lr * update, (mu, nu, count)


def check_null_text_options(precision: str, mode: str) -> None:
    """Raise on a null-text precision or mode the port does not take."""
    if precision not in NULL_TEXT_PRECISIONS:
        raise ValueError(f"null_text_precision {precision!r} not in {NULL_TEXT_PRECISIONS}")
    if mode not in NULL_TEXT_MODES:
        raise ValueError(f"null_text_mode {mode!r} not in {NULL_TEXT_MODES}")


@contextlib.contextmanager
def _frozen(unet_fn: UNetFn):
    """The module behind ``unet_fn`` (:func:`unet_module`; raises when it has
    none) with ``requires_grad`` off on every parameter, so that a backward
    to the embedding keeps no weight gradients or the activations only they
    need; the flags are restored afterwards."""
    params = list(unet_module(unet_fn).parameters())
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def _lr_and_threshold(i: int, epsilon: float) -> Tuple[float, float]:
    """Outer step i's Adam lr max(1e-2·(1 − i/100), 0) and early-stop
    threshold ε + i·2e-5, in float32 arithmetic as JAX's arrays."""
    lr = float(np.maximum(np.float32(1e-2) * (np.float32(1) - np.float32(i)
                                              / np.float32(100)), 0))
    thresh = float(np.float32(epsilon) + np.float32(i) * np.float32(2e-5))
    return lr, thresh


def _pack(embeddings, losses, inner_steps, return_losses: bool, return_inner_steps: bool,
          tel=None):
    """The embeddings (N, B, L, D), with the final losses (N,) and the
    inner steps (N,) int32 on the CPU where asked for, and the stacked
    per-outer-step latent statistics (on the device) when ``tel`` is
    given."""
    out = (torch.stack(embeddings),)
    if return_losses:
        out += (torch.stack(losses).float().cpu(),)
    if return_inner_steps:
        out += (torch.tensor(inner_steps, dtype=torch.int32),)
    if tel is not None:
        out += (stack_step_stats(tel),)
    return out if len(out) > 1 else out[0]


def _hybrid(fwd, scheduler: DDIMScheduler, trajectory: torch.Tensor,
            cond: torch.Tensor, *, num_inference_steps: int, guidance_scale: float,
            num_inner_steps: int,
            outer_chunk: Optional[int], dependent_weight: float,
            dependent_sampler: Optional[DependentNoiseSampler], seed: int,
            unet_fn: UNetFn, return_losses: bool, return_inner_steps: bool,
            telemetry: bool = False, program: Optional[str] = None):
    """The "hybrid" null-text mode (JAX: ``inversion.py:613-710``): K Adam
    steps per outer step from the cond embedding, against the recorded
    trajectory, each outer step on its own."""
    K = num_inner_steps
    if K < 1:
        raise ValueError(f"hybrid_inner_steps must be >= 1, got {K}")
    N = num_inference_steps
    timesteps = scheduler.timesteps(N)
    chunk = outer_chunk if outer_chunk and outer_chunk < N else N
    device = trajectory.device
    embeddings: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    tel: List[dict] = []

    def run_chunk(start: int, stop: int) -> None:
        for i in range(start, stop):
            t = int(timesteps[i])
            latent, latent_prev = trajectory[N - i], trajectory[N - i - 1]
            gen = (step_generator(seed, i, device) if dependent_weight > 0.0 else None)

            def blend(eps):
                return _dependent_blend(eps, dependent_weight, dependent_sampler, gen)

            lr, _ = _lr_and_threshold(i, 0.0)
            eps_cond = blend(fwd(latent, t, cond))
            uncond, state = cond.float(), None
            for _ in range(K):
                with torch.enable_grad():
                    leaf = uncond.detach().requires_grad_(True)
                    eps_u = blend(fwd(latent, t, leaf))
                    eps = eps_u + guidance_scale * (eps_cond - eps_u)
                    prev_rec = scheduler.prev_step(eps, t, latent, N)
                    loss = global_mean((prev_rec - latent_prev) ** 2)
                    (grad,) = reduce_frame_grads(torch.autograd.grad(loss, leaf))
                uncond, state = adam_update(uncond, grad, state, lr)
            losses.append(loss.detach())
            embeddings.append(uncond)
            if telemetry:
                # the last inner iteration's reconstruction, as JAX's
                tel.append(latent_stats(prev_rec.detach()))

    step = run_chunk if program is None else instrumented_program(run_chunk, program=program)
    with _frozen(unet_fn), torch.no_grad():
        for start in range(0, N, chunk):
            step(start, min(start + chunk, N))
    return _pack(embeddings, losses, [K] * N, return_losses, return_inner_steps,
                 tel if telemetry else None)


def null_text_optimization(
    unet_fn: UNetFn,
    scheduler: DDIMScheduler,
    trajectory: torch.Tensor,
    cond_embedding: torch.Tensor,
    uncond_embedding: torch.Tensor,
    *,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    num_inner_steps: int = 10,
    epsilon: float = 1e-5,
    null_text_precision: str = "fp32",
    null_text_mode: str = "optimize",
    hybrid_inner_steps: int = 3,
    early_stop: bool = True,
    return_losses: bool = False,
    return_inner_steps: bool = False,
    dependent_weight: float = 0.0,
    dependent_sampler: Optional[DependentNoiseSampler] = None,
    generator: Optional[torch.Generator] = None,
    outer_chunk: Optional[int] = None,
    telemetry: bool = False,
):
    """Optimize a per-step unconditional embedding under which CFG denoising
    replays the recorded inversion trajectory (the reference's
    run_videop2p.py:580-612; JAX: pipelines/inversion.py:353-757).

    ``trajectory`` (N + 1, B, F, h, w, C) from :func:`ddim_inversion`;
    ``cond_embedding`` / ``uncond_embedding`` (B, L, D). Outer step i walks
    x_t → x_{t−Δ} and fits the embedding against ``trajectory[N − i − 1]``
    by minimizing mean((prev_step(ε_u + g·(ε_c − ε_u)) − x_{t−Δ})²) over the
    uncond embedding with Adam (``optax.adam(1.0)``, a fresh state each outer
    step, the step scaled by lr_i = max(1e-2·(1 − i/100), 0)), starting from
    the previous step's result. With ``early_stop`` the inner loop stops
    once a loss falls below ε + i·2e-5 (the update of that step is kept),
    else after ``num_inner_steps``. The step then advances under full CFG
    with the optimized embedding.

      * ``null_text_mode``: ``"optimize"`` (the loop above);
        ``"amortized"`` (uncond := cond at every step, so the CFG combine is
        the conditional prediction: one forward per outer step, no
        backward, ``inner_steps`` 0); ``"hybrid"`` (outer step i starts
        from the cond embedding and takes ``hybrid_inner_steps`` (K) Adam
        steps against the *recorded* trajectory, entering at
        ``trajectory[N − i]`` and fitting ``trajectory[N − i − 1]``, no
        early stop: the outer steps are independent, so this loop computes
        what JAX's ``vmap`` over them computes; ``final_loss`` is the last
        pre-update loss and ``inner_steps`` reads K; with dependent noise
        step i draws from its own generator, seeded from (``generator``'s
        seed, i), as JAX's ``fold_in(key, i)``).
      * ``null_text_precision``: ``"fp32"``, or ``"mixed"``: the latents
        and embeddings cross the UNet boundary in bf16 (pass a bf16 clone
        of the UNet as ``unet_fn``) and the predictions come back as f32;
        the scheduler, Adam and the loss stay f32.

    With ``dependent_weight`` > 0 every prediction is blended with a fresh
    draw (after the float32 upcast), in the JAX package's order per outer
    step: the cond prediction's, one for each inner loss evaluation (so
    early stop changes how many an outer step takes), then the advance's
    uncond and cond draws ("amortized": those two only). The cond
    prediction keeps its draw through the inner loop; gradients flow through
    the (1 − w)·ε̂ term only.

    ``unet_fn`` must come from ``make_unet_fn``: its module's parameters
    are frozen for the run (a TypeError otherwise), and each loss is taken
    under ``torch.enable_grad()``. The JAX package splits this loop into
    jitted chunks (``outer_chunk``, ``null_text_optimization_fused``) for
    dispatch and the TPU's watchdog; eagerly those are this one loop,
    walked chunk by chunk with the same numbers (chunked equals
    unchunked). With ``outer_chunk`` < N each chunk of outer steps is one
    call of an ``instrumented_program`` labelled "null_text_chunked" (the
    JAX package's label of its chunk programs), so a run ledger records
    each chunk's dispatch.

    ``telemetry``: also return each outer step's latent statistics
    (``obs/telemetry.py:latent_stats`` of the advanced latent; "hybrid":
    of its last inner reconstruction), stacked on the device, as the last
    element.

    Returns the embeddings (N, B, L, D) float32, plus, with
    ``return_losses``, the final inner loss of each outer step (N,) (the
    last pre-update loss; the amortized replay's loss) and, with
    ``return_inner_steps``, the inner Adam steps each took (N,) int32, both
    on the CPU."""
    check_null_text_options(null_text_precision, null_text_mode)
    N = num_inference_steps
    trajectory = trajectory.float()
    generator = _dependent_generator(dependent_weight, dependent_sampler, generator,
                                     trajectory.device)
    uncond = uncond_embedding.float()
    cond = cond_embedding
    mixed = null_text_precision == "mixed"

    def fwd(latent, t, text):
        if mixed:
            latent, text = latent.to(torch.bfloat16), text.to(torch.bfloat16)
        eps, _ = unet_fn(latent, t, text, None, store=False)
        return eps.float()

    def blend(eps):
        return _dependent_blend(eps, dependent_weight, dependent_sampler, generator)

    def cfg_step(eps_uncond, eps_cond, t, latent):
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        return scheduler.prev_step(eps, t, latent, N)

    chunk = outer_chunk if outer_chunk and outer_chunk < N else N
    program = "null_text_chunked" if chunk < N else None
    if null_text_mode == "hybrid":
        return _hybrid(fwd, scheduler, trajectory, cond, num_inference_steps=N,
                       guidance_scale=guidance_scale,
                       num_inner_steps=int(hybrid_inner_steps), outer_chunk=outer_chunk,
                       dependent_weight=dependent_weight, dependent_sampler=dependent_sampler,
                       seed=generator.initial_seed() if generator is not None else 0,
                       unet_fn=unet_fn, return_losses=return_losses,
                       return_inner_steps=return_inner_steps, telemetry=telemetry,
                       program=program)

    timesteps = scheduler.timesteps(N)
    embeddings: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    inner_steps: List[int] = []
    tel: List[dict] = []
    carry = {"latent": trajectory[-1], "uncond": uncond}

    def run_chunk(start: int, stop: int) -> None:
        latent_cur, uncond = carry["latent"], carry["uncond"]
        for i in range(start, stop):
            t = int(timesteps[i])
            latent_prev = trajectory[N - i - 1]
            eps_cond_raw = fwd(latent_cur, t, cond)
            if null_text_mode == "amortized":
                uncond = cond.float()
                eps_fu = blend(eps_cond_raw)
                latent_cur = cfg_step(eps_fu, blend(eps_cond_raw), t, latent_cur)
                losses.append(global_mean((latent_cur - latent_prev) ** 2))
                inner_steps.append(0)
                embeddings.append(uncond)
            else:
                lr, thresh = _lr_and_threshold(i, epsilon)
                eps_cond = blend(eps_cond_raw)
                state, loss, j = None, torch.tensor(float("inf")), 0
                while j < num_inner_steps and (not early_stop or loss.item() >= thresh):
                    with torch.enable_grad():
                        leaf = uncond.detach().requires_grad_(True)
                        prev_rec = cfg_step(blend(fwd(latent_cur, t, leaf)), eps_cond, t,
                                            latent_cur)
                        # on a frame-sharded mesh: the global loss on every
                        # rank (so every rank stops at the same inner step)
                        # and the gradient summed over the frames group
                        loss = global_mean((prev_rec - latent_prev) ** 2)
                        (grad,) = reduce_frame_grads(torch.autograd.grad(loss, leaf))
                    loss = loss.detach()
                    uncond, state = adam_update(uncond, grad, state, lr)
                    j += 1
                losses.append(loss.to(latent_cur.device))
                inner_steps.append(j)
                embeddings.append(uncond)
                # the advance's uncond draw, then its cond draw (JAX's k_fu, k_fc)
                eps_fu = blend(fwd(latent_cur, t, uncond))
                latent_cur = cfg_step(eps_fu, blend(eps_cond_raw), t, latent_cur)
            if telemetry:
                tel.append(latent_stats(latent_cur))
        carry["latent"], carry["uncond"] = latent_cur, uncond

    step = run_chunk if program is None else instrumented_program(run_chunk, program=program)
    with _frozen(unet_fn), torch.no_grad():
        for start in range(0, N, chunk):
            step(start, min(start + chunk, N))
    return _pack(embeddings, losses, inner_steps, return_losses, return_inner_steps,
                 tel if telemetry else None)
