"""Consistency distillation: the few-step student (port of
``videop2p_tpu/train/distill.py``).

The student is the tuned UNet with Stage 1's trainable subset
(``train/masking.py``) trained again, plus a small time-conditioning head
that modulates ε per latent channel. The head's output layer starts at
zero, so an untrained student is the teacher bit for bit. The loss is
self-consistency along the DDIM trajectory: for a random grid point t_n the
frozen teacher takes one DDIM skip-step x_{t_n} → x_{t_{n−1}}, an EMA target
network predicts x₀ at the landing point, and the student's x₀ prediction at
t_n regresses onto it; at the grid's last point the target is the data x₀
(the boundary condition).

Memory: the teacher snapshot and the EMA target hold the trainable subset
only (about a tenth of the UNet); their forwards run the student's module
with that subset swapped in (``torch.func.functional_call``), so the frozen
majority exists once. The optimizer is Stage 1's clipped AdamW
(``train/tuner.py``) over the subset and the head together. A step draws
its noise and grid indices from a generator seeded from (run seed, step)
(``step_generator``), so how :func:`distill_steps` is chunked cannot change
the student.

Inference needs the distilled subset and :func:`apply_time_head`: the
cached edit (``pipelines/sampling.py:edit_sample(student_head=)``) replays
the source stream from the capture, so ``src_err`` stays 0.0.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.core.noise import step_generator
from videop2p_tpu_torch.models.layers import get_timestep_embedding
from videop2p_tpu_torch.pipelines.sampling import UNetFn, unet_module
from videop2p_tpu_torch.train.masking import DEFAULT_TRAINABLE, partition_params, trainable_mask
from videop2p_tpu_torch.train.tuner import ClippedAdamW, TuneConfig, global_norm, make_optimizer

__all__ = ["DistillConfig", "DistillState", "init_time_head", "apply_time_head",
           "make_distill_optimizer", "distill_step", "distill_steps", "save_student",
           "load_student"]

Head = Dict[str, torch.Tensor]
_HEAD_KEYS = ("dense1.kernel", "dense1.bias", "dense2.kernel", "dense2.bias")
_FILE = "student.pt"


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Distillation hyperparameters (CLI: ``--distill_*``)."""

    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 200
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    trainable_modules: Tuple[str, ...] = DEFAULT_TRAINABLE
    # the DDIM grid the self-consistency chain walks (the teacher's solver)
    distill_grid: int = 50
    # EMA decay of the target network
    ema_decay: float = 0.95
    # loss weight of the boundary term (the grid's last point, target x₀)
    boundary_weight: float = 1.0


def make_distill_optimizer(cfg: DistillConfig) -> ClippedAdamW:
    """Stage 1's clipped, accumulating AdamW with the distillation's
    hyperparameters."""
    return make_optimizer(TuneConfig(
        learning_rate=cfg.learning_rate, lr_scheduler=cfg.lr_scheduler,
        lr_warmup_steps=cfg.lr_warmup_steps, max_train_steps=cfg.max_train_steps,
        max_grad_norm=cfg.max_grad_norm,
        gradient_accumulation_steps=cfg.gradient_accumulation_steps,
        trainable_modules=cfg.trainable_modules))


# ------------------------------------------------- time-conditioning head --


def init_time_head(generator: torch.Generator, config, *, device=None) -> Head:
    """The student's time-conditioning head: a 2-layer MLP over the UNet's
    sinusoidal timestep embedding (``config.block_out_channels[0]`` wide)
    giving a per-latent-channel (scale, shift). The first kernel is drawn
    from ``generator``; the output layer is zero, so a fresh head leaves ε
    as it is. Kernels are (in, out), as JAX's."""
    embed = int(config.block_out_channels[0])
    channels = int(config.out_channels)
    device = device if device is not None else generator.device
    kernel = torch.randn((embed, embed), generator=generator, device=device)
    return {"dense1.kernel": kernel * (1.0 / math.sqrt(embed)),
            "dense1.bias": torch.zeros(embed, device=device),
            "dense2.kernel": torch.zeros((embed, 2 * channels), device=device),
            "dense2.bias": torch.zeros(2 * channels, device=device)}


def apply_time_head(head: Head, eps: torch.Tensor, timestep) -> torch.Tensor:
    """ε′ = ε·(1 + scale(t)) + shift(t) per latent channel, in float32, cast
    back to ε's dtype. ``timestep`` () broadcasts over every stream of
    ``eps``; (B,) pairs with its leading axis. A zero output layer gives ε
    exactly."""
    embed = head["dense1.kernel"].shape[0]
    t = torch.as_tensor(timestep, device=eps.device)
    emb = get_timestep_embedding(t, embed)  # (1|B, embed) float32
    h = F.silu(emb @ head["dense1.kernel"].float() + head["dense1.bias"].float())
    out = h @ head["dense2.kernel"].float() + head["dense2.bias"].float()
    channels = out.shape[-1] // 2
    shape = (out.shape[0],) + (1,) * (eps.dim() - 2) + (channels,)
    scale = out[..., :channels].reshape(shape)
    shift = out[..., channels:].reshape(shape)
    return (eps.float() * (1.0 + scale) + shift).to(eps.dtype)


# --------------------------------------------------------- state / losses --


def _snapshot(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


@dataclasses.dataclass
class DistillState:
    """The student (the UNet's own trainable parameters by name, and the
    head, updated in place), the teacher's snapshot of the trainable subset,
    the EMA target's subset and head, and the optimizer state over the
    subset followed by the head."""

    step: int
    trainable: Dict[str, nn.Parameter]
    head: Head
    teacher_trainable: Dict[str, torch.Tensor]
    ema_trainable: Dict[str, torch.Tensor]
    ema_head: Head
    opt_state: dict

    @classmethod
    def create(cls, module: nn.Module, head: Head, tx: ClippedAdamW,
               trainable_modules: Sequence[str] = DEFAULT_TRAINABLE) -> "DistillState":
        trainable, _ = partition_params(module, trainable_modules)
        head = {k: head[k].detach().clone().requires_grad_(True) for k in _HEAD_KEYS}
        return cls(step=0, trainable=trainable, head=head,
                   teacher_trainable=_snapshot(trainable),
                   ema_trainable=_snapshot(trainable), ema_head=_snapshot(head),
                   opt_state=tx.init(list(trainable.values()) + list(head.values())))


def _pred_x0(scheduler: DDIMScheduler, eps: torch.Tensor, t: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """x₀ from an ε prediction at (B,) timesteps, in float32."""
    eps, x = eps.float(), x.float()
    a, b = scheduler.alpha_coefficients(t, x)
    return (x - b * eps) / a


def _ddim_solve(scheduler: DDIMScheduler, eps: torch.Tensor, t: torch.Tensor,
                t_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM solve x_t → x_{t_prev} at (B,) timesteps, in
    float32; ``t_prev < 0`` lands on ``final_alpha_cumprod``, as the
    sampler's last step does."""
    x0 = _pred_x0(scheduler, eps, t, x)
    a_p, b_p = scheduler.alpha_coefficients(t_prev.clamp(min=0), x)
    final = torch.tensor(scheduler.final_alpha_cumprod, dtype=torch.float32,
                         device=x.device)
    landed = (t_prev >= 0).reshape(a_p.shape)
    a_p = torch.where(landed, a_p, torch.sqrt(final))
    b_p = torch.where(landed, b_p, torch.sqrt(1.0 - final))
    return a_p * x0 + b_p * eps.float()


def distill_step(unet_fn: UNetFn, tx: ClippedAdamW, state: DistillState,
                 scheduler: DDIMScheduler, latents: torch.Tensor,
                 text_embeddings: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, cfg: DistillConfig,
                 noise: Optional[torch.Tensor] = None, n: Optional[torch.Tensor] = None,
                 return_grad_norm: bool = False):
    """One consistency-distillation step on clean latents (B, F, h, w, C).

    Draws the noise and one grid index n per video from ``generator``
    (unless ``noise`` / ``n`` are passed), noises x₀ to x_{t_n}, solves one
    teacher DDIM skip-step to x_{t_{n−1}}, and regresses the student's x₀
    prediction at t_n onto the EMA target's at the landing point, or onto
    x₀ itself at the grid's last point. Updates ``state`` in place (the
    student's tensors are the UNet's own) and returns ``(state, loss)``, or
    ``(state, loss, grad_norm)``: the pre-clip global norm of the subset's
    and the head's gradients. The loss stays on the device."""
    module = unet_module(unet_fn)
    dev = latents.device
    grid = int(cfg.distill_grid)
    ts_np = scheduler.timesteps(grid)
    ratio = scheduler.num_train_timesteps // grid
    # where step n lands: the next grid timestep; the last lands below 0
    prev_np = np.append(ts_np[1:], ts_np[-1] - ratio)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev,
                            dtype=latents.dtype)
    if n is None:
        n = torch.randint(0, grid, (latents.shape[0],), generator=generator, device=dev)
    n = torch.as_tensor(n, device=dev)
    t_hi = torch.as_tensor(ts_np, device=dev)[n]
    t_lo = torch.as_tensor(prev_np, device=dev)[n]
    t_lo_in = t_lo.clamp(min=0)  # the EMA net never sees a negative t
    boundary = (t_lo < 0).reshape((-1,) + (1,) * (latents.dim() - 1))
    x_hi = scheduler.add_noise(latents, noise, t_hi)

    def forward(subset: Dict[str, torch.Tensor], x, t):
        return torch.func.functional_call(module, subset, (x, t, text_embeddings))

    with torch.no_grad():
        # the frozen teacher's skip-step and the EMA target's x₀ at the
        # landing point: none of it depends on what is differentiated
        x_lo = _ddim_solve(scheduler, forward(state.teacher_trainable, x_hi, t_hi),
                           t_hi, t_lo, x_hi)
        eps_e = apply_time_head(state.ema_head, forward(state.ema_trainable, x_lo, t_lo_in),
                                t_lo_in)
        target = torch.where(boundary, latents.float(),
                             _pred_x0(scheduler, eps_e, t_lo_in, x_lo))
        weight = torch.where(boundary, torch.tensor(float(cfg.boundary_weight), device=dev),
                             torch.tensor(1.0, device=dev))

    params = list(state.trainable.values()) + list(state.head.values())
    with torch.enable_grad():
        eps_s, _ = unet_fn(x_hi, t_hi, text_embeddings, None, store=False)
        eps_s = apply_time_head(state.head, eps_s, t_hi)
        x0_s = _pred_x0(scheduler, eps_s, t_hi, x_hi)
        loss = torch.mean(weight * (x0_s - target) ** 2)
        grads = torch.autograd.grad(loss, params)
    grad_norm = global_norm(grads) if return_grad_norm else None
    tx.update_(params, grads, state.opt_state)
    with torch.no_grad():
        d = torch.tensor(cfg.ema_decay, dtype=torch.float32, device=dev)
        for ema, src in ((state.ema_trainable, state.trainable), (state.ema_head, state.head)):
            for name, e in ema.items():
                e.copy_((d * e.float() + (1.0 - d) * src[name].float()).to(e.dtype))
    state.step += 1
    if return_grad_norm:
        return state, loss.detach(), grad_norm
    return state, loss.detach()


def distill_steps(unet_fn: UNetFn, tx: ClippedAdamW, state: DistillState,
                  scheduler: DDIMScheduler, latents: torch.Tensor,
                  text_embeddings: torch.Tensor, seed: int, *, num_steps: int,
                  cfg: DistillConfig):
    """``num_steps`` distillation steps, step ``s`` drawing from
    ``step_generator(seed, s)``: chunking and resume points cannot change
    the student. Returns ``(state, losses)``, the losses on the device."""
    losses = []
    for _ in range(num_steps):
        state, loss = distill_step(unet_fn, tx, state, scheduler, latents, text_embeddings,
                                   step_generator(seed, state.step, latents.device), cfg=cfg)
        losses.append(loss)
    return state, torch.stack(losses)


# ----------------------------------------------------- student checkpoints --


def save_student(output_dir: str, state: DistillState, step: int) -> str:
    """Write the servable student, the distilled subset by name and the
    head, to ``<output_dir>/checkpoint-<step>``; returns its path."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(step),
               "trainable": {k: v.detach().cpu().clone() for k, v in state.trainable.items()},
               "head": {k: v.detach().cpu().clone() for k, v in state.head.items()}}
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


@torch.no_grad()
def load_student(path: str, unet: nn.Module, config,
                 trainable_modules: Sequence[str] = DEFAULT_TRAINABLE
                 ) -> Tuple[Dict[str, torch.Tensor], Head]:
    """``(student_params, head)`` from a student checkpoint: the UNet's
    parameters by name with the distilled subset over ``unet``'s own frozen
    majority (the teacher's), and the head, on ``unet``'s device and in its
    dtypes. ``config``, the UNet's config, fixes the head's shapes. Raises
    when the checkpoint distils another subset or another head."""
    payload = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    mask = trainable_mask(unet, trainable_modules)
    own = dict(unet.named_parameters())
    names = [k for k in own if mask[k]]
    if sorted(payload["trainable"]) != sorted(names):
        raise ValueError(f"student checkpoint {path!r} distils another parameter set")
    template = init_time_head(torch.Generator().manual_seed(0), config, device="cpu")
    if {k: tuple(v.shape) for k, v in payload["head"].items()} != {
            k: tuple(v.shape) for k, v in template.items()}:
        raise ValueError(f"student checkpoint {path!r} holds a head of other shapes")
    device = next(iter(own.values())).device
    params = {k: (payload["trainable"][k].to(device, p.dtype) if mask[k] else p.detach())
              for k, p in own.items()}
    head = {k: v.to(device) for k, v in payload["head"].items()}
    return params, head
