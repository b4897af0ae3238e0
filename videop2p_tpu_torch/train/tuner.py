"""Stage-1 one-shot tuning: the optimizer, the train state and the train
step (port of ``videop2p_tpu/train/tuner.py``).

  * Only the trainable subset (``train/masking.py``) is differentiated and
    optimized; the frozen parameters carry ``requires_grad=False``.
  * The optimizer is optax's ``chain(clip_by_global_norm, adamw)`` written
    out on the trainable tensors (:class:`ClippedAdamW`), with
    ``optax.MultiSteps``' gradient accumulation: the running mean of k
    gradients, one inner update every k-th step, the lr schedule counting
    inner updates.
  * A step draws i.i.d. or frame-dependent noise (``core/noise.py``) and
    one timestep per video from a ``torch.Generator``; ε or v target; MSE
    in float32.
  * :func:`train_steps` is a loop whose step ``s`` draws from a generator
    seeded from (run seed, s) (:func:`step_generator`, JAX's
    ``fold_in(key, step)``): how the steps are chunked, and where a run is
    resumed, cannot change the trajectory. Its step body replays as a CUDA
    graph on a CUDA device, on one card or a mesh (``utils/cuda_graphs.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from videop2p_tpu_torch.core.ddpm import DDPMScheduler
from videop2p_tpu_torch.core.noise import DependentNoiseSampler, step_generator
from videop2p_tpu_torch.parallel.mesh import frames_draw, global_mean, reduce_frame_grads
from videop2p_tpu_torch.train.masking import DEFAULT_TRAINABLE, merge_params, partition_params
from videop2p_tpu_torch.utils import cuda_graphs as graphs_mod

__all__ = ["TuneConfig", "make_lr_schedule", "ClippedAdamW", "make_optimizer",
           "TrainState", "global_norm", "step_generator", "train_step", "train_steps"]


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Training hyperparameters (the reference's defaults)."""

    learning_rate: float = 3e-5
    scale_lr: bool = False
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 500
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    trainable_modules: Tuple[str, ...] = DEFAULT_TRAINABLE
    train_batch_size: int = 1
    num_processes: int = 1


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps) at ``count``."""
    count = min(max(count, 0), steps)
    return (init - end) * (1.0 - count / steps) + end


def _cosine(init: float, steps: int, count: int) -> float:
    """optax.cosine_decay_schedule(init, steps) at ``count``."""
    count = min(count, steps)
    return init * 0.5 * (1.0 + math.cos(math.pi * count / steps))


def make_lr_schedule(cfg: TuneConfig) -> Callable[[int], float]:
    """lr at a step, by name: the closed forms of JAX's optax schedules
    (``join_schedules`` of a warmup ramp over ``max(warmup, 1)`` steps and
    the decay over ``max(total − warmup, 1)``; "constant" has no warmup)."""
    lr = cfg.learning_rate
    if cfg.scale_lr:
        lr = lr * cfg.gradient_accumulation_steps * cfg.train_batch_size * cfg.num_processes
    total = max(cfg.max_train_steps, 1)
    warmup = cfg.lr_warmup_steps
    decay_steps = max(total - warmup, 1)
    if cfg.lr_scheduler == "constant":
        return lambda step: lr
    if cfg.lr_scheduler == "constant_with_warmup":
        after = lambda count: lr  # noqa: E731
    elif cfg.lr_scheduler == "linear":
        after = lambda count: _linear(lr, 0.0, decay_steps, count)  # noqa: E731
    elif cfg.lr_scheduler == "cosine":
        after = lambda count: _cosine(lr, decay_steps, count)  # noqa: E731
    else:
        raise ValueError(f"unknown lr_scheduler: {cfg.lr_scheduler!r}")

    def schedule(step: int) -> float:
        if step < warmup:
            return _linear(0.0, lr, max(warmup, 1), step)
        return after(step - warmup)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor],
                params: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """√(Σ x²) over every element of ``tensors``, in float32 (optax's). With
    ``params`` (the tensors' parameters, in order) on a tensor-parallel
    mesh, a tensor whose parameter is split over ``tensor``
    (``parallel/mesh.py:shard_unet``) counts once across the group: its
    squares are summed over it."""
    if not tensors:
        return torch.zeros(())
    sharded = [getattr(p, "tp_shard_dim", None) is not None for p in params or ()]
    if not any(sharded):
        return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))
    from videop2p_tpu_torch.parallel.mesh import sharded_square_sum

    whole = sum((t.float() ** 2).sum() for t, s in zip(tensors, sharded) if not s)
    split = sum((t.float() ** 2).sum() for t, s in zip(tensors, sharded) if s)
    return torch.sqrt(whole + sharded_square_sum(split))


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adamw(...))``,
    wrapped in ``MultiSteps(every_k=accumulate)`` when ``accumulate`` > 1,
    applied in place. The state holds float32 moments ``mu``/``nu`` in the
    order of the parameters, the inner-update ``count``, and with
    accumulation the gradients' running mean ``acc`` and ``mini_step``.

    An update is a host part, :meth:`plan_` (the counters, and the step's
    lr, bias corrections and running-mean divisor written into device
    scalars, :meth:`scalars`), and a device part, :meth:`apply_`, which
    reads only those scalars: a CUDA graph of a train step replays it.
    :meth:`update_` is the two in turn."""

    def __init__(self, lr_schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-2,
                 max_grad_norm: float = 1.0, accumulate: int = 1):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.accumulate = int(accumulate)

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        state = {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.accumulate > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in params]
        return state

    @staticmethod
    def scalars(device) -> Dict[str, torch.Tensor]:
        """The device scalars :meth:`plan_` writes and :meth:`apply_` reads:
        ``lr``, ``bc1``, ``bc2`` (the bias corrections) and ``acc_div`` (the
        running mean's divisor), 0-d float32."""
        return {name: torch.zeros((), dtype=torch.float32, device=device)
                for name in ("lr", "bc1", "bc2", "acc_div")}

    @torch.no_grad()
    def plan_(self, state: dict, scalars: Dict[str, torch.Tensor], has_grads: bool) -> str:
        """The host part of one update: advances ``state``'s counters,
        writes this update's scalars, and returns its phase: "accumulate"
        (the running mean only), "apply" (an optimizer step) or "skip" (an
        empty trainable set: the update counts and nothing moves)."""
        if self.accumulate > 1:
            n = state["mini_step"]
            scalars["acc_div"].fill_(n + 1)
            if n + 1 < self.accumulate:
                state["mini_step"] = n + 1
                return "accumulate"
            state["mini_step"] = 0
        if not has_grads:
            state["count"] += 1
            return "skip"
        scalars["lr"].fill_(self.lr_schedule(state["count"]))
        state["count"] += 1
        count = state["count"]
        for name, b in (("bc1", self.b1), ("bc2", self.b2)):
            scalars[name].copy_(1.0 - torch.full((), b, dtype=torch.float32,
                                                 device=scalars[name].device) ** count)
        return "apply"

    @torch.no_grad()
    def apply_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               state: dict, scalars: Dict[str, torch.Tensor], phase: str) -> None:
        """The device part of the update :meth:`plan_` planned as ``phase``,
        on ``params`` in place: no value from the host."""
        if self.accumulate > 1:
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / scalars["acc_div"])
            if phase == "accumulate":
                return
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
        if phase == "skip":
            return
        norm = global_norm(grads, params)
        grads = [torch.where(norm < self.max_grad_norm, g, g / norm * self.max_grad_norm)
                 for g in grads]
        bc1, bc2, neg_lr = scalars["bc1"], scalars["bc2"], -scalars["lr"]
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * g ** 2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(update * neg_lr)

    def update_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                state: dict) -> bool:
        """One optimizer step on ``params`` in place; with accumulation only
        every k-th call updates. Returns whether the parameters moved."""
        grads = list(grads)
        device = grads[0].device if grads else torch.device("cpu")
        scalars = self.scalars(device)
        phase = self.plan_(state, scalars, bool(grads))
        self.apply_(params, grads, state, scalars, phase)
        return phase == "apply"


def make_optimizer(cfg: TuneConfig) -> ClippedAdamW:
    """The clipped, accumulating AdamW of ``cfg``."""
    return ClippedAdamW(make_lr_schedule(cfg), b1=cfg.adam_beta1, b2=cfg.adam_beta2,
                        eps=cfg.adam_epsilon, weight_decay=cfg.adam_weight_decay,
                        max_grad_norm=cfg.max_grad_norm,
                        accumulate=cfg.gradient_accumulation_steps)


@dataclasses.dataclass
class TrainState:
    """The step count, the UNet's trainable and frozen parameters by name
    (the module's own tensors: a step updates the trainable ones in place)
    and the optimizer state."""

    step: int
    trainable: Dict[str, nn.Parameter]
    frozen: Dict[str, nn.Parameter]
    opt_state: dict

    @classmethod
    def create(cls, module: nn.Module, tx: ClippedAdamW,
               trainable_modules: Sequence[str] = DEFAULT_TRAINABLE) -> "TrainState":
        trainable, frozen = partition_params(module, trainable_modules)
        return cls(step=0, trainable=trainable, frozen=frozen,
                   opt_state=tx.init(list(trainable.values())))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Every parameter by name (for validation and export)."""
        return merge_params(self.trainable, self.frozen)


def _draw(generator: Optional[torch.Generator], latents: torch.Tensor,
          scheduler: DDPMScheduler, dependent_sampler: Optional[DependentNoiseSampler]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A step's noise (through ``dependent_sampler`` when given), then one
    timestep per video, drawn from ``generator``. On a frame-sharded mesh
    every rank draws the whole clip's noise and keeps its frames: the
    timestep draw after it is the same everywhere."""
    if dependent_sampler is not None:
        noise = frames_draw(lambda shape: dependent_sampler.sample_like(
            latents.new_empty(shape), generator), latents.shape)
    else:
        noise = frames_draw(lambda shape: torch.randn(
            shape, generator=generator, device=latents.device,
            dtype=latents.dtype), latents.shape)
    timesteps = torch.randint(0, scheduler.num_train_timesteps, (latents.shape[0],),
                              generator=generator, device=latents.device)
    return noise, timesteps


def _loss_and_grads(unet_fn, scheduler: DDPMScheduler, latents: torch.Tensor,
                    text_embeddings: torch.Tensor, noise: torch.Tensor,
                    timesteps: torch.Tensor, params: List[torch.Tensor]):
    """The step's MSE in float32 and its gradients on ``params`` (none for
    an empty trainable set)."""
    noisy = scheduler.add_noise(latents, noise, timesteps)
    target = scheduler.training_target(latents, noise, timesteps)
    with torch.enable_grad():
        pred, _ = unet_fn(noisy, timesteps, text_embeddings, None, store=False)
        loss = global_mean((pred.float() - target.float()) ** 2)
        # an empty trainable set still takes the step (JAX's train_step);
        # on a frame-sharded mesh the gradients are summed over the frames
        # group (JAX's implicit psum)
        grads = reduce_frame_grads(torch.autograd.grad(loss, params)) if params else []
    return loss.detach(), grads


def train_step(unet_fn, tx: ClippedAdamW, state: TrainState, scheduler: DDPMScheduler,
               latents: torch.Tensor, text_embeddings: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               noise: Optional[torch.Tensor] = None,
               timesteps: Optional[torch.Tensor] = None,
               dependent_sampler: Optional[DependentNoiseSampler] = None,
               return_grad_norm: bool = False):
    """One tuning step on clean latents (B, F, h, w, C) (already ×0.18215)
    and text embeddings (B, L, D). The noise (through ``dependent_sampler``
    when given) and one timestep per video are drawn from ``generator``,
    unless ``noise`` / ``timesteps`` are passed. Returns ``(state, loss)``,
    or ``(state, loss, grad_norm)`` with ``return_grad_norm``: the global
    norm of the step's gradients before clipping. ``state`` is updated in
    place; the loss stays on the device."""
    if noise is None or timesteps is None:
        drawn_noise, drawn_t = _draw(generator, latents, scheduler, dependent_sampler)
        noise = drawn_noise if noise is None else noise
        timesteps = drawn_t if timesteps is None else timesteps
    timesteps = torch.as_tensor(timesteps, device=latents.device)
    params: List[torch.Tensor] = list(state.trainable.values())
    loss, grads = _loss_and_grads(unet_fn, scheduler, latents, text_embeddings, noise,
                                  timesteps, params)
    grad_norm = global_norm(grads, params) if return_grad_norm else None
    tx.update_(params, grads, state.opt_state)
    state.step += 1
    if return_grad_norm:
        return state, loss, grad_norm
    return state, loss


def train_steps(unet_fn, tx: ClippedAdamW, state: TrainState, scheduler: DDPMScheduler,
                latents: torch.Tensor, text_embeddings: torch.Tensor, seed: int, *,
                num_steps: int, dependent_sampler: Optional[DependentNoiseSampler] = None,
                telemetry: bool = False, cuda_graphs: Optional[bool] = None):
    """``num_steps`` tuning steps, step ``s`` drawing from
    ``step_generator(seed, s)``. Returns ``(state, losses (num_steps,))``,
    the losses still on the device; with ``telemetry`` ``(state, losses,
    grad_norms)``, each step's global gradient norm before clipping (the
    quantity ``max_grad_norm`` gates), also on the device.

    Each step draws its noise and timesteps into buffers and plans the
    optimizer's update on the host (:meth:`ClippedAdamW.plan_`), then runs
    the step body (forward, backward, gradient norm, the update), keyed by
    the update's phase and replayed as a CUDA graph as ``cuda_graphs``
    decides (None: on a CUDA device, on one card or a mesh; False: the eager loop,
    the same bits; ``utils/cuda_graphs.py``)."""
    device = latents.device
    params: List[torch.Tensor] = list(state.trainable.values())
    noise = torch.empty_like(latents)
    timesteps = torch.empty((latents.shape[0],), dtype=torch.int64, device=device)
    scalars = tx.scalars(device)

    def body(phase: str):
        loss, grads = _loss_and_grads(unet_fn, scheduler, latents, text_embeddings, noise,
                                      timesteps, params)
        grad_norm = global_norm(grads, params) if telemetry else None
        tx.apply_(params, grads, state.opt_state, scalars, phase)
        return loss, grad_norm

    losses, norms = [], []
    with graphs_mod.step_graphs(cuda_graphs, device, "train_steps") as graphs:
        for _ in range(num_steps):
            drawn_noise, drawn_t = _draw(step_generator(seed, state.step, device), latents,
                                         scheduler, dependent_sampler)
            noise.copy_(drawn_noise)
            timesteps.copy_(drawn_t)
            phase = tx.plan_(state.opt_state, scalars, bool(params))
            loss, grad_norm = graphs.kept(graphs.run(phase, body, phase))
            state.step += 1
            losses.append(loss)
            if telemetry:
                norms.append(grad_norm)
    if telemetry:
        return state, torch.stack(losses), torch.stack(norms)
    return state, torch.stack(losses)
