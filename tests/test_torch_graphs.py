"""The port's graphed step loops on the CPU (``utils/cuda_graphs.py``): the
cached fast edit's capture walk and edit steps, null-text's inner step and
advance, Stage 1's train step.

A CUDA graph replays the kernels its capture recorded with the arguments
they had then, so a step body must read every per-step value from device
buffers and make no value on the host. Three checks hold that here, where
there is no card:

  * the buffer-driven loops against today's eager loops (kept below as the
    reference, ``_ref_*``: the loops as they were before they became step
    bodies), bit for bit at tiny width, with and without LocalBlend, with a
    reuse schedule, dependent noise, 1-byte temporal maps, early stop and
    gradient accumulation;
  * the same loops under an emulated runner: StepGraphs' own policy (first
    step of a variant eager, its second captured, the rest replayed), where
    a "capture" keeps the body with the Python values of the step it was
    captured at and a "replay" runs that body again on the current buffers
    — a Python-level branch or value the variant key does not fix shows as
    a changed bit;
  * every captured and replayed body under a ``TorchDispatchMode`` that
    fails on any op that reads a value to the host or makes a tensor from
    one (on the CPU by op, not by device). The warm-up is not checked: it
    runs eagerly on the card too, and builds the cached device tables.

The variant keys of the cached fast edit are counted at
``configs/rabbit-jump-p2p.yaml``'s windows at 50 steps.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_parity import t, tiny_unet_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (1, 2, 8, 8, 4)  # (B, F, h, w, C)
PROMPTS = ["a rabbit is jumping on the grass", "a origami rabbit is jumping on the grass"]
# at 8 steps: LocalBlend from step 3, the temporal window [0, 6), the cross
# window 4 steps; two steps or more on each side of every edge, so that a
# branch the variant key missed is replayed on the wrong side of it
CTRL = dict(is_replace_controller=False, cross_replace_steps=0.5, self_replace_steps=0.75,
            blend_words=(("rabbit",), ("rabbit",)), start_blend=0.375,
            equalizer_params={"words": ["origami"], "values": [2]})
EDIT_STEPS = 8
NULL_STEPS = 4
TRAIN_STEPS = 5
DEPENDENT = dict(num_frames=2, decay_rate=0.3, window_size=1, ar_sample=True, ar_coeff=0.1)
# ops that read a device value to the host or make a tensor from a host value
FORBIDDEN = {"_local_scalar_dense", "item", "scalar_tensor", "lift_fresh",
             "lift_fresh_copy", "_copy_from"}


# ---- today's loops, the reference -----------------------------------------

def _ref_capture(unet_fn, scheduler, latents, cond, *, N, cross_len, self_window,
                 capture_blend, temporal_maps_dtype=None, dependent_weight=0.0,
                 dependent_sampler=None, generator=None):
    from videop2p_tpu_torch.models.attention import BASE_STORE, AttnControl
    from videop2p_tpu_torch.pipelines import inversion as inv
    from videop2p_tpu_torch.pipelines.cached import CachedSource, filter_site_tree
    from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

    lo, hi = self_window
    latent = latents.float()
    generator = inv._dependent_generator(dependent_weight, dependent_sampler, generator,
                                         latent.device)
    timesteps = scheduler.timesteps(N)[::-1]
    cross, temporal, blend_seq = {}, {}, None

    def put(buffers, store, site, index, length, encode):
        for path, leaf in filter_site_tree(store[BASE_STORE], site).items():
            leaf = encode(leaf)
            if path not in buffers:
                buffers[path] = leaf.new_empty((length, *leaf.shape))
            buffers[path][index] = leaf

    trajectory = [latent]
    bounds = sorted({0, N - hi, N - lo, N - cross_len, N})
    for s, e in zip(bounds[:-1], bounds[1:]):
        want_cross = s >= N - cross_len
        want_temporal = s >= N - hi and e <= N - lo
        capture = want_cross or want_temporal
        control = AttnControl(None, 0, capture=True) if capture else None
        for j in range(s, e):
            step_t = int(timesteps[j])
            eps, store = unet_fn(latent, step_t, cond, control, store=capture or capture_blend)
            eps = inv._dependent_blend(eps, dependent_weight, dependent_sampler, generator)
            latent = scheduler.next_step(eps, step_t, latent, N)
            trajectory.append(latent)
            i = N - 1 - j
            if capture_blend:
                maps = blend_maps_from_store(store, latent_hw=tuple(latent.shape[2:4]),
                                             video_length=latent.shape[1], num_prompts=1,
                                             text_len=cond.shape[-2], num_uncond=0).float()
                if blend_seq is None:
                    blend_seq = maps.new_empty((N, *maps.shape))
                blend_seq[i] = maps
            if want_cross:
                put(cross, store, "attn2", i, cross_len, lambda a: a)
            if want_temporal:
                put(temporal, store, "attn_temp", i - lo, hi - lo,
                    lambda a: inv._encode_temporal(a, temporal_maps_dtype))
    trajectory = torch.stack(trajectory)
    return trajectory, CachedSource(
        src_latents=torch.flip(trajectory, dims=(0,)), cross_maps=cross or None,
        temporal_maps=temporal or None, blend_seq=blend_seq, cross_len=cross_len,
        self_window=(lo, hi))


def _ref_cached_edit(unet_fn, scheduler, x_t, cond, uncond, cached, *, N, ctx,
                     reuse_schedule=None, guidance_scale=7.5):
    from videop2p_tpu_torch.control.local_blend import local_blend
    from videop2p_tpu_torch.models.attention import AttnControl
    from videop2p_tpu_torch.pipelines.reuse import parse_reuse_schedule
    from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

    P = cond.shape[0]
    E = U = P - 1
    latents = x_t.float().expand(P, *x_t.shape[1:])
    latent_hw, video_length, text_len = tuple(latents.shape[2:4]), latents.shape[1], 77
    src_after = np.append(np.arange(N)[1:], N)
    edit_latents = latents[1:]
    text = torch.cat([uncond.expand(E, *uncond.shape), cond[1:]], dim=0)
    use_blend = ctx is not None and ctx.blend is not None
    full_steps = (None if reuse_schedule is None
                  else parse_reuse_schedule(reuse_schedule, N))
    deep_feature = last_maps = maps_sum = None

    def edit_maps_of(store):
        return blend_maps_from_store(store, latent_hw=latent_hw, video_length=video_length,
                                     num_prompts=E, text_len=text_len, num_uncond=U).float()

    for i, step_t in enumerate(scheduler.timesteps(N)):
        step_t = int(step_t)
        latent_in = torch.cat([edit_latents, edit_latents], dim=0)
        control = (AttnControl(ctx, i, U, cached_base=cached.base_tree_at(i),
                               cached_source=True) if ctx is not None else None)
        if full_steps is None:
            eps_all, store = unet_fn(latent_in, step_t, text, control, store=use_blend)
            edit_maps = edit_maps_of(store) if use_blend else None
        elif full_steps[i]:
            (eps_all, deep_feature), store = unet_fn(latent_in, step_t, text, control,
                                                     store=use_blend, deep_mode="capture")
            edit_maps = last_maps = edit_maps_of(store) if use_blend else None
        else:
            eps_all, _ = unet_fn(latent_in, step_t, text, control, store=False,
                                 deep_mode="shallow", deep_feature=deep_feature)
            edit_maps = last_maps
        eps_all = eps_all.float()
        eps = eps_all[:E] + guidance_scale * (eps_all[E:] - eps_all[:E])
        edit_latents, _ = scheduler.step(eps, step_t, edit_latents, N)
        source_after = cached.src_latents[int(src_after[i])]
        if use_blend:
            maps = torch.cat([cached.blend_seq[i], edit_maps], dim=0)
            maps_sum = maps if maps_sum is None else maps_sum + maps
            full = torch.cat([source_after, edit_latents], dim=0)
            edit_latents = local_blend(full, maps_sum, ctx.blend, i)[1:]
        if ctx is not None and i < ctx.spatial_replace_until:
            edit_latents = source_after.expand_as(edit_latents).contiguous()
    return torch.cat([cached.src_latents[-1], edit_latents], dim=0)


def _ref_null_text(unet_fn, scheduler, trajectory, cond, uncond, *, N, K, epsilon,
                   early_stop, mode, dependent_weight=0.0, dependent_sampler=None,
                   generator=None, guidance_scale=7.5):
    from videop2p_tpu_torch.pipelines import inversion as inv

    generator = inv._dependent_generator(dependent_weight, dependent_sampler, generator,
                                         trajectory.device)

    def fwd(latent, step_t, text):
        eps, _ = unet_fn(latent, step_t, text, None, store=False)
        return eps.float()

    def blend(eps):
        return inv._dependent_blend(eps, dependent_weight, dependent_sampler, generator)

    def cfg_step(eps_u, eps_c, step_t, latent):
        return scheduler.prev_step(eps_u + guidance_scale * (eps_c - eps_u), step_t, latent, N)

    timesteps = scheduler.timesteps(N)
    embeddings, losses, inner = [], [], []
    latent_cur, uncond = trajectory[-1], uncond.float()
    with inv._frozen(unet_fn), torch.no_grad():
        for i in range(N):
            step_t, latent_prev = int(timesteps[i]), trajectory[N - i - 1]
            eps_cond_raw = fwd(latent_cur, step_t, cond)
            if mode == "amortized":
                uncond = cond.float()
                eps_fu = blend(eps_cond_raw)
                latent_cur = cfg_step(eps_fu, blend(eps_cond_raw), step_t, latent_cur)
                losses.append(torch.mean((latent_cur - latent_prev) ** 2))
                inner.append(0)
                embeddings.append(uncond)
                continue
            lr, thresh = inv._lr_and_threshold(i, epsilon)
            eps_cond = blend(eps_cond_raw)
            state, loss, j = None, torch.tensor(float("inf")), 0
            while j < K and (not early_stop or loss.item() >= thresh):
                with torch.enable_grad():
                    leaf = uncond.detach().requires_grad_(True)
                    prev_rec = cfg_step(blend(fwd(latent_cur, step_t, leaf)), eps_cond, step_t,
                                        latent_cur)
                    loss = torch.mean((prev_rec - latent_prev) ** 2)
                    (grad,) = torch.autograd.grad(loss, leaf)
                loss = loss.detach()
                uncond, state = inv.adam_update(uncond, grad, state, lr)
                j += 1
            losses.append(loss)
            inner.append(j)
            embeddings.append(uncond)
            eps_fu = blend(fwd(latent_cur, step_t, uncond))
            latent_cur = cfg_step(eps_fu, blend(eps_cond_raw), step_t, latent_cur)
    return torch.stack(embeddings), torch.stack(losses), inner


@torch.no_grad()
def _ref_update(tx, params, grads, state):
    from videop2p_tpu_torch.train.tuner import global_norm

    if tx.accumulate > 1:
        n = state["mini_step"]
        for acc, g in zip(state["acc"], grads):
            acc.add_((g - acc) / (n + 1))
        if n + 1 < tx.accumulate:
            state["mini_step"] = n + 1
            return
        grads = [acc.clone() for acc in state["acc"]]
        for acc in state["acc"]:
            acc.zero_()
        state["mini_step"] = 0
    norm = global_norm(grads, params)
    grads = [torch.where(norm < tx.max_grad_norm, g, g / norm * tx.max_grad_norm)
             for g in grads]
    lr = tx.lr_schedule(state["count"])
    state["count"] += 1
    count = state["count"]
    bc1 = 1.0 - torch.tensor(tx.b1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(tx.b2, dtype=torch.float32) ** count
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        mu.mul_(tx.b1).add_((1 - tx.b1) * g)
        nu.mul_(tx.b2).add_((1 - tx.b2) * g ** 2)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + tx.eps)
        update = update + tx.weight_decay * p
        p.add_(update * -lr)


def _ref_train_steps(unet_fn, tx, state, scheduler, latents, text, seed, *, num_steps,
                     dependent_sampler=None):
    from videop2p_tpu_torch.core.noise import step_generator

    params = list(state.trainable.values())
    losses = []
    for _ in range(num_steps):
        gen = step_generator(seed, state.step, latents.device)
        if dependent_sampler is not None:
            noise = dependent_sampler.sample_like(latents, gen)
        else:
            noise = torch.randn(latents.shape, generator=gen, dtype=latents.dtype)
        timesteps = torch.randint(0, scheduler.num_train_timesteps, (latents.shape[0],),
                                  generator=gen)
        noisy = scheduler.add_noise(latents, noise, timesteps)
        target = scheduler.training_target(latents, noise, timesteps)
        with torch.enable_grad():
            pred, _ = unet_fn(noisy, timesteps, text, None, store=False)
            loss = torch.mean((pred.float() - target.float()) ** 2)
            grads = torch.autograd.grad(loss, params)
        _ref_update(tx, params, grads, state.opt_state)
        state.step += 1
        losses.append(loss.detach())
    return torch.stack(losses)


# ---- the emulated runner ---------------------------------------------------

class _NoHostValues(TorchDispatchMode):
    """Records every op that reads a value to the host or makes a tensor
    from a host value (by op: on the CPU every tensor is on the host)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        return False

    def __init__(self, seen: list):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name in FORBIDDEN or (name == "_to_copy" and kwargs.get("device") is not None):
            self.seen.append(str(func))
        return func(*args, **kwargs)


def _emulated_runner_class():
    from videop2p_tpu_torch.utils.cuda_graphs import StepGraphs, _Graph

    class Emulated(StepGraphs):
        """StepGraphs' policy on the CPU: a capture keeps the body with its
        step's Python values, a replay runs it again under
        :class:`_NoHostValues`."""

        log: list = []

        def __init__(self, device, name=""):
            super().__init__(device, enabled=False, name=name)
            self.enabled = True
            self.forbidden: list = []
            self.keys: list = []
            Emulated.log.append(self)

        def run(self, key, body, *args):
            self.keys.append(key)
            return super().run(key, body, *args)

        def _warm(self, body, args):
            return body(*args)

        def _capture(self, body, args):
            return _Graph(lambda: body(*args), None, [])

        def _replay(self, entry):
            with _NoHostValues(self.forbidden):
                return entry.graph()

    return Emulated


@pytest.fixture
def emulate(monkeypatch):
    """Routes every loop's runner to the emulated one; yields its class,
    whose ``log`` lists the runners made."""
    from videop2p_tpu_torch.utils import cuda_graphs

    cls = _emulated_runner_class()
    cls.log = []
    monkeypatch.setattr(cuda_graphs, "step_graphs", lambda flag, device, name: cls(device, name))
    return cls


# ---- the cases -------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.core.ddpm import DDPMScheduler
    from videop2p_tpu_torch.core.noise import DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    _, _, pmodel = tiny_unet_pair(seed=4, frames=SHAPE[1])
    rng = np.random.default_rng(0)
    return dict(
        pmodel=pmodel, pfn=make_unet_fn(pmodel), sched=DDIMScheduler.create_sd(),
        ddpm=DDPMScheduler.create_sd(),
        ctx=make_controller(PROMPTS, WordTokenizer(), EDIT_STEPS, **CTRL),
        sampler=DependentNoiseSampler.create(**DEPENDENT),
        x0=t(rng.normal(size=SHAPE)), cond=t(rng.normal(size=(2, 77, 16))),
        uncond=t(rng.normal(size=(77, 16))), text=t(rng.normal(size=(1, 77, 16))))


def _capture_and_edit(m, *, graphs, reference=False, ctx=True, reuse=None, dtype=None,
                      dependent=False):
    """The capture walk then the cached edit: returns every output tensor
    by name."""
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured, edit_sample
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    control = m["ctx"] if ctx else None
    cross_len, window = capture_windows(m["ctx"], EDIT_STEPS) if ctx else (0, (0, 0))
    kw = dict(cross_len=cross_len, self_window=window, capture_blend=ctx,
              temporal_maps_dtype=dtype)
    if dependent:
        kw.update(dependent_weight=0.2, dependent_sampler=m["sampler"],
                  generator=torch.Generator().manual_seed(3))
    if reference:
        traj, cached = _ref_capture(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                                    N=EDIT_STEPS, **kw)
        edited = _ref_cached_edit(m["pfn"], m["sched"], traj[-1], m["cond"], m["uncond"],
                                  cached, N=EDIT_STEPS, ctx=control, reuse_schedule=reuse)
    else:
        traj, cached = ddim_inversion_captured(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                                               num_inference_steps=EDIT_STEPS,
                                               cuda_graphs=graphs, **kw)
        edited = edit_sample(m["pfn"], m["sched"], traj[-1], m["cond"], m["uncond"],
                             num_inference_steps=EDIT_STEPS, ctx=control,
                             source_uses_cfg=False, cached_source=cached,
                             reuse_schedule=reuse, cuda_graphs=graphs)
    out = {"trajectory": traj, "edited": edited}
    for tree in ("cross_maps", "temporal_maps"):
        for path, leaf in (getattr(cached, tree) or {}).items():
            out[f"{tree}/{path}"] = leaf.view(torch.uint8) if leaf.element_size() == 1 else leaf
    if cached.blend_seq is not None:
        out["blend_seq"] = cached.blend_seq
    return out


def _null_text(m, *, graphs, reference=False, mode="optimize", epsilon=1e-5,
               dependent=True):
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    traj = ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                          num_inference_steps=NULL_STEPS)
    kw = dict(dependent_weight=0.2, dependent_sampler=m["sampler"],
              generator=torch.Generator().manual_seed(5)) if dependent else {}
    if reference:
        emb, losses, inner = _ref_null_text(
            m["pfn"], m["sched"], traj, m["cond"][:1], m["uncond"][None], N=NULL_STEPS, K=3,
            epsilon=epsilon, early_stop=True, mode=mode, **kw)
    else:
        emb, losses, inner = null_text_optimization(
            m["pfn"], m["sched"], traj, m["cond"][:1], m["uncond"][None],
            num_inference_steps=NULL_STEPS, num_inner_steps=3, epsilon=epsilon,
            null_text_mode=mode, return_losses=True, return_inner_steps=True,
            cuda_graphs=graphs, **kw)
        inner = [int(j) for j in inner]
    return {"embeddings": emb, "losses": losses.reshape(-1),
            "inner_steps": torch.tensor(inner)}


def _train(m, *, graphs, reference=False, dependent=True, accumulate=2):
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train.tuner import (
        TrainState,
        TuneConfig,
        make_optimizer,
        train_steps,
    )

    model = copy.deepcopy(m["pmodel"])
    model.config = dataclasses.replace(model.config, gradient_checkpointing=True)
    tx = make_optimizer(TuneConfig(learning_rate=3e-3, lr_scheduler="linear",
                                   lr_warmup_steps=2, max_train_steps=TRAIN_STEPS,
                                   gradient_accumulation_steps=accumulate))
    state = TrainState.create(model, tx)
    latents = 0.5 * m["x0"]
    sampler = m["sampler"] if dependent else None
    if reference:
        losses = _ref_train_steps(make_unet_fn(model), tx, state, m["ddpm"], latents,
                                  m["text"], 11, num_steps=TRAIN_STEPS,
                                  dependent_sampler=sampler)
    else:
        _, losses = train_steps(make_unet_fn(model), tx, state, m["ddpm"], latents, m["text"],
                                11, num_steps=TRAIN_STEPS, dependent_sampler=sampler,
                                cuda_graphs=graphs)
    out = {"losses": losses}
    out.update({f"param/{k}": v.detach() for k, v in state.trainable.items()})
    out.update({f"mu/{i}": v for i, v in enumerate(state.opt_state["mu"])})
    out.update({f"nu/{i}": v for i, v in enumerate(state.opt_state["nu"])})
    return out


CASES = {
    "edit_blend": lambda m, **kw: _capture_and_edit(m, **kw),
    "edit_reuse": lambda m, **kw: _capture_and_edit(m, reuse="uniform:2", **kw),
    "edit_int8_dependent": lambda m, **kw: _capture_and_edit(
        m, dtype=torch.int8, dependent=True, **kw),
    "edit_float8": lambda m, **kw: _capture_and_edit(m, dtype=torch.float8_e4m3fn, **kw),
    "edit_no_controller_dependent": lambda m, **kw: _capture_and_edit(
        m, ctx=False, dependent=True, **kw),
    "null_text_early_stop": lambda m, **kw: _null_text(m, epsilon=30.0, **kw),
    "null_text_full_inner": lambda m, **kw: _null_text(m, dependent=False, **kw),
    "null_text_amortized": lambda m, **kw: _null_text(m, mode="amortized", **kw),
    "train_accumulate_dependent": lambda m, **kw: _train(m, **kw),
    "train_plain": lambda m, **kw: _train(m, dependent=False, accumulate=1, **kw),
}
_RUNS: dict = {}


def _runs(case, models, emulate):
    """The case's reference, eager and emulated outputs, once a module, and
    the emulated runners' forbidden ops and keys."""
    if case not in _RUNS:
        fn = CASES[case]
        emulate.log = []
        emulated = fn(models, graphs=True)
        runners = list(emulate.log)
        with _patched_off():
            ref = fn(models, graphs=False, reference=True)
            eager = fn(models, graphs=False)
        _RUNS[case] = dict(ref=ref, eager=eager, emulated=emulated, runners=runners)
    return _RUNS[case]


class _patched_off:
    """Restores the real runner factory for the reference and eager runs."""

    def __enter__(self):
        from videop2p_tpu_torch.utils import cuda_graphs

        self.saved = cuda_graphs.step_graphs
        cuda_graphs.step_graphs = lambda flag, device, name: cuda_graphs.StepGraphs(
            device, enabled=False, name=name)

    def __exit__(self, *exc):
        from videop2p_tpu_torch.utils import cuda_graphs

        cuda_graphs.step_graphs = self.saved


@pytest.mark.parametrize("case", list(CASES))
def test_buffer_driven_loops_give_todays_bits(case, models, emulate):
    """Today's loop, the buffer-driven loop run eagerly, and the same loop
    under emulated graphs: the same bits in every output, and the emulated
    runners replayed steps."""
    runs = _runs(case, models, emulate)
    assert set(runs["eager"]) == set(runs["ref"]) == set(runs["emulated"])
    for name, want in runs["ref"].items():
        assert torch.equal(runs["eager"][name], want), f"eager {name}"
        assert torch.equal(runs["emulated"][name], want), f"emulated {name}"
    assert sum(r.replays for r in runs["runners"]) > 0
    if case == "null_text_early_stop":
        inner = runs["ref"]["inner_steps"]
        assert inner.min() < 3 and inner.max() > 1, inner  # early stop at some steps


@pytest.mark.parametrize("case", list(CASES))
def test_step_bodies_make_no_host_values(case, models, emulate):
    """Every captured and replayed step body ran without an op that reads a
    value to the host or makes a tensor from one."""
    runs = _runs(case, models, emulate)
    assert runs["runners"]
    for runner in runs["runners"]:
        assert runner.forbidden == [], (runner.name, runner.forbidden[:5])


def test_variant_keys_at_the_rabbit_jump_windows(monkeypatch):
    """configs/rabbit-jump-p2p.yaml at 50 steps with the CLI's default
    windows (cross 0.2, self 0.5, LocalBlend from step 10): the capture
    walk has 3 variants (no capture, temporal, cross + temporal) and the
    edit 4 (the first step, then the blend gate's and the temporal
    window's edges); each variant seen twice or more is one graph."""
    import yaml

    from videop2p_tpu_torch.control import make_controller
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured, edit_sample
    from videop2p_tpu_torch.pipelines.cached import CachedSource, capture_windows
    from videop2p_tpu_torch.utils import cuda_graphs
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    with open(os.path.join(REPO, "configs", "rabbit-jump-p2p.yaml")) as f:
        cfg = yaml.safe_load(f)
    N = 50
    ctx = make_controller(cfg["prompts"], WordTokenizer(), N, is_replace_controller=False,
                          cross_replace_steps=0.2, self_replace_steps=0.5,
                          blend_words=tuple((w,) for w in cfg["blend_word"]),
                          equalizer_params=cfg["eq_params"])
    cross_len, window = capture_windows(ctx, N)
    assert (cross_len, window, ctx.blend.start_blend) == (10, (0, 25), 10)

    class Counting(cuda_graphs.StepGraphs):
        log: list = []

        def __init__(self, device, name):
            super().__init__(device, enabled=False, name=name)
            self.enabled = True
            self.keys = []
            Counting.log.append(self)

        def run(self, key, body, *args):
            self.keys.append(key)
            return super().run(key, body, *args)

        def _warm(self, body, args):
            return {}

        def _capture(self, body, args):
            return cuda_graphs._Graph(None, {}, [])

        def _replay(self, entry):
            return {}

    monkeypatch.setattr(cuda_graphs, "step_graphs",
                        lambda flag, device, name: Counting(device, name))
    x = torch.zeros((1, 2, 8, 8, 4))
    cond, uncond = torch.zeros((2, 77, 16)), torch.zeros((77, 16))
    ddim_inversion_captured(None, DDIMScheduler.create_sd(), x, cond[:1], num_inference_steps=N,
                            cross_len=cross_len, self_window=window, capture_blend=True)
    cached = CachedSource(src_latents=torch.zeros((N + 1, *x.shape)),
                          cross_maps={"a.attn2": torch.zeros((cross_len, 1))},
                          temporal_maps={"a.attn_temp": torch.zeros((25, 1))},
                          blend_seq=torch.zeros((N, 1)), cross_len=cross_len, self_window=window)
    edit_sample(None, DDIMScheduler.create_sd(), x, cond, uncond, num_inference_steps=N,
                ctx=ctx, source_uses_cfg=False, cached_source=cached)
    capture, edit = Counting.log
    assert collections.Counter(capture.keys) == {(False, False): 25, (False, True): 15,
                                                 (True, True): 10}
    assert collections.Counter(edit.keys) == {
        (True, None, False, False, True): 1, (False, None, False, False, True): 9,
        (False, None, True, False, True): 15, (False, None, True, False, False): 25}
    for runner, graphs, eager in ((capture, 3, 3), (edit, 3, 4)):
        assert (len(runner.capture_s), runner.eager_steps, runner.replays) == (
            graphs, eager, N - eager)


def test_count_launch_records_during_a_capture(monkeypatch):
    """Outside a capture a count goes to its counter; a launch into the
    stream being captured is recorded for the replays, one on another
    stream during the capture counts at once."""
    from videop2p_tpu_torch.utils import cuda_graphs

    counted = []
    cuda_graphs.count_launch(counted.append, 2)
    assert counted == [2]
    monkeypatch.setattr(cuda_graphs, "_recording", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    cuda_graphs.count_launch(counted.append, 4)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    cuda_graphs.count_launch(counted.append, 3)
    assert counted == [2, 4] and cuda_graphs._recording == [(counted.append, 3)]


def test_graphs_need_cuda_and_stay_off_the_cpu():
    """The CPU runs the eager loop by default; asking for graphs there
    raises, and a runner without graphs calls the body."""
    from videop2p_tpu_torch.utils import cuda_graphs

    assert cuda_graphs.graphs_default("cpu") is False
    assert cuda_graphs.resolve_graphs(None, "cpu") is False
    assert cuda_graphs.resolve_graphs(False, "cpu") is False
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graphs.resolve_graphs(True, "cpu")
    with cuda_graphs.step_graphs(None, "cpu", "x") as runner:
        assert not runner.enabled
        x = torch.ones(2)
        assert runner.run("k", lambda a: a + x, 1) is not None
        assert runner.kept(x) is x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float8_e4m3fn])
def test_step_indexing_on_the_device(dtype):
    """index_step / write_step with a 0-d device index: the int index's
    bits, float8 included (moved as bytes)."""
    from videop2p_tpu_torch.utils.cuda_graphs import index_step, write_step

    src = torch.randn(5, 3, 4).to(dtype)
    buf = torch.zeros(5, 3, 4).to(dtype)
    for i in range(5):
        idx = torch.tensor(i)
        assert torch.equal(index_step(src, idx).view(torch.uint8),
                           src[i].view(torch.uint8))
        write_step(buf, idx, src[i])
    assert torch.equal(buf.view(torch.uint8), src.view(torch.uint8))


def test_alpha_table_matches_the_host_values():
    """The scheduler's ᾱ at a device timestep equals its value at the int,
    below 0 (the final ᾱ), inside and past the schedule."""
    from videop2p_tpu_torch.core import DDIMScheduler

    for sched in (DDIMScheduler.create_sd(), DDIMScheduler.create_sd(set_alpha_to_one=True)):
        for step_t in (-40, -1, 0, 1, 500, 999, 1000, 1020):
            want = (float(sched.alphas_cumprod[min(step_t, 999)]) if step_t >= 0
                    else sched.final_alpha_cumprod)
            got_int = sched._alpha_prod(step_t, "cpu")
            got_t = sched._alpha_prod(torch.tensor(step_t), "cpu")
            assert got_int.item() == got_t.item() == np.float32(want)


def test_an_analysed_call_runs_the_eager_loop(monkeypatch):
    """Inside a program analysis (an instrumented program's first call) a
    loop's runner is eager, so the analysis counts every step; outside one
    the same call asks for graphs (which need a CUDA device here)."""
    from videop2p_tpu_torch.obs.introspect import ProgramAnalysis
    from videop2p_tpu_torch.utils import cuda_graphs

    monkeypatch.setattr(cuda_graphs, "resolve_graphs", lambda flag, device: True)
    with ProgramAnalysis():
        runner = cuda_graphs.step_graphs(None, "cpu", "x")
    assert not runner.enabled
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_graphs.step_graphs(None, "cpu", "x")


def _flat(tree, name=""):
    if isinstance(tree, torch.Tensor):
        return {name: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{name}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{name}/{i}").items()}
    return {}


def _edit_records(m, flag):
    from videop2p_tpu_torch.pipelines import cached_fast_edit

    return cached_fast_edit(m["pfn"], m["sched"], m["x0"], m["cond"][:1], m["cond"],
                            m["uncond"], m["ctx"], num_inference_steps=EDIT_STEPS, cross_len=4,
                            self_window=(0, 6), telemetry=True, attn_maps=True,
                            cuda_graphs=flag)


def _null_text_records(m, flag):
    from videop2p_tpu_torch.pipelines import ddim_inversion, null_text_optimization

    traj = ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                          num_inference_steps=NULL_STEPS)
    return null_text_optimization(m["pfn"], m["sched"], traj, m["cond"][:1], m["uncond"][None],
                                  num_inference_steps=NULL_STEPS, num_inner_steps=2,
                                  early_stop=False, return_losses=True, telemetry=True,
                                  cuda_graphs=flag)


RECORDS = {"cached_fast_edit": _edit_records, "null_text": _null_text_records}


@pytest.mark.parametrize("program", list(RECORDS))
def test_emulated_replays_keep_the_step_records(program, models, emulate):
    """With the telemetry and attention records on (their per-step outputs
    kept past each replay), the emulated graphs give the eager loop's
    outputs and records bit for bit, with no host value in a replay."""
    emulated = _flat(RECORDS[program](models, True))
    runners = list(emulate.log)
    with _patched_off():
        eager = _flat(RECORDS[program](models, False))
    assert set(emulated) == set(eager) and eager
    for name, want in eager.items():
        assert torch.equal(emulated[name], want), name
    assert sum(r.replays for r in runners) > 0
    assert all(r.forbidden == [] for r in runners), [r.forbidden[:3] for r in runners]
