"""The rest of the port's graphed step loops on the CPU
(``utils/cuda_graphs.py``): the live edit loop, the plain DDIM inversion,
"hybrid" null-text and distillation's steps, then runners kept across
calls (``KeptRunner``, ``RunnerCache``) and a program set serving on them.

The checks are ``tests/test_torch_graphs.py``'s: each buffer-driven loop
against today's eager loop (kept below as the reference, ``_ref_*``) bit
for bit, the same loop under the emulated runner (a variant's first step
eager, its second "captured" with the Python values of that step, later
ones "replayed": a branch the variant key misses shows as changed bits),
and no op in a captured or replayed body that reads a value to the host
or makes a tensor from one.

A kept runner's replay runs the body captured during an EARLIER call, on
the runner's buffers: a body that still closed over a call's own tensor
would read the earlier request's. The cross-call cases serve requests A,
B, then A again (other prompts, equalizer and clip under one key) through
one emulated kept runner and hold each against a fresh eager call.
"""

from __future__ import annotations

import copy
import dataclasses
import threading

import numpy as np
import pytest
import torch

from tests.graphs_emulation import emulated_kept_class
from tests.test_torch_graphs import (  # noqa: F401 — fixtures
    CTRL,
    DEPENDENT,
    EDIT_STEPS,
    PROMPTS,
    SHAPE,
    _flat,
    _patched_off,
    emulate,
    models,
)
from tests.test_torch_parity import t

INV_STEPS = 6
HYBRID_STEPS = 4
DISTILL_STEPS = 5
DISTILL_GRID = 4
PROMPTS_B = ["a cat is walking on the snow", "a origami cat is walking on the snow"]
CTRL_B = dict(CTRL, blend_words=(("cat",), ("cat",)),
              equalizer_params={"words": ["origami"], "values": [3]})


# ---- today's loops, the reference -----------------------------------------

def _ref_live_edit(unet_fn, scheduler, latents, cond, uncond, *, N, ctx, source_uses_cfg,
                   eta=0.0, generator=None, null=None, dependent_sampler=None,
                   guidance_scale=7.5):
    from videop2p_tpu_torch.control.local_blend import local_blend
    from videop2p_tpu_torch.models.attention import AttnControl
    from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

    multi = cond.dim() == 4
    P = cond.shape[0]
    latents = latents.float().expand(P, *latents.shape[1:])
    video_length, latent_hw, text_len = latents.shape[1], tuple(latents.shape[2:4]), 77
    if multi:
        uncond = uncond[None].expand(video_length, *uncond.shape)
        if null is not None and null.dim() == 3:
            null = null[:, None].expand(null.shape[0], video_length, *null.shape[1:])
    U = P if source_uses_cfg else P - 1
    raw = uncond.expand(U, *uncond.shape)
    use_blend = ctx is not None and ctx.blend is not None
    maps_sum = None
    for i, step_t in enumerate(scheduler.timesteps(N)):
        step_t = int(step_t)
        unc = raw
        if source_uses_cfg and null is not None:
            unc = torch.cat([null[i][None].to(raw.dtype), raw[1:]])
        text = torch.cat([unc, cond], dim=0)
        latent_in = torch.cat([latents[P - U:], latents], dim=0)
        control = AttnControl(ctx, i, U) if ctx is not None else None
        eps_all, store = unet_fn(latent_in, step_t, text, control, store=use_blend)
        eps_all = eps_all.float()
        eps_uncond, eps_text = eps_all[:U], eps_all[U:]
        if source_uses_cfg:
            eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        else:
            eps_edit = eps_uncond + guidance_scale * (eps_text[1:] - eps_uncond)
            eps = torch.cat([eps_text[:1], eps_edit], dim=0)
        noise = None
        if eta > 0:
            if dependent_sampler is not None:
                noise = dependent_sampler.sample_like(eps.new_empty(eps.shape), generator)
            else:
                noise = torch.randn(eps.shape, generator=generator, device=eps.device)
        latents, _ = scheduler.step(eps, step_t, latents, N, eta=eta, variance_noise=noise)
        if use_blend:
            maps = blend_maps_from_store(
                store, latent_hw=latent_hw, video_length=video_length,
                num_prompts=P, text_len=text_len, num_uncond=U).float()
            maps_sum = maps if maps_sum is None else maps_sum + maps
            latents = local_blend(latents, maps_sum, ctx.blend, i)
        if ctx is not None and i < ctx.spatial_replace_until:
            latents = latents[:1].expand_as(latents).contiguous()
    return latents


def _ref_ddim_inversion(unet_fn, scheduler, latents, cond, *, N, dependent_weight=0.0,
                        dependent_sampler=None, generator=None):
    from videop2p_tpu_torch.pipelines import inversion as inv

    latent = latents.float()
    generator = inv._dependent_generator(dependent_weight, dependent_sampler, generator,
                                         latent.device)
    trajectory = [latent]
    for step_t in scheduler.timesteps(N)[::-1]:
        eps, _ = unet_fn(latent, int(step_t), cond, None, store=False)
        eps = inv._dependent_blend(eps, dependent_weight, dependent_sampler, generator)
        latent = scheduler.next_step(eps, int(step_t), latent, N)
        trajectory.append(latent)
    return torch.stack(trajectory)


def _ref_hybrid(unet_fn, scheduler, trajectory, cond, *, N, K, dependent_weight=0.0,
                dependent_sampler=None, seed=0, guidance_scale=7.5):
    from videop2p_tpu_torch.core.noise import step_generator
    from videop2p_tpu_torch.pipelines import inversion as inv

    timesteps = scheduler.timesteps(N)
    embeddings, losses = [], []

    def fwd(latent, step_t, text):
        eps, _ = unet_fn(latent, step_t, text, None, store=False)
        return eps.float()

    with inv._frozen(unet_fn), torch.no_grad():
        for i in range(N):
            step_t = int(timesteps[i])
            latent, latent_prev = trajectory[N - i], trajectory[N - i - 1]
            gen = step_generator(seed, i, latent.device) if dependent_weight > 0 else None

            def blend(eps):
                return inv._dependent_blend(eps, dependent_weight, dependent_sampler, gen)

            lr, _ = inv._lr_and_threshold(i, 0.0)
            eps_cond = blend(fwd(latent, step_t, cond))
            uncond, state = cond.float(), None
            for _ in range(K):
                with torch.enable_grad():
                    leaf = uncond.detach().requires_grad_(True)
                    eps_u = blend(fwd(latent, step_t, leaf))
                    eps = eps_u + guidance_scale * (eps_cond - eps_u)
                    prev_rec = scheduler.prev_step(eps, step_t, latent, N)
                    loss = torch.mean((prev_rec - latent_prev) ** 2)
                    (grad,) = torch.autograd.grad(loss, leaf)
                uncond, state = inv.adam_update(uncond, grad, state, lr)
            losses.append(loss.detach())
            embeddings.append(uncond)
    return torch.stack(embeddings), torch.stack(losses)


def _ref_distill_steps(unet_fn, tx, state, scheduler, latents, text, seed, *, num_steps, cfg):
    from videop2p_tpu_torch.core.noise import step_generator
    from videop2p_tpu_torch.train import distill as d

    module = unet_fn.module
    dev = latents.device
    grid = int(cfg.distill_grid)
    ts_np = scheduler.timesteps(grid)
    prev_np = np.append(ts_np[1:], ts_np[-1] - scheduler.num_train_timesteps // grid)
    final = torch.tensor(scheduler.final_alpha_cumprod, dtype=torch.float32)
    losses = []
    for _ in range(num_steps):
        gen = step_generator(seed, state.step, dev)
        noise = torch.randn(latents.shape, generator=gen, dtype=latents.dtype)
        n = torch.randint(0, grid, (latents.shape[0],), generator=gen)
        t_hi = torch.as_tensor(ts_np)[n]
        t_lo = torch.as_tensor(prev_np)[n]
        t_lo_in = t_lo.clamp(min=0)
        boundary = (t_lo < 0).reshape((-1,) + (1,) * (latents.dim() - 1))
        x_hi = scheduler.add_noise(latents, noise, t_hi)

        def forward(subset, x, ts):
            return torch.func.functional_call(module, subset, (x, ts, text))

        with torch.no_grad():
            eps_t = forward(state.teacher_trainable, x_hi, t_hi)
            x0 = d._pred_x0(scheduler, eps_t, t_hi, x_hi)
            a_p, b_p = scheduler.alpha_coefficients(t_lo.clamp(min=0), x_hi)
            landed = (t_lo >= 0).reshape(a_p.shape)
            a_p = torch.where(landed, a_p, torch.sqrt(final))
            b_p = torch.where(landed, b_p, torch.sqrt(1.0 - final))
            x_lo = a_p * x0 + b_p * eps_t.float()
            eps_e = d.apply_time_head(state.ema_head, forward(state.ema_trainable, x_lo, t_lo_in),
                                      t_lo_in)
            target = torch.where(boundary, latents.float(),
                                 d._pred_x0(scheduler, eps_e, t_lo_in, x_lo))
            weight = torch.where(boundary, torch.tensor(float(cfg.boundary_weight)),
                                 torch.tensor(1.0))
        params = list(state.trainable.values()) + list(state.head.values())
        with torch.enable_grad():
            eps_s, _ = unet_fn(x_hi, t_hi, text, None, store=False)
            eps_s = d.apply_time_head(state.head, eps_s, t_hi)
            loss = torch.mean(weight * (d._pred_x0(scheduler, eps_s, t_hi, x_hi) - target) ** 2)
            grads = torch.autograd.grad(loss, params)
        tx.update_(params, grads, state.opt_state)
        with torch.no_grad():
            decay = torch.tensor(cfg.ema_decay, dtype=torch.float32)
            for ema, src in ((state.ema_trainable, state.trainable),
                             (state.ema_head, state.head)):
                for name, e in ema.items():
                    e.copy_((decay * e.float() + (1.0 - decay) * src[name].float()).to(e.dtype))
        state.step += 1
        losses.append(loss.detach())
    return torch.stack(losses)


# ---- the cases -------------------------------------------------------------

def _controller(kind, steps=EDIT_STEPS, prompts=PROMPTS, ctrl=CTRL):
    from videop2p_tpu_torch.control import make_controller, make_spatial_replace_controller
    from videop2p_tpu_torch.utils.tokenizers import WordTokenizer

    if kind == "blend":
        return make_controller(prompts, WordTokenizer(), steps, **ctrl)
    if kind == "spatial":
        return make_spatial_replace_controller(0.5, steps)
    return None


def _live(m, *, graphs, reference=False, ctx="blend", cfg=True, eta=0.0, dependent=False,
          null=False, multi=False):
    from videop2p_tpu_torch.pipelines import edit_sample

    rng = np.random.default_rng(7)
    cond = m["cond"]
    if multi:
        cond = t(rng.normal(size=(2, SHAPE[1], 77, 16)))
    null_emb = t(rng.normal(size=(EDIT_STEPS, 77, 16))) if null else None
    kw = dict(ctx=_controller(ctx), source_uses_cfg=cfg, eta=eta,
              generator=torch.Generator().manual_seed(9) if eta > 0 else None,
              dependent_sampler=m["sampler"] if dependent else None)
    if reference:
        out = _ref_live_edit(m["pfn"], m["sched"], m["x0"], cond, m["uncond"], N=EDIT_STEPS,
                             null=null_emb, **kw)
    else:
        out = edit_sample(m["pfn"], m["sched"], m["x0"], cond, m["uncond"],
                          num_inference_steps=EDIT_STEPS, null_uncond_embeddings=null_emb,
                          cuda_graphs=graphs, **kw)
    return {"latents": out}


def _inversion(m, *, graphs, reference=False, dependent=False):
    from videop2p_tpu_torch.pipelines import ddim_inversion

    kw = dict(dependent_weight=0.2, dependent_sampler=m["sampler"],
              generator=torch.Generator().manual_seed(3)) if dependent else {}
    if reference:
        traj = _ref_ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1], N=INV_STEPS,
                                   **kw)
    else:
        traj = ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                              num_inference_steps=INV_STEPS, cuda_graphs=graphs, **kw)
    return {"trajectory": traj}


def _hybrid(m, *, graphs, reference=False, dependent=True, K=3):
    from videop2p_tpu_torch.pipelines import null_text_optimization

    traj = _ref_ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1], N=HYBRID_STEPS)
    kw = dict(dependent_weight=0.2, dependent_sampler=m["sampler"]) if dependent else {}
    if reference:
        emb, losses = _ref_hybrid(m["pfn"], m["sched"], traj, m["cond"][:1], N=HYBRID_STEPS, K=K,
                                  seed=5 if dependent else 0, **kw)
    else:
        gen = torch.Generator().manual_seed(5) if dependent else None
        emb, losses = null_text_optimization(
            m["pfn"], m["sched"], traj, m["cond"][:1], m["uncond"][None],
            num_inference_steps=HYBRID_STEPS, null_text_mode="hybrid", hybrid_inner_steps=K,
            return_losses=True, generator=gen, outer_chunk=2, cuda_graphs=graphs, **kw)
    return {"embeddings": emb, "losses": losses.reshape(-1)}


def _distill(m, *, graphs, reference=False, accumulate=1):
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        distill_steps,
        init_time_head,
        make_distill_optimizer,
    )

    model = copy.deepcopy(m["pmodel"])
    cfg = DistillConfig(learning_rate=1e-3, distill_grid=DISTILL_GRID, boundary_weight=1.5,
                        gradient_accumulation_steps=accumulate)
    tx = make_distill_optimizer(cfg)
    head = init_time_head(torch.Generator().manual_seed(2), model.config)
    state = DistillState.create(model, head, tx)
    with torch.no_grad():
        # a non-zero output layer, so that the head's gradient moves the student
        state.head["dense2.kernel"].normal_(generator=torch.Generator().manual_seed(4))
        state.ema_head["dense2.kernel"].copy_(state.head["dense2.kernel"])
    fn, sched = make_unet_fn(model), DDIMScheduler.create_sd(steps_offset=1)
    latents = 0.5 * m["x0"]
    if reference:
        losses = _ref_distill_steps(fn, tx, state, sched, latents, m["text"], 13,
                                    num_steps=DISTILL_STEPS, cfg=cfg)
    else:
        _, losses = distill_steps(fn, tx, state, sched, latents, m["text"], 13,
                                  num_steps=DISTILL_STEPS, cfg=cfg, cuda_graphs=graphs)
    out = {"losses": losses}
    for tree in ("trainable", "head", "ema_trainable", "ema_head"):
        out.update({f"{tree}/{k}": v.detach() for k, v in getattr(state, tree).items()})
    out.update({f"mu/{i}": v for i, v in enumerate(state.opt_state["mu"])})
    out.update({f"nu/{i}": v for i, v in enumerate(state.opt_state["nu"])})
    return out


CASES = {
    "live_blend_null_text": lambda m, **kw: _live(m, null=True, **kw),
    "live_fast_eta_plain_noise": lambda m, **kw: _live(m, cfg=False, eta=0.5, **kw),
    "live_eta_dependent_noise": lambda m, **kw: _live(m, eta=0.3, dependent=True, **kw),
    "live_spatial_replace": lambda m, **kw: _live(m, ctx="spatial", **kw),
    "live_uncontrolled": lambda m, **kw: _live(m, ctx=None, **kw),
    "live_multi_null_text": lambda m, **kw: _live(m, null=True, multi=True, **kw),
    "ddim_inversion": lambda m, **kw: _inversion(m, **kw),
    "ddim_inversion_dependent": lambda m, **kw: _inversion(m, dependent=True, **kw),
    "hybrid_dependent": lambda m, **kw: _hybrid(m, **kw),
    "hybrid_plain": lambda m, **kw: _hybrid(m, dependent=False, K=2, **kw),
    "distill_plain": lambda m, **kw: _distill(m, **kw),
    "distill_accumulate": lambda m, **kw: _distill(m, accumulate=2, **kw),
}
_RUNS: dict = {}


def _runs(case, models, emulate):
    """The case's reference, eager and emulated outputs, once a module, and
    the emulated runners."""
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


@pytest.mark.parametrize("case", list(CASES))
def test_step_bodies_make_no_host_values(case, models, emulate):
    """Every captured and replayed step body ran without an op that reads a
    value to the host or makes a tensor from one."""
    runs = _runs(case, models, emulate)
    assert runs["runners"]
    for runner in runs["runners"]:
        assert runner.forbidden == [], (runner.name, runner.forbidden[:5])


def _live_records(m, flag):
    from videop2p_tpu_torch.pipelines import edit_sample

    return edit_sample(m["pfn"], m["sched"], m["x0"], m["cond"], m["uncond"],
                       num_inference_steps=EDIT_STEPS, ctx=_controller("blend"),
                       telemetry=True, attn_maps=True, cuda_graphs=flag)


def _inversion_records(m, flag):
    from videop2p_tpu_torch.pipelines import ddim_inversion

    return ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1],
                          num_inference_steps=INV_STEPS, attn_maps=True, cuda_graphs=flag)


def _hybrid_records(m, flag):
    from videop2p_tpu_torch.pipelines import null_text_optimization

    traj = _ref_ddim_inversion(m["pfn"], m["sched"], m["x0"], m["cond"][:1], N=HYBRID_STEPS)
    return null_text_optimization(m["pfn"], m["sched"], traj, m["cond"][:1], m["uncond"][None],
                                  num_inference_steps=HYBRID_STEPS, null_text_mode="hybrid",
                                  hybrid_inner_steps=2, return_losses=True,
                                  return_inner_steps=True, telemetry=True, cuda_graphs=flag)


RECORDS = {"live_edit": _live_records, "ddim_inversion": _inversion_records,
           "hybrid": _hybrid_records}


@pytest.mark.parametrize("program", list(RECORDS))
def test_emulated_replays_keep_the_step_records(program, models, emulate):
    """With the telemetry and attention records on, the emulated graphs give
    the eager loop's outputs and records bit for bit, with no host value
    in a replay."""
    emulated = _flat(RECORDS[program](models, True))
    runners = list(emulate.log)
    with _patched_off():
        eager = _flat(RECORDS[program](models, False))
    assert set(emulated) == set(eager) and eager
    for name, want in eager.items():
        assert torch.equal(emulated[name], want), name
    assert sum(r.replays for r in runners) > 0
    assert all(r.forbidden == [] for r in runners), [r.forbidden[:3] for r in runners]


# ---- runners kept across calls ---------------------------------------------

def _request(m, which):
    """Request A (the module's prompts, equalizer and clip) or B (others
    under the same controller structure)."""
    from videop2p_tpu_torch.pipelines.cached import capture_windows

    if which == "A":
        ctx, x0, cond = _controller("blend"), m["x0"], m["cond"]
    else:
        rng = np.random.default_rng(11)
        ctx = _controller("blend", prompts=PROMPTS_B, ctrl=CTRL_B)
        x0, cond = t(rng.normal(size=SHAPE)), t(rng.normal(size=(2, 77, 16)))
    cross_len, window = capture_windows(ctx, EDIT_STEPS)
    return dict(ctx=ctx, x0=x0, cond=cond, cross_len=cross_len, window=window)


def _serve(m, req, invert_runner, edit_runner):
    """The served path's two loops: the capture walk, then the cached edit
    (``invert_runner`` / ``edit_runner``: a kept runner, or False)."""
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured, edit_sample

    traj, cached = ddim_inversion_captured(
        m["pfn"], m["sched"], req["x0"], req["cond"][:1], num_inference_steps=EDIT_STEPS,
        cross_len=req["cross_len"], self_window=req["window"], capture_blend=True,
        cuda_graphs=invert_runner)
    edited = edit_sample(m["pfn"], m["sched"], traj[-1], req["cond"], m["uncond"],
                         num_inference_steps=EDIT_STEPS, ctx=req["ctx"], source_uses_cfg=False,
                         cached_source=cached, cuda_graphs=edit_runner)
    out = {"trajectory": traj, "edited": edited, "blend_seq": cached.blend_seq}
    for tree in ("cross_maps", "temporal_maps"):
        out.update({f"{tree}/{p}": v for p, v in (getattr(cached, tree) or {}).items()})
    return out


def test_a_kept_runner_serves_a_then_b_then_a(models):
    """One kept runner per loop serves A, B, then A again: each result is
    the fresh eager call's bit for bit (B's replays read B's values, not
    the bodies' captures' A), the second call of each key replays, and
    the third runs no step eagerly and captures nothing."""
    cls = emulated_kept_class()
    invert, edit = cls(name="capture_inversion"), cls(name="cached_edit")
    got = []
    for which in ("A", "B", "A"):
        req = _request(models, which)
        for runner in (invert, edit):
            runner.begin_call()
        got.append((which, _serve(models, req, invert, edit)))
    fresh = {w: _serve(models, _request(models, w), False, False) for w in ("A", "B")}
    assert not torch.equal(fresh["A"]["edited"], fresh["B"]["edited"])
    for which, out in got:
        assert set(out) == set(fresh[which])
        for name, want in fresh[which].items():
            assert torch.equal(out[name], want), f"{which} {name}"
    for runner in (invert, edit):
        assert runner.forbidden == [], runner.forbidden[:5]
        last = runner.stats()
        assert (last["eager_steps"], last["graphs"]) == (0, 0), last
        assert last["replays"] == EDIT_STEPS and last["copy_in_bytes"] > 0
    # the products handed out are the call's own, not the runner's buffers
    assert got[0][1]["trajectory"].data_ptr() != got[2][1]["trajectory"].data_ptr()
    assert torch.equal(got[0][1]["edited"], got[2][1]["edited"])


def test_a_kept_live_runner_serves_a_then_b_then_a(models):
    """The live loop (``ProgramSet.sample``'s, and the official edit's with
    null-text embeddings) through one kept runner: A, B, A each equal a
    fresh eager call."""
    from videop2p_tpu_torch.pipelines import edit_sample

    runner = emulated_kept_class()(name="live_edit")
    rng = np.random.default_rng(5)
    nulls = {w: t(rng.normal(size=(EDIT_STEPS, 77, 16))) for w in "AB"}

    def call(which, flag):
        req = _request(models, which)
        return edit_sample(models["pfn"], models["sched"], req["x0"], req["cond"],
                           models["uncond"], num_inference_steps=EDIT_STEPS, ctx=req["ctx"],
                           null_uncond_embeddings=nulls[which], cuda_graphs=flag)

    for which in ("A", "B", "A"):
        runner.begin_call()
        assert torch.equal(call(which, runner), call(which, False)), which
    assert runner.forbidden == [] and runner.stats()["eager_steps"] == 0


def test_kept_inputs_refuse_another_structure():
    """A kept runner's inputs take the first call's structure only: another
    shape, dtype, key or Python-level value raises (a runner key that
    missed a field), and a matching tree is copied in place."""
    from videop2p_tpu_torch.utils.cuda_graphs import KeptRunner, StepInputs

    runner = KeptRunner("cpu", name="x")
    first = {"a": torch.ones(3), "b": (torch.zeros(2), 4)}
    bound = runner.inputs("tree", first)
    assert bound["a"] is not first["a"] and torch.equal(bound["a"], first["a"])
    again = runner.inputs("tree", {"a": torch.full((3,), 2.0), "b": (torch.ones(2), 4)})
    assert again["a"] is bound["a"] and torch.equal(bound["a"], torch.full((3,), 2.0))
    for bad in ({"a": torch.ones(4), "b": (torch.zeros(2), 4)},
                {"a": torch.ones(3, dtype=torch.float64), "b": (torch.zeros(2), 4)},
                {"a": torch.ones(3), "b": (torch.zeros(2), 5)},
                {"a": torch.ones(3)}):
        with pytest.raises(ValueError, match="kept input"):
            runner.inputs("tree", bad)
    steps = runner.inputs("steps", StepInputs({"t": [5, 3]}, "cpu"))
    runner.inputs("steps", StepInputs({"t": [7, 1]}, "cpu"))
    steps.load(1)
    assert int(steps.t) == 1
    assert runner.scratch("s", dict) is runner.scratch("s", dict)
    kept = runner.own({"x": bound["a"]})
    assert kept["x"] is not bound["a"] and torch.equal(kept["x"], bound["a"])


def test_runner_cache_lends_one_call_at_a_time_and_bounds_its_runners():
    """Two calls of one key at once get two runners; a returned runner is
    lent again; past the bound the least recently returned idle runner is
    closed; ``close`` frees the idle ones and each lent one on its return."""
    from videop2p_tpu_torch.utils.cuda_graphs import RunnerCache

    cls = emulated_kept_class()
    closed = []

    class Counted(cls):
        def close(self):
            closed.append(self.key)
            super().close()

    cache = RunnerCache("cpu", max_runners=2, make=lambda key, name: Counted(key=key, name=name))
    with cache.checkout("k", "p") as a, cache.checkout("k", "p") as b:
        assert a is not b
    with cache.checkout("k", "p") as c:
        assert c in (a, b) and c.calls == 2
    with cache.checkout("j", "p") as d:
        assert closed == ["k"] and d.key == "j"
    assert len(cache.runners()) == 2 and cache.made == 3
    with cache.checkout("j", "p") as e:
        assert e is d
        cache.close()
        assert sorted(closed) == ["k", "k"]
    assert closed[-1] == "j" and cache.runners() == []
    # a thread's runner and another thread's: never the same one at once
    seen, gate = [], threading.Barrier(2)

    def lend():
        with cache.checkout("k", "p") as r:
            seen.append(r)
            gate.wait(timeout=10)

    threads = [threading.Thread(target=lend) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert seen[0] is not seen[1]


def test_an_analysed_call_warms_a_kept_runner_eagerly(models):
    """Inside a program analysis a kept runner runs every step eagerly (the
    analysis counts the ops) and stays enabled: the next call captures each
    variant at its first step, the one after replays only."""
    from videop2p_tpu_torch.obs.introspect import ProgramAnalysis
    from videop2p_tpu_torch.pipelines import ddim_inversion

    runner = emulated_kept_class()(name="ddim_inversion")
    outs = []
    for analysed in (True, False, False):
        runner.begin_call()
        with ProgramAnalysis() if analysed else contextlib_null():
            outs.append(ddim_inversion(models["pfn"], models["sched"], models["x0"],
                                       models["cond"][:1], num_inference_steps=INV_STEPS,
                                       cuda_graphs=runner))
        stats = runner.stats()
        if analysed:
            assert runner.enabled and (stats["eager_steps"], stats["graphs"]) == (INV_STEPS, 0)
        else:
            assert stats["eager_steps"] == 0 and stats["replays"] == INV_STEPS
    assert runner.totals["graphs"] == 1
    assert all(torch.equal(o, outs[0]) for o in outs)


def contextlib_null():
    import contextlib

    return contextlib.nullcontext()


# ---- a program set on kept runners -----------------------------------------

SET_KW = dict(tiny=True, width=16, video_len=2, steps=4)
SET_PROMPTS = ("a rabbit is jumping", "a origami rabbit is jumping")
SET_CTRL = {"blend_word": ["rabbit", "rabbit"], "eq_params": {"words": ["origami"],
                                                              "values": [2]}}


@pytest.fixture(scope="module")
def kept_sets():
    """Two program sets of one spec: one on emulated kept runners, one with
    graphs off (the oracle)."""
    from videop2p_tpu_torch.serve import ProgramSet, ProgramSpec
    from videop2p_tpu_torch.serve import programs as programs_mod
    from videop2p_tpu_torch.utils.cuda_graphs import RunnerCache

    cls = emulated_kept_class()
    kept = ProgramSet(ProgramSpec(**SET_KW), device="cpu")
    kept._runners = RunnerCache("cpu", max_runners=programs_mod._RUNNERS_MAX,
                                make=lambda key, name: cls(key=key, name=name))
    kept.keeps_graphs = lambda: True
    plain = ProgramSet(ProgramSpec(**SET_KW), device="cpu")
    return kept, plain


def _set_request(ps, prompts, eq_value, seed):
    frames = np.random.default_rng(seed).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    ctx = ps.controller(prompts, blend_word=["rabbit", "rabbit"],
                        eq_params={"words": ["origami"], "values": [eq_value]})
    latents = ps.encode(ps.frames_to_video(frames))
    _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
    videos, src_err = ps.edit_decode(cached, ps.encode_prompts(prompts),
                                     ps.encode_prompts([""])[0], ctx, latents)
    return videos, src_err


def test_a_warm_set_serves_compatible_requests_without_capturing(kept_sets):
    """After ``warm()`` (the request path twice) a compatible request with
    other prompts, equalizer and clip, then a second one, run no step
    eagerly and capture nothing, and their videos and src_err (0.0) are a
    graphs-off set's bit for bit; ``close`` frees the runners."""
    kept, plain = kept_sets
    warm = kept.warm(SET_PROMPTS, controller_kwargs=SET_CTRL)
    assert warm["runners"]["runners"] == 2 and warm["runners"]["graphs"] > 0
    assert "runners" not in plain.warm(SET_PROMPTS, controller_kwargs=SET_CTRL)
    for prompts, eq, seed in ((("a rabbit is jumping", "a origami rabbit is jumping"), 3, 1),
                              (("a cat rabbit is sitting", "a origami rabbit is sitting"), 5, 2)):
        before = kept.runner_stats()
        got = _set_request(kept, prompts, eq, seed)
        after = kept.runner_stats()
        assert after["eager_steps"] == before["eager_steps"], (before, after)
        assert after["graphs"] == before["graphs"] and after["made"] == before["made"]
        assert after["replays"] > before["replays"]
        want = _set_request(plain, prompts, eq, seed)
        assert float(got[1]) == float(want[1]) == 0.0
        assert torch.equal(got[0], want[0])
    assert all(r.forbidden == [] for r in kept._runners.runners())
    kept.close()
    assert kept.runner_stats()["runners"] == 0


def test_a_set_warmed_without_blend_or_equalizer_serves_such_requests_warm(kept_sets):
    """A set warmed as ``cli.serve`` warms it (its prompts alone: no
    LocalBlend, no equalizer) serves a request of that structure with
    other prompts and another clip without capturing or an eager step,
    with the bits of a graphs-off set."""
    kept, plain = kept_sets
    kept.close()
    kept.warm(SET_PROMPTS)
    plain.warm(SET_PROMPTS)
    prompts = ("a cat rabbit is sitting", "a origami rabbit is sitting")
    frames = np.random.default_rng(5).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)

    def request(ps):
        ctx = ps.controller(prompts)
        latents = ps.encode(ps.frames_to_video(frames))
        _, cached = ps.invert_capture(latents, ps.encode_prompts(prompts[:1]), ctx)
        return ps.edit_decode(cached, ps.encode_prompts(prompts), ps.encode_prompts([""])[0],
                              ctx, latents)

    before = kept.runner_stats()
    got = request(kept)
    after = kept.runner_stats()
    assert after["eager_steps"] == before["eager_steps"], (before, after)
    assert after["graphs"] == before["graphs"] and after["made"] == before["made"]
    assert after["replays"] > before["replays"]
    want = request(plain)
    assert float(got[1]) == float(want[1]) == 0.0
    assert torch.equal(got[0], want[0])
    kept.close()


def test_a_set_without_kept_runners_warms_once(kept_sets, monkeypatch):
    """On the CPU (no CUDA graphs) a set keeps no runners: its programs run
    their loops' own default and ``warm`` runs the request path once."""
    from videop2p_tpu_torch.serve import ProgramSet

    _, plain = kept_sets
    assert plain.keeps_graphs() is False
    calls = []
    monkeypatch.setattr(ProgramSet, "invert_capture",
                        lambda self, *a, **k: calls.append(1) or (None, _Stub()))
    monkeypatch.setattr(ProgramSet, "edit_decode",
                        lambda self, *a, **k: (None, torch.zeros(())))
    plain.warm(SET_PROMPTS)
    assert calls == [1] and plain.runner_stats()["runners"] == 0


@dataclasses.dataclass
class _Stub:
    src_latents: torch.Tensor = None
