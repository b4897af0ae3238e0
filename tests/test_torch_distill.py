"""Consistency distillation in the port against the JAX package's
``train/distill.py``, on the CPU in float32 with identical tiny-UNet weights:
the DDIM forward process, the time head, one distillation step on JAX's own
draws, the chunking of the loop, the student checkpoint and the CLI's
``run_distillation`` (the student's cached edit: tests/test_torch_student.py).

JAX's noise and grid indices are re-derived from its key splits and handed
to the port (``distill_step(noise=, n=)``); JAX's gradients come from
``jax.grad`` of its step's loss inside the same jitted program.

Tolerances: ``add_noise`` / ``get_velocity`` and the time head 1e-6 (float32
elementwise math and one small matrix product); the step's loss and
pre-clip gradient norm 1e-5 relative; each gradient, the updated subset and
head and the EMA subset and head 1e-4·max|ref| (the UNet's summation order,
~1e-6 relative, through three forwards; Adam turns a gradient difference
into a step of up to lr·sign(g)). A zero head and ε: bit for bit.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t
from tests.test_torch_train_step import _port_name_tree, _Recording
from tests.test_torch_tune import pair  # noqa: F401  (the fixture)

GRID = 4
LR = 3e-5


def _np_head(seed: int, embed: int = 8, channels: int = 4) -> dict:
    """A trained-looking head (every layer non-zero) as JAX's nested tree."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"dense1": {"kernel": normal(embed, embed, scale=0.3), "bias": normal(embed, scale=0.1)},
            "dense2": {"kernel": normal(embed, 2 * channels, scale=0.2),
                       "bias": normal(2 * channels, scale=0.1)}}


def _port_head(tree) -> dict:
    return {f"{layer}.{leaf}": t(tree[layer][leaf]) for layer in ("dense1", "dense2")
            for leaf in ("kernel", "bias")}


def test_ddim_forward_process_matches_jax():
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM

    from videop2p_tpu_torch.core import DDIMScheduler

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    ts = np.array([1, 500, 999])
    jsched, psched = JaxDDIM.create_sd(), DDIMScheduler.create_sd()
    for name in ("add_noise", "get_velocity"):
        want = np.asarray(getattr(jsched, name)(jnp.asarray(x0), jnp.asarray(noise),
                                                jnp.asarray(ts)))
        got = getattr(psched, name)(t(x0), t(noise), torch.tensor(ts))
        np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6, err_msg=name)
        # a scalar timestep broadcasts over the batch
        one = getattr(psched, name)(t(x0), t(noise), 500)
        np.testing.assert_allclose(np32(one[1]), want[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("timestep", [10, [10, 700]])
def test_time_head_matches_jax_and_a_zero_head_is_the_identity(timestep):
    from videop2p_tpu.train.distill import apply_time_head as jax_apply

    from videop2p_tpu_torch.models.unet import UNet3DConfig
    from videop2p_tpu_torch.train import apply_time_head, init_time_head

    eps = np.random.default_rng(1).normal(size=(2, 2, 4, 4, 4)).astype(np.float32)
    head = _np_head(2)
    want = np.asarray(jax_apply(jax.tree.map(jnp.asarray, head), jnp.asarray(eps),
                                jnp.asarray(timestep)))
    got = apply_time_head(_port_head(head), t(eps), torch.tensor(timestep))
    np.testing.assert_allclose(np32(got), want, rtol=0, atol=1e-6)
    assert np.abs(want - eps).max() > 1e-2  # the head modulates
    zero = init_time_head(torch.Generator().manual_seed(0), UNet3DConfig.tiny())
    assert zero["dense1.kernel"].abs().max() > 0
    for x in (t(eps), t(eps).to(torch.bfloat16)):
        out = apply_time_head(zero, x, torch.tensor(timestep))
        assert out.dtype == x.dtype and torch.equal(out, x)


def _jax_step(pair, head, key, cfg_kw):
    """JAX's distill_step at ``key``: (loss, pre-clip grad norm, the updated
    subset, head, EMA subset and EMA head, the gradient trees of the subset
    and the head, the noise and grid indices it drew). One compiled program
    for the module's calls."""
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.train import distill as jd
    from videop2p_tpu.train.masking import merge_params

    jfn, sched = jax_unet_fn(pair["jmodel"]), JaxDDIM.create_sd(steps_offset=1)
    cfg = jd.DistillConfig(**cfg_kw)
    tx = jd.make_distill_optimizer(cfg)
    lat, text = jnp.asarray(pair["latents"]), jnp.asarray(pair["text"])
    ts_np = np.asarray(sched.timesteps(GRID))
    ts = jnp.asarray(ts_np)
    prev_ts = jnp.concatenate([ts[1:], jnp.asarray([int(ts_np[-1]) - 1000 // GRID])])

    def step(state, key):
        noise_key, n_key = jax.random.split(key)
        noise = jax.random.normal(noise_key, lat.shape, lat.dtype)
        n = jax.random.randint(n_key, (lat.shape[0],), 0, GRID)
        # the step's loss as distill_step writes it, for its gradient
        t_hi, t_lo = ts[n], prev_ts[n]
        t_lo_in = jnp.maximum(t_lo, 0)
        x_hi = sched.add_noise(lat, noise, t_hi)
        eps_t = jfn({"params": state.teacher_params}, x_hi, t_hi, text, None)[0]
        x_lo = jd._ddim_solve(sched, eps_t, t_hi, t_lo, x_hi)
        ema = merge_params(state.ema_trainable, state.frozen)
        eps_e = jd.apply_time_head(state.ema_head,
                                   jfn({"params": ema}, x_lo, t_lo_in, text, None)[0], t_lo_in)
        boundary = (t_lo < 0).reshape((-1,) + (1,) * (lat.ndim - 1))
        target = jnp.where(boundary, lat, jd._pred_x0(sched, eps_e, t_lo_in, x_lo))
        weight = jnp.where(boundary, jnp.float32(cfg.boundary_weight), 1.0)

        def loss_fn(student):
            params = merge_params(student["unet"], state.frozen)
            eps_s = jfn({"params": params}, x_hi, t_hi, text, None)[0]
            eps_s = jd.apply_time_head(student["head"], eps_s, t_hi)
            return jnp.mean(weight * (jd._pred_x0(sched, eps_s, t_hi, x_hi) - target) ** 2)

        grads = jax.grad(loss_fn)({"unet": state.trainable, "head": state.head})
        new, loss, gnorm = jd.distill_step(jfn, tx, state, sched, lat, text, key, cfg=cfg,
                                           return_grad_norm=True)
        return (loss, gnorm, new.trainable, new.head, new.ema_trainable, new.ema_head,
                grads, noise, n)

    state = jd.DistillState.create(pair["variables"]["params"],
                                   jax.tree.map(jnp.asarray, head), tx)
    jitted = pair.setdefault("jax_distill_step", {}).setdefault(
        repr(sorted(cfg_kw.items())), jax.jit(step))
    with jax.default_matmul_precision("highest"):
        return jax.tree.map(np.asarray, jitted(state, key))


def _key_with_index(boundary: bool):
    """The first of JAX's step keys whose grid draw is the boundary index
    (GRID − 1), or an interior one."""
    for s in range(64):
        key = jax.random.fold_in(jax.random.key(21), s)
        n = int(jax.random.randint(jax.random.split(key)[1], (1,), 0, GRID)[0])
        if (n == GRID - 1) == boundary:
            return key, n
    raise AssertionError("no such key")


def _close(got, want, what):
    scale = np.abs(want).max()
    assert np.abs(np32(got) - want).max() <= 1e-4 * scale, what


@pytest.mark.parametrize("boundary", [False, True], ids=["interior", "boundary"])
def test_distill_step_matches_jax_on_its_draws(pair, boundary):
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        distill_step,
        make_distill_optimizer,
    )

    cfg_kw = dict(learning_rate=LR, distill_grid=GRID, boundary_weight=1.5)
    key, n = _key_with_index(boundary)
    head = _np_head(3)
    (loss_w, gnorm_w, sub_w, head_w, ema_sub_w, ema_head_w, grads_w, noise_w,
     n_w) = _jax_step(pair, head, key, cfg_kw)
    assert int(n_w[0]) == n

    pmodel = copy.deepcopy(pair["pmodel"])
    cfg = DistillConfig(**cfg_kw)
    tx = _Recording(make_distill_optimizer(cfg))
    state = DistillState.create(pmodel, _port_head(head), tx)
    _, loss, gnorm = distill_step(make_unet_fn(pmodel), tx, state,
                                  DDIMScheduler.create_sd(steps_offset=1),
                                  t(pair["latents"]), t(pair["text"]), cfg=cfg,
                                  noise=t(noise_w), n=torch.tensor(n_w), return_grad_norm=True)
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(gnorm.item(), float(gnorm_w), rtol=1e-5)
    grads = dict(zip(list(state.trainable) + list(state.head), tx.grads[0]))
    want_sub = _port_name_tree(grads_w["unet"])
    assert sorted(want_sub) == sorted(state.trainable)
    for name, g in {**want_sub, **_port_head(grads_w["head"])}.items():
        _close(grads[name], np32(g), f"grad {name}")
    for got, want in ((state.trainable, _port_name_tree(sub_w)),
                      (state.head, _port_head(head_w)),
                      (state.ema_trainable, _port_name_tree(ema_sub_w)),
                      (state.ema_head, _port_head(ema_head_w))):
        for name, p in want.items():
            _close(got[name], np32(p), name)
    # the teacher's snapshot stays, the student's tensors are the UNet's own
    teacher = pair["pmodel"].state_dict()
    assert all(torch.equal(v, teacher[k]) for k, v in state.teacher_trainable.items())
    assert all(state.trainable[k] is p for k, p in pmodel.named_parameters()
               if k in state.trainable)
    assert state.step == 1


def _port_distill(pair, seed, chunks):
    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.models.unet import UNet3DConfig
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import (
        DistillConfig,
        DistillState,
        distill_steps,
        init_time_head,
        make_distill_optimizer,
    )

    pmodel = copy.deepcopy(pair["pmodel"])
    cfg = DistillConfig(learning_rate=1e-3, distill_grid=GRID)
    tx = make_distill_optimizer(cfg)
    head = init_time_head(torch.Generator().manual_seed(seed), UNet3DConfig.tiny())
    state = DistillState.create(pmodel, head, tx)
    fn, sched = make_unet_fn(pmodel), DDIMScheduler.create_sd(steps_offset=1)
    losses = [distill_steps(fn, tx, state, sched, t(pair["latents"]), t(pair["text"]), seed,
                            num_steps=k, cfg=cfg)[1] for k in chunks]
    return state, torch.cat(losses)


def test_distill_steps_do_not_depend_on_chunking(pair):
    a, losses_a = _port_distill(pair, 5, [4])
    b, losses_b = _port_distill(pair, 5, [2, 2])
    assert a.step == b.step == 4
    assert torch.equal(losses_a, losses_b)
    for got, want in ((b.trainable, a.trainable), (b.head, a.head),
                      (b.ema_trainable, a.ema_trainable), (b.ema_head, a.ema_head)):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(a.head["dense2.kernel"], torch.zeros_like(a.head["dense2.kernel"]))


def test_save_and_load_student_round_trip(pair, tmp_path):
    from videop2p_tpu_torch.models.unet import UNet3DConfig
    from videop2p_tpu_torch.train import load_student, save_student

    state, _ = _port_distill(pair, 6, [2])
    path = save_student(str(tmp_path / "student"), state, 2)
    assert path.endswith("checkpoint-2")
    teacher = pair["pmodel"]
    params, head = load_student(path, teacher, UNet3DConfig.tiny())
    own = dict(teacher.named_parameters())
    assert sorted(params) == sorted(own)
    for name, p in params.items():
        want = state.trainable[name] if name in state.trainable else own[name]
        assert torch.equal(p, want), name
        assert (name in state.trainable) == (not torch.equal(p, own[name])), name
    assert all(torch.equal(head[k], state.head[k]) for k in state.head)
    with pytest.raises(ValueError, match="another parameter set"):
        load_student(path, teacher, UNet3DConfig.tiny(), ("attn1.to_q",))


def test_run_distillation_writes_the_student(tmp_path):
    """Stage 1 at tiny size, then ``run_distillation`` from its directory:
    ``student/checkpoint-<n>`` holds the subset and the head, and loads over
    the tuned UNet."""
    from tests.test_torch_cli_tuning import _cfg

    from videop2p_tpu_torch.cli.common import build_models
    from videop2p_tpu_torch.cli.run_tuning import main, run_distillation
    from videop2p_tpu_torch.train import load_student, trainable_mask

    cfg = _cfg(tmp_path, "distill", max_train_steps=2, checkpointing_steps=0,
               validation_steps=2, dependent=False, dependent_weights=0.0)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        out = main(**cfg, device="cpu")
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        path = run_distillation(out, cfg["train_data"], distill_steps=3, distill_grid=GRID,
                                tiny=True, seed=cfg["seed"], steps_per_call=2,
                                device="cpu")
    assert path == os.path.join(out, "student", "checkpoint-3")
    unet = build_models(out, tiny=True, device="cpu").unet
    params, head = load_student(path, unet, unet.config)
    mask = trainable_mask(unet)
    own = dict(unet.named_parameters())
    assert any(not torch.equal(params[k], own[k]) for k in own if mask[k])
    assert all(torch.equal(params[k], own[k]) for k in own if not mask[k])
    assert torch.isfinite(head["dense2.kernel"]).all()
