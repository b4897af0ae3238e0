"""One Stage-1 train step of the port against the JAX package's, on the CPU
in float32 with identical tiny-UNet weights (4 frames), on JAX's own draws:
i.i.d. noise, frame-dependent noise (JAX's standard normals through the
port's ``transform``) and gradient accumulation over 2 steps.

JAX's noise and timesteps are re-derived from its key splits and handed to
the port (``train_step(noise=, timesteps=)``); JAX's gradients come from
``jax.grad`` of its step's loss inside the same jitted program.

Tolerances: the loss and the pre-clip gradient norm 1e-5 relative; each
pre-clip gradient and the updated trainable tensors 1e-4·max|ref| (the
UNet's summation order, ~1e-6 relative; Adam turns a gradient difference
into a step of up to lr·sign(g)); JAX's noise through the port's
``transform`` 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import np32, t
from tests.test_torch_tune import LR, SAMPLER, SHAPE, pair  # noqa: F401


class _Recording:
    """Wraps the port's optimizer and keeps the gradients it was given."""

    def __init__(self, tx):
        self.tx, self.grads = tx, []

    def init(self, params):
        return self.tx.init(params)

    def update_(self, params, grads, state):
        self.grads.append([g.clone() for g in grads])
        return self.tx.update_(params, grads, state)


def _jax_steps(pair, cfg_kw, keys, dependent):
    """JAX's train_step over ``keys``; returns per step (loss, pre-clip
    grad norm, the trainable tree after it, the gradient tree, the noise and
    the standard normals it drew, the timesteps)."""
    from videop2p_tpu.core import DDPMScheduler as JaxDDPM
    from videop2p_tpu.core import DependentNoiseSampler as JaxSampler
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.train import TrainState as JaxState
    from videop2p_tpu.train import TuneConfig as JaxCfg
    from videop2p_tpu.train import make_optimizer as jax_optimizer
    from videop2p_tpu.train import train_step as jax_train_step
    from videop2p_tpu.train.masking import merge_params

    jfn, sched = jax_unet_fn(pair["jmodel"]), JaxDDPM.create_sd()
    sampler = JaxSampler.create(**SAMPLER) if dependent else None
    tx = jax_optimizer(JaxCfg(**cfg_kw))
    lat, text = jnp.asarray(pair["latents"]), jnp.asarray(pair["text"])

    def step(state, key):
        noise_key, t_key = jax.random.split(key)
        if sampler is not None:
            nw, ws = sampler.num_windows, sampler.window_size
            z = jax.random.normal(noise_key, (SHAPE[0],) + SHAPE[2:] + (nw, ws))
            noise = sampler.sample_like(noise_key, lat)
        else:
            z = noise = jax.random.normal(noise_key, lat.shape, lat.dtype)
        ts = jax.random.randint(t_key, (SHAPE[0],), 0, sched.num_train_timesteps)

        def loss_fn(trainable):
            params = merge_params(trainable, state.frozen)
            pred, _ = jfn({"params": params}, sched.add_noise(lat, noise, ts), ts, text, None)
            target = sched.training_target(lat, noise, ts)
            return jnp.mean((pred - target) ** 2)

        grads = jax.grad(loss_fn)(state.trainable)
        new, loss, gnorm = jax_train_step(jfn, tx, state, sched, lat, text, key,
                                          dependent_sampler=sampler, return_grad_norm=True)
        return new, (loss, gnorm, new.trainable, grads, noise, z, ts)

    state = JaxState.create(pair["variables"]["params"], tx)
    out = []
    with jax.default_matmul_precision("highest"):
        jstep = jax.jit(step)
        for key in keys:
            state, rec = jstep(state, key)
            out.append(jax.tree.map(np.asarray, rec))
    return out


def _port_name_tree(tree):
    from videop2p_tpu_torch.models.convert import unet_state_dict_from_jax

    return {k: v.numpy() for k, v in unet_state_dict_from_jax(tree).items()}


@pytest.mark.parametrize("mode", ["iid", "dependent", "accumulate"])
def test_train_step_matches_jax(pair, mode):
    import copy

    from videop2p_tpu_torch.core import DDPMScheduler, DependentNoiseSampler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_step

    cfg_kw = dict(learning_rate=LR, gradient_accumulation_steps=2 if mode == "accumulate" else 1)
    keys = [jax.random.fold_in(jax.random.key(11), s)
            for s in range(2 if mode == "accumulate" else 1)]
    want = _jax_steps(pair, cfg_kw, keys, dependent=mode == "dependent")

    pmodel = copy.deepcopy(pair["pmodel"])
    tx = _Recording(make_optimizer(TuneConfig(**cfg_kw)))
    state = TrainState.create(pmodel, tx)
    fn, sched = make_unet_fn(pmodel), DDPMScheduler.create_sd()
    sampler = DependentNoiseSampler.create(**SAMPLER)
    for k, (loss_w, gnorm_w, trainable_w, grads_w, noise_w, z, ts) in enumerate(want):
        noise = sampler.transform(t(z)) if mode == "dependent" else t(noise_w)
        np.testing.assert_allclose(np32(noise), noise_w, rtol=0, atol=1e-6)
        _, loss, gnorm = train_step(fn, tx, state, sched, t(pair["latents"]), t(pair["text"]),
                                    noise=noise, timesteps=torch.tensor(ts),
                                    return_grad_norm=True)
        np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
        np.testing.assert_allclose(gnorm.item(), float(gnorm_w), rtol=1e-5)
        grads = dict(zip(state.trainable, tx.grads[k]))
        for name, g in _port_name_tree(grads_w).items():
            scale = np.abs(g).max()
            assert np.abs(np32(grads[name]) - g).max() <= 1e-4 * scale, name
        assert state.step == k + 1
    ref = _port_name_tree(want[-1][2])
    assert sorted(ref) == sorted(state.trainable)
    for name, p in ref.items():
        assert np.abs(np32(state.trainable[name]) - p).max() <= 1e-4 * np.abs(p).max(), name
    moved = [not torch.equal(state.trainable[n], pair["pmodel"].state_dict()[n])
             for n in state.trainable]
    assert all(moved)
