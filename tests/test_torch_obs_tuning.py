"""Stage 1's telemetry on the CPU: ``train_steps(telemetry=True)``'s
pre-clip gradient norms against the JAX package's on the port's own draws
(the tuning CLI's ledger is ``tests/test_torch_cli_obs.py``).

Tolerances: each step's gradient norm within 1e-4 relative of JAX's (the
UNet's summation order; ``tests/test_torch_train_step.py`` holds one step
at 1e-5); the losses with telemetry on = off, bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_parity import t
from tests.test_torch_tune import LR, SHAPE, pair  # noqa: F401

STEPS = 2
SEED = 11
GNORM_RTOL = 1e-4


def _jax_grad_norm_fn(pair):
    """JAX's pre-clip global norm of the trainable gradients, as a function
    of the port's parameters ``sd`` and the draws ``noise`` / ``ts`` (one
    jitted program for every step)."""
    from videop2p_tpu.core import DDPMScheduler as JaxDDPM
    from videop2p_tpu.models.convert import unet3d_params_from_torch
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.train.masking import merge_params, partition_params

    jfn, sched = jax_unet_fn(pair["jmodel"]), JaxDDPM.create_sd()
    lat, text = jnp.asarray(pair["latents"]), jnp.asarray(pair["text"])

    @jax.jit
    def norm(trainable, frozen, noise, ts):
        def loss_fn(tr):
            pred, _ = jfn({"params": merge_params(tr, frozen)},
                          sched.add_noise(lat, noise, ts), ts, text, None)
            return jnp.mean((pred - sched.training_target(lat, noise, ts)) ** 2)

        grads = jax.grad(loss_fn)(trainable)
        return jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads)))

    def fn(sd, noise, ts):
        params, _ = unet3d_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                             pair["variables"]["params"],
                                             strict_missing=True)
        with jax.default_matmul_precision("highest"):
            return float(norm(*partition_params(params), noise, ts))

    return fn


def test_train_steps_grad_norms_match_jax(pair):  # noqa: F811
    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.core.noise import step_generator
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_steps

    cfg = TuneConfig(learning_rate=LR, max_train_steps=STEPS)
    sched = DDPMScheduler.create_sd()
    lat, text = t(pair["latents"]), t(pair["text"])
    runs = {}
    for telemetry in (True, False):
        model = copy.deepcopy(pair["pmodel"])
        tx = make_optimizer(cfg)
        state = TrainState.create(model, tx)
        states, out = [], []
        for _ in range(STEPS):  # one step a call: the parameters each step saw
            states.append({k: v.detach().clone() for k, v in model.state_dict().items()})
            out.append(train_steps(make_unet_fn(model), tx, state, sched, lat, text, SEED,
                                   num_steps=1, telemetry=telemetry))
        runs[telemetry] = (states, out)
    states, out = runs[True]
    losses = torch.cat([o[1] for o in out])
    assert torch.equal(losses, torch.cat([o[1] for o in runs[False][1]]))
    norms = torch.cat([o[2] for o in out])
    assert norms.shape == (STEPS,) and torch.isfinite(norms).all()
    jax_norm = _jax_grad_norm_fn(pair)
    for step in range(STEPS):
        # the draws train_step takes from the step's generator, in its order
        gen = step_generator(SEED, step, lat.device)
        noise = torch.randn(lat.shape, generator=gen, dtype=lat.dtype)
        ts = torch.randint(0, sched.num_train_timesteps, (SHAPE[0],), generator=gen)
        want = jax_norm(states[step], jnp.asarray(noise.numpy()), jnp.asarray(ts.numpy()))
        got = float(norms[step])
        assert abs(got - want) <= GNORM_RTOL * want, (step, got, want)
