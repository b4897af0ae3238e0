"""The port's trainable-set rule and the bridge's inverse name map against
the JAX package, on the CPU: every port UNet parameter's flax path equals
the path of the JAX parameter the bridge carries onto it (tiny and SD-1.5
shapes, nothing allocated: JAX through ``jax.eval_shape``, the port on the
meta device), and a train step over an empty trainable set, which JAX
takes, runs in the port too.

Tolerances: names and paths exactly; the empty step's loss 1e-5 relative
against JAX's (the UNet's summation order); its weights bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import t
from tests.test_torch_tune import SHAPE, pair  # noqa: F401


@pytest.mark.parametrize("preset", ["tiny", "sd15"])
def test_inverse_name_map_gives_jax_paths(preset):
    from flax import traverse_util
    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig

    from videop2p_tpu_torch.models.convert import _unet_key, unet_jax_paths
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig

    jcfg = getattr(UNet3DConfig, preset)()
    params = jax.eval_shape(UNet3DConditionModel(config=jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 2, 8, 8, 4)), jnp.asarray(0),
                            jnp.zeros((1, 77, jcfg.cross_attention_dim)))["params"]
    jax_paths = set(traverse_util.flatten_dict(params))
    with torch.device("meta"):
        pmodel = PortUNet(getattr(PortConfig, preset)())
    paths = unet_jax_paths(pmodel)
    assert sorted(paths) == sorted(n for n, _ in pmodel.named_parameters())
    assert set(paths.values()) == jax_paths
    assert all(_unet_key(path)[0] == name for name, path in paths.items())


@pytest.mark.parametrize("pattern", ["attn1.to_q", "attn2.to_q.kernel", "conv", "scale",
                                     "attn_temp.to_out", "down_blocks_0.resnets_1"])
def test_token_rule_matches_jax_on_paths(pattern):
    """JAX's ``_matches`` and the port's on the same token lists."""
    from videop2p_tpu.train.masking import _matches as jax_matches

    from videop2p_tpu_torch.models.convert import unet_jax_paths
    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig
    from videop2p_tpu_torch.train.masking import _matches

    with torch.device("meta"):
        pmodel = PortUNet(PortConfig.tiny())
    for path in unet_jax_paths(pmodel).values():
        assert _matches(path, pattern) == jax_matches(list(path), pattern), path


def test_empty_trainable_set_takes_a_step(pair):
    """A pattern that matches nothing: JAX's step computes the loss and
    counts; the port's does the same, moves no weight and keeps no Adam
    moments."""
    from videop2p_tpu.core import DDPMScheduler as JaxDDPM
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.train import TrainState as JaxState
    from videop2p_tpu.train import TuneConfig as JaxCfg
    from videop2p_tpu.train import make_optimizer as jax_optimizer
    from videop2p_tpu.train import train_step as jax_train_step

    from videop2p_tpu_torch.core import DDPMScheduler
    from videop2p_tpu_torch.pipelines import make_unet_fn
    from videop2p_tpu_torch.train import TrainState, TuneConfig, make_optimizer, train_step

    patterns = ("no_such_module",)
    key = jax.random.key(0)
    # JAX's draws, re-derived from its key splits (train_step's own order)
    noise_key, t_key = jax.random.split(key)
    noise = np.asarray(jax.random.normal(noise_key, SHAPE, jnp.float32))
    ts = np.asarray(jax.random.randint(t_key, (SHAPE[0],), 0, 1000))
    jsched = JaxDDPM.create_sd()
    jtx = jax_optimizer(JaxCfg())
    jstate = JaxState.create(pair["variables"]["params"], jtx, patterns)
    jfn = jax_unet_fn(pair["jmodel"])
    with jax.default_matmul_precision("highest"):
        jnew, want = jax.jit(lambda st, lat, text: jax_train_step(
            jfn, jtx, st, jsched, lat, text, key))(
            jstate, jnp.asarray(pair["latents"]), jnp.asarray(pair["text"]))
    assert int(jnew.step) == 1

    pmodel = copy.deepcopy(pair["pmodel"])
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    tx = make_optimizer(TuneConfig(trainable_modules=patterns))
    state = TrainState.create(pmodel, tx, patterns)
    assert state.trainable == {}
    state, loss, gnorm = train_step(make_unet_fn(pmodel), tx, state, DDPMScheduler.create_sd(),
                                    t(pair["latents"]), t(pair["text"]), noise=t(noise),
                                    timesteps=torch.tensor(ts), return_grad_norm=True)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    assert gnorm.item() == 0.0
    assert state.step == 1 and state.opt_state["count"] == 1
    assert state.opt_state["mu"] == [] and state.opt_state["nu"] == []
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
