"""Shared helpers (no tests of its own) of the parity tests between the JAX
package and its PyTorch port (tests/test_torch_*.py).

Both packages run on the CPU in float32; the JAX side runs jitted under
``jax.default_matmul_precision("highest")``. Inputs are made with numpy from
a seed and handed to both sides.

Weights: the port's module is initialized from a seed (fast, where a flax
``init`` would compile for tens of seconds), moved into the JAX module's
parameter tree with the JAX package's own importer
(``unet3d_params_from_torch``), perturbed there (norm scales and biases
moved off 1/0; the temporal output projection, which the JAX init zeroes,
made non-zero so the temporal edit is not multiplied away), and carried
back into the port with the port's ``models/convert.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def perturb(params, seed: int = 7):
    """Copy of a flax param tree with non-trivial norms/biases and non-zero
    ``attn_temp/to_out`` kernels."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        node = np.asarray(node, np.float32)
        if "attn_temp" in path and "to_out" in path:
            node = rng.normal(0.0, 0.3, node.shape)
        elif node.ndim == 1:
            node = node + rng.normal(0.0, 0.1, node.shape)
        return jnp.asarray(node, jnp.float32)

    return walk(dict(params), ())


def carry_params(port_module, jax_module, init_args, *, seed: int = 0, prefix=None):
    """Seeded weights for ``jax_module`` and ``port_module`` alike; returns
    the flax ``{"params": ...}`` variables. ``prefix`` nests the tree under
    one more flax name for the carry back (a standalone transformer needs
    ``attentions_0`` so its proj_in/proj_out take the 1×1-conv layout)."""
    from videop2p_tpu.models.convert import unet3d_params_from_torch

    from videop2p_tpu_torch.models.convert import init_weights, unet_state_dict_from_jax

    init_weights(port_module, seed)
    sd = {k: v.numpy() for k, v in port_module.state_dict().items()}
    abstract = jax.eval_shape(jax_module.init, jax.random.key(0), *init_args)["params"]
    params, _ = unet3d_params_from_torch(sd, abstract, strict_missing=True)
    params = perturb(params, seed + 100)
    tree = {prefix: params} if prefix else params
    back = unet_state_dict_from_jax(tree)
    if prefix:
        head = prefix.replace("_", ".") + "."
        back = {k.removeprefix(head): v for k, v in back.items()}
    port_module.load_state_dict(back, strict=True)
    port_module.eval()
    return {"params": params}


def tiny_unet_pair(seed: int = 0, frames: int = 2):
    """(jax model, jax variables, port model) for ``UNet3DConfig.tiny()``
    with identical weights."""
    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig

    from videop2p_tpu_torch.models.unet import (
        UNet3DConditionModel as PortUNet,
        UNet3DConfig as PortConfig,
    )

    jmodel = UNet3DConditionModel(config=UNet3DConfig.tiny())
    pmodel = PortUNet(PortConfig.tiny())
    variables = carry_params(
        pmodel, jmodel,
        (jnp.zeros((1, frames, 8, 8, 4)), jnp.asarray(0), jnp.zeros((1, 77, 16))),
        seed=seed)
    return jmodel, variables, pmodel


def jit_apply(module, *args, **kwargs):
    """``module.apply`` jitted, at float32 matmul precision."""
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda *a: module.apply(*a, **kwargs))(*args)
