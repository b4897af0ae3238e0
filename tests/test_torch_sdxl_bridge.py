"""The SDXL-shaped UNet's surroundings in the port against the JAX package,
on the CPU: its controlled sites (the capture's maps, their heads and query
tokens, and their bytes; the keys the port's own capture stores them under)
against the shapes of JAX's capture, at the reduced
width of tests/test_torch_sdxl.py; and the weight bridge at SDXL's depth of
10 transformer blocks a site. All checks are exact.
"""

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_cached import _flax_path
from tests.test_torch_sdxl import SMALL, _pair


def test_sdxl_controlled_sites_match_jax_capture():
    """The port's controlled-site map (``pipelines/fast.py:_controlled_sites``)
    names every map JAX's capture holds, with its heads and query tokens,
    and ``capture_bytes`` counts JAX's bytes."""
    from videop2p_tpu.core import DDIMScheduler as JaxDDIM
    from videop2p_tpu.pipelines import make_unet_fn as jax_unet_fn
    from videop2p_tpu.pipelines.cached import tree_bytes
    from videop2p_tpu.pipelines.fast import capture_shapes

    from videop2p_tpu_torch.core import DDIMScheduler
    from videop2p_tpu_torch.pipelines import ddim_inversion_captured, make_unet_fn
    from videop2p_tpu_torch.pipelines.fast import _controlled_sites, capture_bytes

    from videop2p_tpu.models import UNet3DConditionModel, UNet3DConfig

    from videop2p_tpu_torch.models.unet import UNet3DConditionModel as PortUNet
    from videop2p_tpu_torch.models.unet import UNet3DConfig as PortConfig

    # shapes only: no weights are needed on either side
    jmodel = UNet3DConditionModel(config=UNet3DConfig.sdxl(**SMALL))
    pmodel = PortUNet(PortConfig.sdxl(**SMALL))
    shape = (1, 2, 8, 8, 4)
    variables = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros(shape),
                               jnp.asarray(0), jnp.zeros((1, 77, 16)))
    _, cached = capture_shapes(jax_unet_fn(jmodel), variables, JaxDDIM.create_sd(),
                               jnp.zeros(shape), jnp.zeros((1, 77, 16)), None,
                               num_inference_steps=2, cross_len=1, self_window=(0, 2))
    want = {}
    for site, tree in (("cross", cached.cross_maps), ("temporal", cached.temporal_maps)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path if hasattr(p, "key") and p.key != "probs"]
            # cross: (steps, B·F, H, Q, L); temporal: (steps, B·Q, H, F, F)
            tokens = leaf.shape[3] if site == "cross" else leaf.shape[1] // shape[0]
            want[_flax_path(keys)] = (site, leaf.shape[2], tokens)
    assert len(want) == 36  # 18 transformer blocks
    assert _controlled_sites(pmodel, shape[2:4]) == want
    # the port's own capture stores its maps under the same keys (the
    # UNet's store, keyed by module path)
    _, port = ddim_inversion_captured(make_unet_fn(pmodel), DDIMScheduler.create_sd(),
                                      torch.zeros(shape), torch.zeros(1, 77, 16),
                                      num_inference_steps=2, cross_len=1, self_window=(0, 2))
    assert {**{k: "cross" for k in port.cross_maps},
            **{k: "temporal" for k in port.temporal_maps}} == {
        k: v[0] for k, v in want.items()}
    assert capture_bytes(pmodel, shape, 77, cross_len=1, self_window=(0, 2)) == tree_bytes(
        (cached.cross_maps, cached.temporal_maps))


def test_weight_bridge_at_sdxl_depth():
    """Ten transformer blocks a site (SDXL's deep level), carried from the
    port through JAX's converter and back with the port's: every weight
    lands, ``transformer_blocks.9`` at each deep site, and the flax paths
    name ``blocks_0`` … ``blocks_9``."""
    from videop2p_tpu_torch.models.convert import unet_jax_paths

    _, variables, pmodel = _pair(seed=5, transformer_depth=(1, 2, 10))
    sd = pmodel.state_dict()
    deep = ("down_blocks.2.attentions.0", "mid_block.attentions.0",
            "up_blocks.0.attentions.0", "up_blocks.0.attentions.1")
    for site in deep:
        assert any(k.startswith(f"{site}.transformer_blocks.9.") for k in sd), site
        assert not any(k.startswith(f"{site}.transformer_blocks.10.") for k in sd), site
    paths = unet_jax_paths(pmodel)
    blocks = {p[2] for name, p in paths.items() if name.startswith("mid_block.attentions.0.")
              and p[2].startswith("blocks_")}
    assert blocks == {f"blocks_{i}" for i in range(10)}
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert len(flat) == len(list(pmodel.parameters()))
