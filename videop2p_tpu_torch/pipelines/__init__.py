"""Latent-space pipelines: DDIM inversion and the controlled edit."""

from videop2p_tpu_torch.pipelines.inversion import ddim_inversion
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["ddim_inversion", "edit_sample", "make_unet_fn", "blend_maps_from_store"]
