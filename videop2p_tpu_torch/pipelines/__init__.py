"""Latent-space pipelines: DDIM inversion (plain and capturing), the
controlled edit (live or cached source) and the cached-source fast edit."""

from videop2p_tpu_torch.pipelines.cached import CachedSource, capture_windows
from videop2p_tpu_torch.pipelines.fast import cached_fast_edit, choose_cached_maps
from videop2p_tpu_torch.pipelines.inversion import ddim_inversion, ddim_inversion_captured
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["CachedSource", "capture_windows", "cached_fast_edit",
           "choose_cached_maps", "ddim_inversion", "ddim_inversion_captured",
           "edit_sample", "make_unet_fn", "blend_maps_from_store"]
