"""Latent-space pipelines: DDIM inversion (plain and capturing), null-text
optimization, the controlled edit (live or cached source, fast or full CFG),
the cached-source fast edit and the official edit."""

from videop2p_tpu_torch.pipelines.cached import CachedSource, capture_windows
from videop2p_tpu_torch.pipelines.fast import cached_fast_edit, choose_cached_maps
from videop2p_tpu_torch.pipelines.inversion import (
    ddim_inversion,
    ddim_inversion_captured,
    null_text_optimization,
)
from videop2p_tpu_torch.pipelines.sampling import edit_sample, make_unet_fn, official_edit
from videop2p_tpu_torch.pipelines.stores import blend_maps_from_store

__all__ = ["CachedSource", "capture_windows", "cached_fast_edit",
           "choose_cached_maps", "ddim_inversion", "ddim_inversion_captured",
           "null_text_optimization", "edit_sample", "make_unet_fn", "official_edit",
           "blend_maps_from_store"]
