"""Attention control (prompt-to-prompt): plain functions, no hooks."""

from videop2p_tpu_torch.control.controllers import (
    ControlContext,
    control_attention,
    get_equalizer,
    make_controller,
    make_spatial_replace_controller,
)
from videop2p_tpu_torch.control.local_blend import (
    LocalBlendConfig,
    blend_mask,
    local_blend,
    make_local_blend,
)
from videop2p_tpu_torch.control.schedules import (
    get_time_words_attention_alpha,
    get_word_inds,
)
from videop2p_tpu_torch.control.seq_aligner import (
    get_refinement_mapper,
    get_replacement_mapper,
)

__all__ = [
    "ControlContext",
    "control_attention",
    "get_equalizer",
    "make_controller",
    "make_spatial_replace_controller",
    "LocalBlendConfig",
    "blend_mask",
    "local_blend",
    "make_local_blend",
    "get_time_words_attention_alpha",
    "get_word_inds",
    "get_refinement_mapper",
    "get_replacement_mapper",
]
