"""Kernels of the port (CUDA C++ in ``csrc/``) with their plain versions."""

from videop2p_tpu_torch.ops.attention import (
    chunked_frame_attention,
    dense_frame_attention,
    frame_attention,
    fused_frame_attention,
)
from videop2p_tpu_torch.ops.groupnorm import fused_group_norm, group_norm_reference

__all__ = [
    "chunked_frame_attention",
    "dense_frame_attention",
    "frame_attention",
    "fused_frame_attention",
    "fused_group_norm",
    "group_norm_reference",
]
