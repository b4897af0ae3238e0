"""Mesh, collectives and sequence-parallel attention: the distributed layer
(port of ``videop2p_tpu/parallel``). JAX's ``latent_sharding`` /
``text_sharding`` / ``replicated`` / ``shard_array`` become the explicit
:func:`frames_slice` / :func:`gather_frames` of a process mesh, and
``shard_map_compat`` has no counterpart."""

from videop2p_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FRAMES,
    AXIS_TENSOR,
    TP_COLLECTIVES,
    CommRecorder,
    Mesh,
    active_mesh,
    frames_draw,
    frames_slice,
    gather_frames,
    gather_state_dict,
    global_mean,
    make_megatron_out_dot,
    make_mesh,
    make_sharded_frame_attention_fn,
    make_sharded_group_norm_fn,
    param_shardings,
    reduce_frame_grads,
    set_active_mesh,
    shard_state_dict,
    shard_unet,
)
from videop2p_tpu_torch.parallel.distributed import (
    emit_host_phase,
    host_phase_record,
    initialize_distributed,
    make_hybrid_mesh,
    phase_skew,
)
from videop2p_tpu_torch.parallel.ring import (
    RING_VARIANTS,
    default_ring_variant,
    make_ring_temporal_fn,
    ring_attention,
    ring_attention_sharded,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_FRAMES",
    "AXIS_TENSOR",
    "TP_COLLECTIVES",
    "RING_VARIANTS",
    "default_ring_variant",
    "make_megatron_out_dot",
    "make_mesh",
    "make_sharded_frame_attention_fn",
    "make_sharded_group_norm_fn",
    "param_shardings",
    "initialize_distributed",
    "make_hybrid_mesh",
    "host_phase_record",
    "emit_host_phase",
    "phase_skew",
    "make_ring_temporal_fn",
    "ring_attention",
    "ring_attention_sharded",
    # the explicit counterparts of JAX's shardings
    "Mesh",
    "CommRecorder",
    "active_mesh",
    "set_active_mesh",
    "frames_slice",
    "frames_draw",
    "gather_frames",
    "gather_state_dict",
    "global_mean",
    "reduce_frame_grads",
    "shard_state_dict",
    "shard_unet",
]
