"""The 3-D (video) conditional UNet (port of ``videop2p_tpu/models/unet.py``).

The inflated Stable-Diffusion 1.x denoiser over channels-last
(B, F, H, W, C) latents: cross-attention down blocks and a plain down block,
a cross-attention mid block, and the mirrored up path, driven by
:class:`UNet3DConfig`. Parameter names are the diffusers/Tune-A-Video ones,
so a state dict from ``models/convert.py`` loads with ``strict=True``.

``forward(deep_mode=...)`` is the cross-step deep-feature reuse seam
(``pipelines/reuse.py``; JAX: ``unet.py:193-226``): ``"capture"`` also
returns the deep feature, the input of the final up block; ``"shallow"``
runs conv_in, the first down block (without its downsampler), the final up
block seeded with a given ``deep_feature`` and the output convolutions.

``UNet3DConfig.gradient_checkpointing`` recomputes each down, mid and up
block in the backward instead of keeping its activations (the blocks the
JAX package wraps in ``nn.remat``); its ``remat_policy`` names what a
checkpointed block keeps, by JAX's ``jax.checkpoint_policies`` names
(:data:`REMAT_POLICIES`: the outputs of the matrix products, through
``torch.utils.checkpoint``'s selective checkpointing, or everything);
``compute_dtype`` runs the forward in another dtype than the weights'
(Stage-1 mixed precision: float32 weights, bfloat16 compute).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from videop2p_tpu_torch.models.attention import AttnControl, ControlledAttention
from videop2p_tpu_torch.models.layers import (
    InflatedConv,
    TimestepEmbedding,
    TpuGroupNorm,
    get_timestep_embedding,
)
from videop2p_tpu_torch.models import unet_blocks

__all__ = ["UNet3DConfig", "UNet3DConditionModel", "REMAT_POLICIES"]

# remat_policy: JAX's jax.checkpoint_policies names → the aten ops whose
# outputs a checkpointed block keeps for the backward (() recomputes the
# whole block; None keeps everything, no recompute). JAX's dots are
# dot_generals: mm / addmm (the linear layers) have no batch dimensions,
# bmm (attention's products) has one; convolutions are not dots.
_DOTS = ("mm", "addmm", "bmm")
_DOTS_NO_BATCH = ("mm", "addmm")
REMAT_POLICIES = {
    None: (),
    "nothing_saveable": (),
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
    "everything_saveable": None,
}


def _per_block(value: Union[int, Tuple[int, ...]], num_blocks: int) -> Tuple[int, ...]:
    if isinstance(value, int):
        return (value,) * num_blocks
    if len(value) != num_blocks:
        raise ValueError(f"per-block value {value} does not match {num_blocks} blocks")
    return tuple(value)


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """Static architecture config; the defaults are the SD-1.x shape."""

    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock3D", "CrossAttnDownBlock3D", "CrossAttnDownBlock3D",
        "DownBlock3D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock3D", "CrossAttnUpBlock3D", "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D")
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    attention_head_dim: Union[int, Tuple[int, ...]] = 8  # = number of heads
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # the frame-attention implementation (ops/attention.py
    # make_frame_attention_fn): "auto"/"fused", "flash", "flash_rect",
    # "chunked" or "dense"
    frame_attention: str = "auto"
    # recompute each down/mid/up block in the backward (JAX: nn.remat)
    gradient_checkpointing: bool = False
    # what a checkpointed block keeps, by jax.checkpoint_policies name
    # (REMAT_POLICIES; None: the whole block is recomputed)
    remat_policy: Optional[str] = None

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            names = ", ".join(repr(k) for k in REMAT_POLICIES)
            raise NotImplementedError(
                f"remat_policy {self.remat_policy!r} is not mapped; the port takes "
                f"{names} (JAX's other jax.checkpoint_policies entries are mostly "
                "policy factories, not policies)")

    @classmethod
    def sd15(cls, **overrides) -> "UNet3DConfig":
        return cls(**overrides)

    @classmethod
    def sdxl(cls, **overrides) -> "UNet3DConfig":
        """The SDXL-shaped config (JAX's ``UNet3DConfig.sdxl``): 3 levels,
        deep upper transformer stacks (depth 2 and 10), 64-wide heads, a
        2048-wide text context, 128² latents (1024² pixels). The first level
        has no attention (SDXL's DownBlock2D), so its depth entry is unused.
        SDXL's added embeddings (text_embeds / time_ids) are left out: the
        case is the per-block topology."""
        cfg = dict(
            sample_size=128,
            down_block_types=("DownBlock3D", "CrossAttnDownBlock3D",
                              "CrossAttnDownBlock3D"),
            up_block_types=("CrossAttnUpBlock3D", "CrossAttnUpBlock3D", "UpBlock3D"),
            block_out_channels=(320, 640, 1280),
            layers_per_block=2,
            transformer_depth=(1, 2, 10),
            attention_head_dim=(5, 10, 20),  # 64-wide heads at each level
            cross_attention_dim=2048,
        )
        cfg.update(overrides)
        return cls(**cfg)

    @classmethod
    def tiny(cls, **overrides) -> "UNet3DConfig":
        """Miniature config for tests: two levels, 8-wide, 2 heads."""
        cfg = dict(
            sample_size=8,
            down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
            up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
            block_out_channels=(8, 16),
            layers_per_block=1,
            attention_head_dim=2,
            cross_attention_dim=16,
            norm_num_groups=4,
        )
        cfg.update(overrides)
        return cls(**cfg)


class UNet3DConditionModel(nn.Module):
    """ε_θ(x_t, t, text): ``forward(sample (B, F, H, W, C), timesteps () or
    (B,), encoder_hidden_states (B, L, D), control=None, store=None)``.

    ``control`` threads the P2P edit into every cross/temporal site; a
    ``store`` dict collects the head-mean maps of the controlled sites with
    at most 32² queries, keyed by module path. ``compute_dtype`` (None: the
    weights' dtype) is the dtype the forward runs in."""

    def __init__(self, config: UNet3DConfig):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype: Optional[torch.dtype] = None
        n_blocks = len(cfg.block_out_channels)
        depths = _per_block(cfg.transformer_depth, n_blocks)
        heads = _per_block(cfg.attention_head_dim, n_blocks)
        ch = cfg.block_out_channels
        temb_ch = ch[0] * 4
        groups = cfg.norm_num_groups
        ctx_dim = cfg.cross_attention_dim

        self.time_embedding = TimestepEmbedding(ch[0], temb_ch)
        self.conv_in = InflatedConv(cfg.in_channels, ch[0], 3, padding=1)

        res_channels = [ch[0]]
        self.down_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, block_type in enumerate(cfg.down_block_types):
            final = i == n_blocks - 1
            if block_type == "CrossAttnDownBlock3D":
                block = unet_blocks.CrossAttnDownBlock3D(
                    in_ch, ch[i], temb_ch, num_layers=cfg.layers_per_block,
                    attn_heads=heads[i], context_dim=ctx_dim,
                    transformer_depth=depths[i], add_downsample=not final,
                    norm_groups=groups, frame_attention=cfg.frame_attention)
            elif block_type == "DownBlock3D":
                block = unet_blocks.DownBlock3D(
                    in_ch, ch[i], temb_ch, num_layers=cfg.layers_per_block,
                    add_downsample=not final, norm_groups=groups)
            else:
                raise ValueError(f"unknown down block type: {block_type!r}")
            self.down_blocks.append(block)
            res_channels += [ch[i]] * (cfg.layers_per_block + (0 if final else 1))
            in_ch = ch[i]

        self.mid_block = unet_blocks.UNetMidBlock3DCrossAttn(
            ch[-1], temb_ch, attn_heads=heads[-1], context_dim=ctx_dim,
            transformer_depth=depths[-1], norm_groups=groups,
            frame_attention=cfg.frame_attention)

        rev_ch = tuple(reversed(ch))
        rev_heads = tuple(reversed(heads))
        rev_depths = tuple(reversed(depths))
        self.up_blocks = nn.ModuleList()
        in_ch = ch[-1]
        num_layers = cfg.layers_per_block + 1
        for i, block_type in enumerate(cfg.up_block_types):
            skips = res_channels[-num_layers:][::-1]
            del res_channels[-num_layers:]
            final = i == n_blocks - 1
            if block_type == "CrossAttnUpBlock3D":
                block = unet_blocks.CrossAttnUpBlock3D(
                    in_ch, rev_ch[i], temb_ch, skip_channels=skips,
                    attn_heads=rev_heads[i], context_dim=ctx_dim,
                    transformer_depth=rev_depths[i], add_upsample=not final,
                    norm_groups=groups, frame_attention=cfg.frame_attention)
            elif block_type == "UpBlock3D":
                block = unet_blocks.UpBlock3D(
                    in_ch, rev_ch[i], temb_ch, skip_channels=skips,
                    add_upsample=not final, norm_groups=groups)
            else:
                raise ValueError(f"unknown up block type: {block_type!r}")
            self.up_blocks.append(block)
            in_ch = rev_ch[i]

        self.conv_norm_out = TpuGroupNorm(ch[0], groups, eps=1e-5, act="silu")
        self.conv_out = InflatedConv(ch[0], cfg.out_channels, 3, padding=1)

        for name, module in self.named_modules():
            if isinstance(module, ControlledAttention):
                module.path = name

    def set_seams(self, *, frame_attention_fn=None, temporal_attention_fn=None,
                  kv_gather_fn=None, group_norm_fn=None, row_parallel_dot=None,
                  temporal_row_parallel_dot=None, tp_copy_fn=None,
                  head_mean_fn=None) -> "UNet3DConditionModel":
        """Thread the mesh seams into every site (JAX's ``unet.clone(...)``
        of its flax fields; ``parallel/mesh.py`` builds them): the frame
        attention of every ``attn1``, the ring of the temporal sites'
        uncontrolled passes and their controlled K/V gather, the GroupNorm
        of every norm, and under tensor parallelism the column-parallel
        entry, the head-mean of the stored maps and the row-parallel output
        of the spatial sites (``row_parallel_dot``: ``attn1``, ``attn2``, the
        feed-forward) and of the temporal ones
        (``temporal_row_parallel_dot``: the frames are its tokens, so it
        all-reduces whatever ``tp_collectives`` says, as JAX leaves that site
        declarative). None everywhere is the single-device model."""
        from videop2p_tpu_torch.models.attention import FeedForward, FrameAttention

        for module in self.modules():
            if isinstance(module, FrameAttention):
                module.frame_attention_fn = frame_attention_fn
                module.tp_copy_fn = tp_copy_fn
                module.row_parallel_dot = row_parallel_dot
            elif isinstance(module, ControlledAttention):
                temporal = module.site == "temporal"
                module.attention_fn = temporal_attention_fn if temporal else None
                module.kv_gather_fn = kv_gather_fn if temporal else None
                module.head_mean_fn = head_mean_fn
                module.tp_copy_fn = tp_copy_fn
                module.row_parallel_dot = (temporal_row_parallel_dot if temporal
                                           else row_parallel_dot)
            elif isinstance(module, FeedForward):
                module.tp_copy_fn = tp_copy_fn
                module.row_parallel_dot = row_parallel_dot
            elif isinstance(module, TpuGroupNorm):
                module.group_norm_fn = group_norm_fn
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: ``compute_dtype``, else the weights'."""
        return self.compute_dtype or self.conv_in.weight.dtype

    def _block(self, block: nn.Module, *args):
        """``block(*args)``, recomputed in the backward under
        ``gradient_checkpointing``, keeping what ``remat_policy`` saves."""
        saved = REMAT_POLICIES[self.config.remat_policy]
        # "everything_saveable" (saved None) is gradient_checkpointing=False
        if saved is None or not (self.config.gradient_checkpointing
                                 and torch.is_grad_enabled()):
            return block(*args)
        if not saved:
            return checkpoint(block, *args, use_reentrant=False)
        ops = [getattr(torch.ops.aten, name).default for name in saved]
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       ops))

    def forward(self, sample: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                control: Optional[AttnControl] = None,
                store: Optional[dict] = None, deep_mode: str = "full",
                deep_feature: Optional[torch.Tensor] = None):
        """ε, or ``(ε, deep feature)`` under ``deep_mode="capture"``;
        ``"shallow"`` skips the deep stages and starts the final up block
        from ``deep_feature`` (a capture of an earlier step)."""
        cfg = self.config
        n_blocks = len(cfg.block_out_channels)
        if deep_mode not in ("full", "capture", "shallow"):
            raise ValueError(
                f"deep_mode={deep_mode!r} is not 'full', 'capture' or 'shallow'")
        if deep_mode != "full" and n_blocks < 2:
            raise ValueError("deep-feature reuse needs >= 2 resolution levels; this "
                             f"config has {n_blocks}")
        if deep_mode == "shallow" and deep_feature is None:
            raise ValueError("deep_mode='shallow' requires deep_feature")
        shallow = deep_mode == "shallow"
        dtype = self.dtype
        sample = sample.to(dtype)
        context = encoder_hidden_states.to(dtype)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = get_timestep_embedding(
            timesteps, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(dtype)
        temb = self.time_embedding(temb)

        x = self.conv_in(sample)
        res_stack = [x]
        if shallow:
            # the first down block without its downsampler: its output feeds
            # only the deep stages a shallow step skips
            block = self.down_blocks[0]
            if isinstance(block, unet_blocks.CrossAttnDownBlock3D):
                _, res = block(x, temb, context, control, store, downsample=False)
            else:
                _, res = block(x, temb, downsample=False)
            res_stack.extend(res)
            x = deep_feature.to(dtype)
        else:
            for block in self.down_blocks:
                if isinstance(block, unet_blocks.CrossAttnDownBlock3D):
                    x, res = self._block(block, x, temb, context, control, store)
                else:
                    x, res = self._block(block, x, temb)
                res_stack.extend(res)
            x = self._block(self.mid_block, x, temb, context, control, store)

        num_layers = cfg.layers_per_block + 1
        deep = None
        up_blocks = self.up_blocks[-1:] if shallow else self.up_blocks
        for block in up_blocks:
            res = res_stack[-num_layers:]
            del res_stack[-num_layers:]
            if deep_mode == "capture" and block is self.up_blocks[-1]:
                deep = x
            if isinstance(block, unet_blocks.CrossAttnUpBlock3D):
                x = self._block(block, x, res, temb, context, control, store)
            else:
                x = self._block(block, x, res, temb)

        out = self.conv_out(self.conv_norm_out(x))
        return (out, deep) if deep_mode == "capture" else out
