"""Macro-blocks of the video UNet (port of
``videop2p_tpu/models/unet_blocks.py``). Down blocks return their per-layer
outputs for the skip connections; up blocks consume them by channel concat."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from videop2p_tpu_torch.models.attention import AttnControl, Transformer3DModel
from videop2p_tpu_torch.models.layers import Downsample3D, ResnetBlock3D, Upsample3D

__all__ = [
    "CrossAttnDownBlock3D",
    "DownBlock3D",
    "UNetMidBlock3DCrossAttn",
    "CrossAttnUpBlock3D",
    "UpBlock3D",
]


class CrossAttnDownBlock3D(nn.Module):
    """[Resnet → Transformer3D] × layers, then an optional downsample."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, *,
                 num_layers: int, attn_heads: int, context_dim: int,
                 transformer_depth: int = 1, add_downsample: bool = True,
                 norm_groups: int = 32, frame_attention: str = "auto"):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels,
                          temb_channels, norm_groups)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(out_channels, attn_heads, out_channels // attn_heads,
                               context_dim, transformer_depth, norm_groups,
                               frame_attention)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, control: Optional[AttnControl] = None,
                store: Optional[dict] = None, downsample: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``downsample=False`` skips the downsampler (the UNet's shallow
        deep-feature reuse step, which never descends)."""
        outputs = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, temb)
            x = attn(x, context=context, control=control, store=store)
            outputs.append(x)
        if self.downsamplers is not None and downsample:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class DownBlock3D(nn.Module):
    """Resnet-only down block."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, *,
                 num_layers: int, add_downsample: bool = True, norm_groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(in_channels if i == 0 else out_channels, out_channels,
                          temb_channels, norm_groups)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample3D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, downsample: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        outputs = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            outputs.append(x)
        if self.downsamplers is not None and downsample:
            x = self.downsamplers[0](x)
            outputs.append(x)
        return x, outputs


class UNetMidBlock3DCrossAttn(nn.Module):
    """Resnet → [Transformer3D → Resnet] × layers."""

    def __init__(self, channels: int, temb_channels: int, *, attn_heads: int,
                 context_dim: int, num_layers: int = 1, transformer_depth: int = 1,
                 norm_groups: int = 32, frame_attention: str = "auto"):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D(channels, channels, temb_channels, norm_groups)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(channels, attn_heads, channels // attn_heads,
                               context_dim, transformer_depth, norm_groups,
                               frame_attention)
            for _ in range(num_layers)])

    def forward(self, x, temb, context, control: Optional[AttnControl] = None,
                store: Optional[dict] = None) -> torch.Tensor:
        x = self.resnets[0](x, temb)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = attn(x, context=context, control=control, store=store)
            x = resnet(x, temb)
        return x


class CrossAttnUpBlock3D(nn.Module):
    """[skip-concat → Resnet → Transformer3D] × layers, then an optional
    upsample. ``skip_channels`` lists the channels of the skips this block
    consumes, in consumption order."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, *,
                 skip_channels: Sequence[int], attn_heads: int, context_dim: int,
                 transformer_depth: int = 1, add_upsample: bool = True,
                 norm_groups: int = 32, frame_attention: str = "auto"):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D((in_channels if i == 0 else out_channels) + skip,
                          out_channels, temb_channels, norm_groups)
            for i, skip in enumerate(skip_channels)])
        self.attentions = nn.ModuleList([
            Transformer3DModel(out_channels, attn_heads, out_channels // attn_heads,
                               context_dim, transformer_depth, norm_groups,
                               frame_attention)
            for _ in skip_channels])
        self.upsamplers = (nn.ModuleList([Upsample3D(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb, context,
                control: Optional[AttnControl] = None,
                store: Optional[dict] = None) -> torch.Tensor:
        for i, (resnet, attn) in enumerate(zip(self.resnets, self.attentions)):
            x = torch.cat([x, res_samples[-(i + 1)]], dim=-1)
            x = resnet(x, temb)
            x = attn(x, context=context, control=control, store=store)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock3D(nn.Module):
    """Resnet-only up block."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int, *,
                 skip_channels: Sequence[int], add_upsample: bool = True,
                 norm_groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock3D((in_channels if i == 0 else out_channels) + skip,
                          out_channels, temb_channels, norm_groups)
            for i, skip in enumerate(skip_channels)])
        self.upsamplers = (nn.ModuleList([Upsample3D(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, temb) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, res_samples[-(i + 1)]], dim=-1)
            x = resnet(x, temb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
