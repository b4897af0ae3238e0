"""AutoencoderKL (the SD image VAE), applied per frame (port of
``videop2p_tpu/models/vae.py``).

Channels-last images (B, H, W, C); parameter names follow diffusers'
``AutoencoderKL``. The VAE's GroupNorm is the JAX package's flax
``nn.GroupNorm`` (no Pallas kernel), so here it is the plain
:func:`group_norm_reference` with the same E[x²]−E[x]² statistics.
``encode_video`` takes the posterior mean; ``decode_video`` decodes 4 frames
at a time to bound memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from videop2p_tpu_torch.ops.groupnorm import group_norm_reference

__all__ = ["VAEConfig", "AutoencoderKL", "encode_video", "decode_video"]


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls, **overrides) -> "VAEConfig":
        cfg = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4)
        cfg.update(overrides)
        return cls(**cfg)


class _GroupNorm(nn.Module):
    """flax-style GroupNorm on channels-last images, eps 1e-6."""

    def __init__(self, channels: int, groups: int, act: str = "none"):
        super().__init__()
        self.groups = groups
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        y = group_norm_reference(x.reshape(b, -1, c), self.weight, self.bias,
                                 num_groups=self.groups, eps=1e-6, act=self.act)
        return y.reshape(x.shape)


class _Conv(nn.Conv2d):
    """Conv2d on channels-last (B, H, W, C) images."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = _GroupNorm(in_ch, groups, act="silu")
        self.conv1 = _Conv(in_ch, out_ch, 3, padding=1)
        self.norm2 = _GroupNorm(out_ch, groups, act="silu")
        self.conv2 = _Conv(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = _Conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class _AttnBlock(nn.Module):
    """Single-head spatial self-attention of the mid block."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = _GroupNorm(ch, groups)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        sim = torch.matmul(q, k.transpose(1, 2)) * (c ** -0.5)
        probs = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        out = self.to_out[0](torch.matmul(probs, v))
        return x + out.reshape(b, h, w, c)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_ResnetBlock(ch, ch, groups),
                                      _ResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([_AttnBlock(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Sampler(nn.Module):
    """Holds the ``conv`` of a down/upsampler (diffusers' name nesting)."""

    def __init__(self, ch: int, stride: int):
        super().__init__()
        self.conv = _Conv(ch, ch, 3, stride=stride, padding=0 if stride == 2 else 1)


class _Level(nn.Module):
    def __init__(self, resnets, sampler_stride: int = 0, ch: int = 0):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        name = "downsamplers" if sampler_stride == 2 else "upsamplers"
        if sampler_stride:
            setattr(self, name, nn.ModuleList([_Sampler(ch, sampler_stride)]))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels
        self.conv_in = _Conv(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = ch[0]
        for i, c in enumerate(ch):
            resnets = [_ResnetBlock(in_ch if j == 0 else c, c, g)
                       for j in range(cfg.layers_per_block)]
            self.down_blocks.append(
                _Level(resnets, 2 if i < len(ch) - 1 else 0, c))
            in_ch = c
        self.mid_block = _Mid(ch[-1], g)
        self.conv_norm_out = _GroupNorm(ch[-1], g, act="silu")
        self.conv_out = _Conv(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for level in self.down_blocks:
            for resnet in level.resnets:
                x = resnet(x)
            if hasattr(level, "downsamplers"):
                # diffusers pads (0, 1) on both spatial axes before the
                # unpadded stride-2 conv
                x = F.pad(x, (0, 0, 0, 1, 0, 1))
                x = level.downsamplers[0].conv(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = _Conv(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        in_ch = rev[0]
        for i, c in enumerate(rev):
            resnets = [_ResnetBlock(in_ch if j == 0 else c, c, g)
                       for j in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(_Level(resnets, 1 if i < len(rev) - 1 else 0, c))
            in_ch = c
        self.conv_norm_out = _GroupNorm(rev[-1], g, act="silu")
        self.conv_out = _Conv(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            for resnet in level.resnets:
                x = resnet(x)
            if hasattr(level, "upsamplers"):
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = level.upsamplers[0].conv(x)
        return self.conv_out(self.conv_norm_out(x))


class AutoencoderKL(nn.Module):
    """encode → (mean, logvar); decode(z) → image. Latent scaling is the
    caller's (× scaling_factor after encode, ÷ before decode)."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = _Conv(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = _Conv(config.latent_channels, config.latent_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.quant_conv.weight.dtype

    def encode(self, x: torch.Tensor):
        moments = self.quant_conv(self.encoder(x))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def encode_video(vae: AutoencoderKL, video: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, F, H, W, 3) in [-1, 1] → scaled latents (B, F, H/8, W/8, 4): at
    the posterior mean (inversion fidelity), or with a ``generator`` a draw
    from the posterior (Stage-1 training, JAX's ``sample=True``)."""
    b, f = video.shape[:2]
    mean, logvar = vae.encode(video.reshape(b * f, *video.shape[2:]).to(vae.dtype))
    z = mean
    if generator is not None:
        z = mean + torch.exp(0.5 * logvar) * torch.randn(
            mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    z = z * vae.config.scaling_factor
    return z.reshape(b, f, *z.shape[1:])


def decode_video(vae: AutoencoderKL, latents: torch.Tensor, *,
                 chunk: int = 4) -> torch.Tensor:
    """Scaled latents (B, F, h, w, 4) → video (B, F, 8h, 8w, 3) in [-1, 1],
    ``chunk`` frames at a time."""
    b, f = latents.shape[:2]
    z = latents.reshape(b * f, *latents.shape[2:]).to(vae.dtype) / vae.config.scaling_factor
    img = torch.cat([vae.decode(z[i:i + chunk]) for i in range(0, z.shape[0], chunk)])
    return img.reshape(b, f, *img.shape[1:])
