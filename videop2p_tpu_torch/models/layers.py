"""Base layers of the video UNet: GroupNorm with the kernel seam, pseudo-3D
convolutions, resampling, timestep embeddings and the resnet block.

Port of ``videop2p_tpu/models/layers.py``. Activations are channels-last
``(B, F, H, W, C)``; :class:`InflatedConv` folds frames into the batch and
views the tensor as NCHW for ``F.conv2d``. Parameter names follow the
diffusers/Tune-A-Video layout (``conv1.weight``, ``norm1.weight``, ...).

Every parameterized layer of the UNet computes in its input's dtype: a
weight of another dtype is cast at use (:func:`as_input_dtype`), as a flax
layer casts its ``param_dtype`` weights to its ``dtype``. So float32
weights run a bfloat16 forward when the UNet casts its input to bfloat16
(``UNet3DConditionModel.compute_dtype``, Stage-1 mixed precision), their
gradients arriving in float32 through the cast; where weight and input
share a dtype nothing is cast, and the layer is the plain torch one. A
weight quantized at load (``models/quant.py``) is dequantized there too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videop2p_tpu_torch.models.quant import QuantizedWeight
from videop2p_tpu_torch.ops.groupnorm import fused_group_norm

__all__ = [
    "as_input_dtype",
    "Linear",
    "LayerNorm",
    "get_timestep_embedding",
    "TimestepEmbedding",
    "TpuGroupNorm",
    "InflatedConv",
    "Upsample3D",
    "Downsample3D",
    "ResnetBlock3D",
]


def as_input_dtype(param, x: torch.Tensor) -> Optional[torch.Tensor]:
    """``param`` in ``x``'s dtype (itself when it already is); a quantized
    weight (``models/quant.py``) is dequantized to it."""
    if isinstance(param, QuantizedWeight):
        return param.dequantize(x.dtype)
    if param is None or param.dtype == x.dtype:
        return param
    return param.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, as_input_dtype(self.weight, x), as_input_dtype(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, as_input_dtype(self.weight, x),
                            as_input_dtype(self.bias, x), self.eps)


class TpuGroupNorm(nn.Module):
    """GroupNorm(+SiLU) whose statistics pool over every axis between the
    first (sample) and the last (channel) axis: frame-pooled on
    (B, F, H, W, C), per frame when the caller folds frames into the batch.
    Every call goes through :func:`fused_group_norm` — the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor — unless the mesh seam
    ``group_norm_fn`` is set (``parallel/mesh.py:make_sharded_group_norm_fn``,
    JAX's field of the name): it then owns the call, told whether the site
    is frame-pooled (a 5-D input) or per frame."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: str = "none"):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.group_norm_fn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[0], x.shape[-1]
        args = (x.reshape(n, -1, c).contiguous(), as_input_dtype(self.weight, x),
                as_input_dtype(self.bias, x))
        kwargs = dict(num_groups=self.num_groups, eps=self.eps, act=self.act)
        if self.group_norm_fn is not None:
            y = self.group_norm_fn(*args, pooled=x.dim() == 5, **kwargs)
        else:
            y = fused_group_norm(*args, **kwargs)
        return y.reshape(x.shape)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, *,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, (B,) → (B, embedding_dim) float32."""
    timesteps = torch.atleast_1d(timesteps)
    half = embedding_dim // 2
    exponent = -math.log(float(max_period)) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class InflatedConv(nn.Conv2d):
    """2-D convolution applied to every frame of a (B, F, H, W, C) video."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, h, w, c = x.shape
        y = self._conv_forward(x.reshape(b * f, h, w, c).permute(0, 3, 1, 2),
                               as_input_dtype(self.weight, x), as_input_dtype(self.bias, x))
        y = y.permute(0, 2, 3, 1)
        return y.reshape(b, f, *y.shape[1:])


class Upsample3D(nn.Module):
    """Nearest ×2 spatial upsample per frame, then a 3×3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return self.conv(x)


class Downsample3D(nn.Module):
    """Stride-2 3×3 conv per frame."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlock3D(nn.Module):
    """GN+SiLU → conv → (+ time embedding) → GN+SiLU → conv, with a 1×1
    shortcut when the channel count changes. Both norms pool their
    statistics over the frames (the reference's 3-D GroupNorm)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = TpuGroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = InflatedConv(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = TpuGroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = InflatedConv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (
            InflatedConv(in_channels, out_channels, 1)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, None, :]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h
