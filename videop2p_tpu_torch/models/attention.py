"""Video transformer block: frame (spatial), text-cross and temporal attention.

Port of ``videop2p_tpu/models/attention.py``:

  * ``attn1`` is :class:`FrameAttention` — every frame's queries against the
    keys/values of frame 0 only, through the frame-attention dispatch
    (the CUDA kernel at N ≥ 1024 tokens on the card); not a controlled site.
  * ``attn2`` is text cross-attention and ``attn_temp`` temporal attention
    over the frame axis — the controlled sites, whose probabilities are
    materialized and passed through ``control_attention``.

The flax ``sow("attn_store", ...)`` becomes an explicit ``store`` dict the
caller passes down: each controlled site with at most 1024 queries writes
its pre-edit head-mean probabilities under its module path. In capture mode
(the inversion of the cached-source edit) every controlled site also writes
its full per-head pre-edit probabilities, in bf16, into the nested dict
``store["attn_base"]`` under the same module path (the flax ``attn_base``
collection). In cached-source mode a site reads the source stream's maps
for this step from ``AttnControl.cached_base``.

Each attention, feed-forward and transformer module has an
``act_quant_fn`` seam (None; ``models/quant.py:set_act_quant``): the ``w8a8``
quant mode's activation fake-quant at every Dense input, where JAX's
``_aq`` applies it.

The mesh seams (None: the single-device code, bit for bit; set by
``UNet3DConditionModel.set_seams`` from ``parallel/mesh.py``), JAX's flax
fields of the same names: ``FrameAttention.frame_attention_fn`` (the
frame-0 K/V broadcast over ``frames``), ``ControlledAttention.attention_fn``
(the ring on the uncontrolled temporal sites), ``kv_gather_fn`` (the
controlled temporal sites' K/V over every frame), ``head_mean_fn`` (the
store's head-mean over the heads of every tensor rank), and under tensor
parallelism ``tp_copy_fn`` (the column-parallel entry) and
``row_parallel_dot`` (the row-parallel ``to_out`` / ``proj_out`` and its
reduction). Under tensor parallelism ``heads`` counts this rank's heads and
``tp_size`` the ranks they are split over.

Batch layout matches the JAX package so the control layer can factor the
batch: frames fold batch-major ``(B, F, …) → (B·F, …)`` at the cross site,
spatial positions fold batch-major ``(B·N, F, C)`` at the temporal site.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from videop2p_tpu_torch.control.controllers import ControlContext, control_attention
from videop2p_tpu_torch.models.layers import LayerNorm, Linear, TpuGroupNorm, as_input_dtype
from videop2p_tpu_torch.ops.attention import make_frame_attention_fn

__all__ = [
    "AttnControl",
    "FrameAttention",
    "ControlledAttention",
    "FeedForward",
    "BasicTransformerBlock",
    "Transformer3DModel",
    "STORE_MAX_QUERIES",
    "BASE_STORE",
]

# controlled sites store their head-mean maps when Q ≤ this (32²)
STORE_MAX_QUERIES = 1024
# the store entry that capture mode fills: {module path: (B, H, Q, K) bf16}
BASE_STORE = "attn_base"
# flax nn.LayerNorm's default epsilon, which the JAX blocks use
_LN_EPS = 1e-6


@dataclass
class AttnControl:
    """The edit context plus the step index of the sampling loop.
    ``num_uncond`` counts the uncond streams ahead of the ``ctx.num_prompts``
    cond streams in the batch (-1 → ``ctx.num_prompts``).

    ``capture``: every controlled site writes its full per-head pre-edit
    probabilities into ``store[BASE_STORE]`` (the inversion pass of the
    cached-source edit). ``cached_base``: {module path: map} giving the
    source stream's maps for this step; the batch then holds only the P − 1
    edit streams, and a site absent from it (an empty capture window, whose
    gate is closed at every step) passes through unedited. ``cached_source``
    marks that layout even when both windows are empty and ``cached_base``
    is None."""

    ctx: Optional[ControlContext]
    step_index: int
    num_uncond: int = -1
    capture: bool = False
    cached_base: Optional[Dict[str, torch.Tensor]] = None
    cached_source: bool = False

    def base_map_for(self, path: str) -> Optional[torch.Tensor]:
        """This site's cached source map, by module path."""
        if self.cached_base is None:
            return None
        return self.cached_base.get(path)


def _aq(fn, x: torch.Tensor) -> torch.Tensor:
    """The activation fake-quant seam (``w8a8``, ``models/quant.py``) on a
    Dense input: ``x`` itself when no seam is set."""
    return x if fn is None else fn(x)


def _out_proj(module: nn.Module, linear: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The output projection ``linear`` of ``module``, or its row-parallel
    form through the module's ``row_parallel_dot`` seam."""
    x = _aq(module.act_quant_fn, x)
    if module.row_parallel_dot is None:
        return linear(x)
    return module.row_parallel_dot(x, linear.weight, linear.bias)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H·D) → (B, H, N, D) view."""
    b, n, _ = x.shape
    return x.reshape(b, n, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) → (B, N, H·D)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class FrameAttention(nn.Module):
    """Spatial self-attention with frame-0 keys/values. Input (B, F, N, C)."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 frame_attention: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.attention_fn = make_frame_attention_fn(frame_attention)
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.act_quant_fn = None
        self.frame_attention_fn = None
        self.tp_copy_fn = None
        self.row_parallel_dot = None
        self.tp_size = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, n, _ = x.shape
        inner = self.heads * self.dim_head
        x = _aq(self.act_quant_fn, x)
        if self.tp_copy_fn is not None:
            x = self.tp_copy_fn(x)
        q = self.to_q(x).reshape(b, f, n, self.heads, self.dim_head).transpose(2, 3)
        kv_src = x[:, 0]
        k = _split_heads(self.to_k(kv_src), self.heads)
        v = _split_heads(self.to_v(kv_src), self.heads)
        attention = self.frame_attention_fn or self.attention_fn
        out = attention(q, k, v)  # (B, F, H, N, D)
        out = out.transpose(2, 3).reshape(b, f, n, inner)
        return _out_proj(self, self.to_out[0], out)


class ControlledAttention(nn.Module):
    """Multi-head attention with materialized, editable probabilities.
    ``site`` is ``"cross"`` or ``"temporal"``; ``path`` is the module path the
    store keys its maps by (set by the owning UNet)."""

    def __init__(self, dim: int, heads: int, dim_head: int, site: str,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.site = site
        self.path = site
        ctx_dim = dim if context_dim is None else context_dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(ctx_dim, inner, bias=False)
        self.to_v = Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])
        self.act_quant_fn = None
        self.attention_fn = None
        self.kv_gather_fn = None
        self.head_mean_fn = None
        self.tp_copy_fn = None
        self.row_parallel_dot = None
        self.tp_size = 1

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                control: Optional[AttnControl] = None,
                video_length: Optional[int] = None,
                store: Optional[dict] = None) -> torch.Tensor:
        x = _aq(self.act_quant_fn, x)
        ctx_in = x if context is None else _aq(self.act_quant_fn, context)
        if self.tp_copy_fn is not None:
            x = self.tp_copy_fn(x)
            ctx_in = x if context is None else self.tp_copy_fn(ctx_in)
        q = _split_heads(self.to_q(x), self.heads)
        k = _split_heads(self.to_k(ctx_in), self.heads)
        v = _split_heads(self.to_v(ctx_in), self.heads)
        if self.attention_fn is not None and control is None:
            # the sequence-parallel kernel (the ring) of an uncontrolled pass
            return _out_proj(self, self.to_out[0], _merge_heads(self.attention_fn(q, k, v)))
        frame_shards = 1
        if self.kv_gather_fn is not None:
            # a controlled temporal site over split frames: this rank's
            # query rows against the K/V of every frame
            local = k.shape[-2]
            k, v = self.kv_gather_fn(k, v)
            video_length = k.shape[-2]
            frame_shards = video_length // local
        sim = torch.matmul(q, k.transpose(-1, -2)) * (self.dim_head ** -0.5)
        probs = torch.softmax(sim.float(), dim=-1).to(q.dtype)
        if store is not None and probs.shape[-2] <= STORE_MAX_QUERIES:
            store[self.path] = (probs.mean(dim=1) if self.head_mean_fn is None
                                else self.head_mean_fn(probs))
        if control is not None and control.capture:
            if store is None:
                raise ValueError("capture mode needs a store")
            # bf16 whatever the compute dtype, as the JAX package stores
            # them: it halves an fp32 capture (~3.3 GB at SD-1.5, 8 frames)
            store.setdefault(BASE_STORE, {})[self.path] = probs.to(torch.bfloat16)
        if control is not None:
            if video_length is None:
                if self.site != "temporal":
                    raise ValueError(
                        "video_length is required at controlled cross sites")
                video_length = x.shape[1]
            base_map = control.base_map_for(self.path)
            # a cached-source batch at a site with no captured map: its gate
            # is closed at every step, so the unedited maps are exact (and
            # the live layout would mis-factor the P − 1-stream batch)
            if not (control.cached_source and base_map is None):
                probs = control_attention(
                    probs, control.ctx, is_cross=self.site == "cross",
                    step_index=control.step_index, video_length=video_length,
                    num_uncond=control.num_uncond, base_map=base_map,
                    frame_shards=frame_shards)
        out = torch.matmul(probs, v)
        return _out_proj(self, self.to_out[0], _merge_heads(out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    """GEGLU feed-forward; ``net.0.proj`` / ``net.2`` as in diffusers."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])
        self.act_quant_fn = None
        self.tp_copy_fn = None
        self.row_parallel_dot = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _aq(self.act_quant_fn, x)
        if self.tp_copy_fn is not None:
            x = self.tp_copy_fn(x)
        h = self.net[0](x)
        return _out_proj(self, self.net[2], self.net[1](h))


class BasicTransformerBlock(nn.Module):
    """frame-attn → text-cross-attn → FF → temporal-attn, pre-LayerNorm with
    residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 frame_attention: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=_LN_EPS)
        self.attn1 = FrameAttention(dim, heads, dim_head, frame_attention)
        self.norm2 = LayerNorm(dim, eps=_LN_EPS)
        self.attn2 = ControlledAttention(dim, heads, dim_head, "cross", context_dim)
        self.norm3 = LayerNorm(dim, eps=_LN_EPS)
        self.ff = FeedForward(dim)
        self.norm_temp = LayerNorm(dim, eps=_LN_EPS)
        self.attn_temp = ControlledAttention(dim, heads, dim_head, "temporal")

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                control: Optional[AttnControl] = None,
                store: Optional[dict] = None) -> torch.Tensor:
        b, f, n, c = x.shape
        x = x + self.attn1(self.norm1(x))
        if context is not None:
            h = self.norm2(x).reshape(b * f, n, c)
            if context.dim() == 3:
                ctx_flat = context.repeat_interleave(f, dim=0)
            else:
                ctx_flat = context.reshape(b * f, *context.shape[2:])
            attn2 = self.attn2(h, context=ctx_flat, control=control,
                               video_length=f, store=store)
            x = x + attn2.reshape(b, f, n, c)
        x = x + self.ff(self.norm3(x))
        h = self.norm_temp(x).transpose(1, 2).reshape(b * n, f, c)
        attn_temp = self.attn_temp(h, control=control, video_length=f, store=store)
        return x + attn_temp.reshape(b, n, f, c).transpose(1, 2)


class Conv1x1(nn.Module):
    """A 1×1 convolution kept with its 4-D ``(out, in, 1, 1)`` weight (the
    checkpoint layout of ``proj_in``/``proj_out``), applied to channels-last
    activations as a linear map."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, as_input_dtype(self.weight, x)[:, :, 0, 0],
                        as_input_dtype(self.bias, x))


class Transformer3DModel(nn.Module):
    """GroupNorm (per frame, eps 1e-6) → proj_in → transformer blocks →
    proj_out, with a residual. Input (B, F, H, W, C)."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1, norm_groups: int = 32, frame_attention: str = "auto"):
        super().__init__()
        inner = heads * dim_head
        self.norm = TpuGroupNorm(channels, norm_groups, eps=1e-6)
        self.proj_in = Conv1x1(channels, inner)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, frame_attention)
            for _ in range(depth)])
        self.proj_out = Conv1x1(inner, channels)
        self.act_quant_fn = None

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                control: Optional[AttnControl] = None,
                store: Optional[dict] = None) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        # frames fold into the batch BEFORE the norm: statistics per frame
        h = self.norm(x.reshape(b * f, hh, ww, c)).reshape(b, f, hh, ww, c)
        h = self.proj_in(_aq(self.act_quant_fn, h))
        inner = h.shape[-1]
        h = h.reshape(b, f, hh * ww, inner)
        for block in self.transformer_blocks:
            h = block(h, context=context, control=control, store=store)
        h = self.proj_out(_aq(self.act_quant_fn, h.reshape(b, f, hh, ww, inner)))
        return h + x
