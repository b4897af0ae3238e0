"""Post-training UNet weight quantization (port of
``videop2p_tpu/models/quant.py``, Q-Diffusion-style).

A quantized layer keeps its weight as int8 (or float8-e4m3) values plus a
float32 scale per output channel (:class:`QuantizedWeight`, a submodule in
the place of the ``weight`` parameter), computed once at load
(``models/convert.py:quantize_unet_params``), and dequantizes it at use to
its input's dtype (``models/layers.py:as_input_dtype``): the card holds the
1-byte weights and every product still runs in the model's dtype.

A torch ``Linear`` and a convolution keep the output channel in axis 0
(flax keeps it last), so the scale is the absmax over every other axis; the
int8 values equal JAX's after the bridge's transpose. ``torch.round``
rounds half to even, as ``jnp.round`` does.

Modes (``QUANT_MODES``):
  * ``"off"``  — no quantization (the plain model, bit for bit).
  * ``"w8"``   — int8 weights, per-output-channel scales.
  * ``"w8a8"`` — w8 plus a dynamic per-tensor activation fake-quant at the
    Dense boundaries of ``models/attention.py`` (:func:`fake_quant_act`
    through the modules' ``act_quant_fn``, :func:`set_act_quant`).

The first and last layers stay in full precision (Q-Diffusion §4):
``conv_in``, ``conv_out`` and the time embedding — ``SKIP_MODULES``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

__all__ = [
    "QUANT_MODES",
    "SKIP_MODULES",
    "QuantizedWeight",
    "validate_quant_mode",
    "quant_weight_dtype",
    "quantize_weight",
    "fake_quant_act",
    "set_act_quant",
]

QUANT_MODES = ("off", "w8", "w8a8")

# full-precision islands: the in/out convolutions and the time MLP carry
# the widest dynamic range for the fewest parameters
SKIP_MODULES = ("conv_in", "conv_out", "time_embedding")


def validate_quant_mode(mode: Optional[str]) -> str:
    """Normalize and check a ``quant_mode`` value (None → "off")."""
    mode = "off" if mode is None else str(mode)
    if mode not in QUANT_MODES:
        raise ValueError(
            f"quant_mode={mode!r} is not one of {QUANT_MODES} — "
            "off: full precision (bit-exact); w8: int8 weights with "
            "per-output-channel scales; w8a8: w8 plus dynamic per-tensor "
            "activation fake-quant at the attention Dense boundaries")
    return mode


def quant_weight_dtype(name: str = "int8") -> torch.dtype:
    """A storage dtype by name: int8, or ``"fp8"`` / ``"float8_e4m3fn"`` for
    ``torch.float8_e4m3fn`` where this torch has it (else int8)."""
    if name in ("fp8", "float8_e4m3fn"):
        dtype = getattr(torch, "float8_e4m3fn", None)
        if dtype is not None:
            return dtype
    return torch.int8


class QuantizedWeight(nn.Module):
    """A low-precision weight: ``qvalue`` (int8 or float8-e4m3, the
    weight's shape) and a float32 ``scale`` broadcastable over it (one per
    output channel, axis 0), both buffers, so they move with the module."""

    def __init__(self, qvalue: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("qvalue", qvalue)
        self.register_buffer("scale", scale)

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.qvalue.float() * self.scale).to(dtype)


def quantize_weight(w: torch.Tensor, *, dtype: torch.dtype = torch.int8) -> QuantizedWeight:
    """One weight → :class:`QuantizedWeight` with symmetric per-output-channel
    scales (absmax over every axis but the first)."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim())), keepdim=True)
    if not dtype.is_floating_point:
        qmax = float(torch.iinfo(dtype).max)  # 127: symmetric, no -128
        scale = torch.clamp(amax, min=1e-12) / qmax
        q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(dtype)
    else:
        qmax = float(torch.finfo(dtype).max)  # 448 for e4m3
        scale = torch.clamp(amax, min=1e-12) / qmax
        q = (wf / scale).to(dtype)
    return QuantizedWeight(q, scale)


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Dynamic per-tensor symmetric int8 round trip of an activation (the
    ``w8a8`` mode's ``act_quant_fn``): quantize and dequantize in float32,
    return in the input's dtype."""
    if not x.is_floating_point():
        return x
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return (q * scale).to(x.dtype)


def set_act_quant(model: nn.Module, fn: Optional[Callable]) -> nn.Module:
    """Set ``act_quant_fn`` on every module of ``model`` that has the seam
    (the attention, feed-forward and transformer modules); None removes it."""
    for module in model.modules():
        if hasattr(module, "act_quant_fn"):
            module.act_quant_fn = fn
    return model
