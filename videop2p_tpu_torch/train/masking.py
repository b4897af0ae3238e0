"""Trainable-parameter selection by module-path patterns (port of
``videop2p_tpu/train/masking.py``).

Stage 1 freezes the UNet and trains the parameters matching one of
``trainable_modules``, by default the query projections of the frame and
text attentions and the whole temporal attention. The rule is JAX's: a
parameter trains when a pattern's dot-tokens appear consecutively in its
flax parameter path (``down_blocks_0``, ``blocks_0``, ``attn1``, ``to_q``,
``kernel``, ...). The port reads each parameter's flax path off the weight
bridge's inverse name map (``models/convert.py:unet_jax_paths``), so a
pattern selects the same set in both packages. :func:`partition_params`
splits ``named_parameters()`` by that rule and sets ``requires_grad`` to
match, so the backward computes and stores no gradient for the frozen ~90 %
and the optimizer keeps no state for it (JAX's partition of the parameter
tree saves the same memory).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from videop2p_tpu_torch.models.convert import unet_jax_paths

__all__ = ["DEFAULT_TRAINABLE", "trainable_mask", "partition_params", "merge_params",
           "count_params"]

DEFAULT_TRAINABLE = ("attn1.to_q", "attn2.to_q", "attn_temp")


def _matches(tokens: Sequence[str], pattern: str) -> bool:
    """True when the pattern's dot-tokens appear consecutively in
    ``tokens`` (JAX's ``_matches``)."""
    pat = pattern.split(".")
    n, m = len(tokens), len(pat)
    return any(list(tokens[i:i + m]) == pat for i in range(n - m + 1))


def trainable_mask(module: nn.Module,
                   patterns: Sequence[str] = DEFAULT_TRAINABLE) -> Dict[str, bool]:
    """{parameter name: True where it trains}: a parameter trains when one
    of ``patterns`` matches its flax path (:func:`_matches`)."""
    paths = unet_jax_paths(module)
    return {name: any(_matches(paths[name], p) for p in patterns)
            for name, _ in module.named_parameters()}


def partition_params(module: nn.Module, patterns: Sequence[str] = DEFAULT_TRAINABLE
                     ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """``(trainable, frozen)``: the module's own parameters by name, split by
    :func:`trainable_mask`, with ``requires_grad`` True on the trainable and
    False on the frozen ones."""
    mask = trainable_mask(module, patterns)
    trainable, frozen = {}, {}
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
        (trainable if mask[name] else frozen)[name] = p
    return trainable, frozen


def merge_params(trainable: Mapping[str, torch.Tensor],
                 frozen: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`partition_params`: one name → tensor dict."""
    return {**frozen, **trainable}


def count_params(module: nn.Module, mask: Optional[Mapping[str, bool]] = None) -> int:
    """Elements of the module's parameters, only those ``mask`` marks when
    given (works on the ``meta`` device)."""
    return sum(p.numel() for name, p in module.named_parameters()
               if mask is None or mask[name])
