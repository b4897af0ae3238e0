"""Trainable-parameter selection by module-name suffix (port of
``videop2p_tpu/train/masking.py``).

Stage 1 freezes the UNet and trains the parameters of every module whose
dotted name ends with one of ``trainable_modules``, by default the query
projections of the frame and text attentions and the whole temporal
attention. :func:`partition_params` splits ``named_parameters()`` by that
rule and sets ``requires_grad`` to match, so the backward computes and
stores no gradient for the frozen ~90 % and the optimizer keeps no state
for it (JAX's partition of the parameter tree saves the same memory).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["DEFAULT_TRAINABLE", "trainable_mask", "partition_params", "merge_params",
           "count_params"]

DEFAULT_TRAINABLE = ("attn1.to_q", "attn2.to_q", "attn_temp")


def trainable_mask(module: nn.Module,
                   patterns: Sequence[str] = DEFAULT_TRAINABLE) -> Dict[str, bool]:
    """{parameter name: True where it trains}: a parameter trains when one
    of the modules above it has a name ending with a pattern (the
    reference's ``name.endswith(pattern)`` over ``named_modules()``)."""
    trained = set()
    for name, sub in module.named_modules():
        if any(name.endswith(p) for p in patterns):
            trained.update(id(p) for p in sub.parameters())
    return {name: id(p) in trained for name, p in module.named_parameters()}


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
