"""The backward of a kernel that has no backward kernel of its own: recompute
the forward through the kernel's plain version under autograd and take its
vector-Jacobian product (the JAX package's ``custom_vjp`` rules
``_fused_bwd`` and ``_fused_gn_bwd`` do the same through ``jax.vjp``)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["recompute_grads"]


def recompute_grads(plain: Callable, inputs: Sequence[torch.Tensor],
                    needs: Sequence[bool], grad_out: torch.Tensor) -> tuple:
    """The gradients of ``plain(*inputs)`` against ``grad_out``, one per
    input: None where ``needs`` is false."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need) for x, need in zip(inputs, needs)]
        wanted = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(plain(*leaves), wanted, grad_out))
    return tuple(next(grads) if need else None for need in needs)
