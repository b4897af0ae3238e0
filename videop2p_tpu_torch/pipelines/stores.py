"""Attention-store plumbing between the UNet's stored maps and LocalBlend
(port of ``videop2p_tpu/pipelines/stores.py``).

The UNet's ``store`` maps module paths to head-mean probability maps: cross
sites (B·F, Q, L), temporal sites (B·N, F, F). LocalBlend reads the
cross-attention sites whose query grid is (latent/4)² — the reference's
``down_cross[2:4] + up_cross[:3]`` — stacked into (P, F, S, r, r, L).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["blend_maps_from_store"]


def _ordered(store: Dict[str, torch.Tensor]) -> List[Tuple[str, torch.Tensor]]:
    """Head-mean leaves in the order of the JAX store's tree flatten (module
    paths compared segment by segment), so the stack order matches it. The
    nested capture dict (``store["attn_base"]``) is not one of them."""
    return sorted(((path, leaf) for path, leaf in store.items()
                   if isinstance(leaf, torch.Tensor)),
                  key=lambda kv: kv[0].split("."))


def _select_blend_leaves(store, r: Tuple[int, int],
                         text_len: int) -> List[torch.Tensor]:
    q_blend = r[0] * r[1]
    return [leaf for path, leaf in _ordered(store)
            if "attn2" in path and leaf.dim() == 3 and leaf.shape[-1] == text_len
            and leaf.shape[-2] == q_blend]


def _cross_site_sizes(store, text_len: int) -> List[int]:
    return sorted({leaf.shape[-2] for path, leaf in _ordered(store)
                   if "attn2" in path and leaf.dim() == 3
                   and leaf.shape[-1] == text_len})


def blend_maps_from_store(store: Dict[str, torch.Tensor], *,
                          latent_hw: Tuple[int, int], video_length: int,
                          num_prompts: int, text_len: int,
                          num_uncond: int) -> torch.Tensor:
    """Stack the blend-site cross maps of the conditional streams into
    (P, F, S, r, r, L); ``num_uncond`` uncond streams lead the batch. A model with no site at (latent/4)² falls back to the
    nearest square cross-site resolution, as the JAX version does."""
    r = (latent_hw[0] // 4, latent_hw[1] // 4)
    leaves = _select_blend_leaves(store, r, text_len)
    if not leaves and latent_hw[0] == latent_hw[1]:
        sizes = _cross_site_sizes(store, text_len)
        target = r[0] * r[1]
        squares = [q for q in sizes if int(q ** 0.5) ** 2 == q]
        if squares:
            side = int(min(squares, key=lambda s: abs(s - target)) ** 0.5)
            r = (side, side)
            leaves = _select_blend_leaves(store, r, text_len)
    if not leaves:
        raise ValueError(
            f"no cross-attention maps at blend resolution {r} in store "
            f"(text_len={text_len}, available query sizes "
            f"{_cross_site_sizes(store, text_len)}) — latent_hw mismatch?")
    stacked = torch.stack(leaves, dim=1)  # ((U+P)·F, S, Q, L)
    _, s, _, L = stacked.shape
    stacked = stacked.reshape(num_uncond + num_prompts, video_length, s, r[0], r[1], L)
    return stacked[num_uncond:]
