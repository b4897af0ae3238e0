"""LocalBlend: word-localized latent blending from stored cross-attention
(port of ``videop2p_tpu/control/local_blend.py``).

Per-frame spatial masks come from the running sum of the (latent/4)²
cross-attention maps, thresholded and unioned with the source stream's mask,
and pull the edited latents back toward the source outside the mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from videop2p_tpu_torch.control.schedules import get_word_inds
from videop2p_tpu_torch.utils.tokenizers import MAX_NUM_WORDS, Tokenizer

__all__ = ["LocalBlendConfig", "make_local_blend", "local_blend", "blend_mask"]


@dataclass
class LocalBlendConfig:
    alpha_layers: torch.Tensor  # (P, 1, 77) word mask per prompt stream
    substruct_layers: Optional[torch.Tensor] = None  # (P, 1, 77)
    start_blend: int = 10
    th: Tuple[float, float] = (0.3, 0.3)


def _word_alpha_layers(prompts: Sequence[str], words_per_prompt,
                       tokenizer: Tokenizer) -> np.ndarray:
    layers = np.zeros((len(prompts), 1, MAX_NUM_WORDS), dtype=np.float32)
    for i, (prompt, words) in enumerate(zip(prompts, words_per_prompt)):
        if isinstance(words, str):
            words = [words]
        for word in words:
            layers[i, :, get_word_inds(prompt, word, tokenizer)] = 1.0
    return layers


def make_local_blend(prompts: Sequence[str], words, tokenizer: Tokenizer,
                     num_steps: int, *, substruct_words=None,
                     start_blend: float = 0.2, th: Tuple[float, float] = (0.3, 0.3),
                     device=None) -> LocalBlendConfig:
    alpha_layers = torch.as_tensor(_word_alpha_layers(prompts, words, tokenizer),
                                   device=device)
    substruct = None
    if substruct_words is not None:
        substruct = torch.as_tensor(
            _word_alpha_layers(prompts, substruct_words, tokenizer), device=device)
    return LocalBlendConfig(alpha_layers=alpha_layers, substruct_layers=substruct,
                            start_blend=int(start_blend * num_steps), th=th)


def _get_mask(maps: torch.Tensor, word_layers: torch.Tensor, use_pool: bool,
              out_hw: Tuple[int, int], th: Tuple[float, float]) -> torch.Tensor:
    """Boolean (P, F, h, w) mask from (P, F, S, r, r, 77) summed maps."""
    sel = (maps * word_layers[:, None, None, None, None, :]).sum(-1).mean(2)
    if use_pool:
        sel = F.max_pool2d(sel, 3, stride=1, padding=1)
    mask = F.interpolate(sel, size=tuple(out_hw), mode="nearest-exact")
    mask = mask / (mask.amax(dim=(-2, -1), keepdim=True) + 1e-20)
    mask = mask > th[1 - int(use_pool)]
    return mask | mask[:1]


def blend_mask(maps: torch.Tensor, cfg: LocalBlendConfig,
               out_hw: Tuple[int, int]) -> torch.Tensor:
    mask = _get_mask(maps, cfg.alpha_layers[:, 0, :], True, out_hw, cfg.th)
    if cfg.substruct_layers is not None:
        sub = _get_mask(maps, cfg.substruct_layers[:, 0, :], False, out_hw, cfg.th)
        mask = mask & ~sub
    return mask


def local_blend(x_t: torch.Tensor, maps: torch.Tensor, cfg: LocalBlendConfig,
                step_index: int) -> torch.Tensor:
    """Blend (P, F, h, w, C) latents (source first) toward the source outside
    the word mask, once ``step_index >= start_blend``."""
    if step_index < cfg.start_blend:
        return x_t
    mask = blend_mask(maps, cfg, x_t.shape[2:4])
    maskf = mask.to(x_t.dtype)[..., None]
    return x_t[:1] + maskf * (x_t - x_t[:1])
