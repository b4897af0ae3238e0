"""Word→token index mapping and time-dependent cross-replace alpha schedules;
this package's copy of ``videop2p_tpu/control/schedules.py``.

Host-side (numpy) precomputation mirroring ptp_utils.py:258-310: the whole
per-step schedule is materialized as one fixed-shape array up front, and the
sampling loop indexes it with the step counter.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from videop2p_tpu_torch.utils.tokenizers import MAX_NUM_WORDS, Tokenizer

__all__ = ["get_word_inds", "update_alpha_time_word", "get_time_words_attention_alpha"]

Bounds = Union[float, Tuple[float, float]]


def get_word_inds(text: str, word_place: Union[int, str], tokenizer: Tokenizer) -> np.ndarray:
    """Token positions (1-based, after BOS) covering the given word of ``text``
    (ptp_utils.py:258-276).

    ``word_place`` is either a word-index into ``text.split(' ')`` or a word
    string (all occurrences). Handles words split into multiple subword tokens
    by walking the decoded pieces and matching accumulated characters.
    """
    split_text = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, word in enumerate(split_text) if word_place == word]
    else:
        places = [int(word_place)]
    out = []
    if places:
        pieces = [tokenizer.decode_token(t) for t in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i, piece in enumerate(pieces):
            cur_len += len(piece)
            if ptr in places:
                out.append(i + 1)
            if ptr < len(split_text) and cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, dtype=np.int64)


def update_alpha_time_word(
    alpha: np.ndarray,
    bounds: Bounds,
    prompt_ind: int,
    word_inds: Optional[np.ndarray] = None,
) -> np.ndarray:
    """In-place write of the 0/1 step-window for one edit stream
    (ptp_utils.py:279-289)."""
    if isinstance(bounds, (int, float)):
        bounds = (0.0, float(bounds))
    start, end = int(bounds[0] * alpha.shape[0]), int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[Bounds, Dict[str, Bounds]],
    tokenizer: Tokenizer,
    max_num_words: int = MAX_NUM_WORDS,
) -> np.ndarray:
    """Per-(step, edit, word) cross-attention replacement gate, shape
    ``(num_steps + 1, n_edits, 1, 1, max_num_words)`` (ptp_utils.py:292-310).

    ``cross_replace_steps`` may be a scalar/range ``default_`` plus per-word
    overrides keyed by the word string.
    """
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)

    n_edits = len(prompts) - 1
    alpha = np.zeros((num_steps + 1, n_edits, max_num_words), dtype=np.float32)
    for i in range(n_edits):
        alpha = update_alpha_time_word(alpha, cross_replace_steps["default_"], i)
    for key, bounds in cross_replace_steps.items():
        if key == "default_":
            continue
        for i in range(n_edits):
            inds = get_word_inds(prompts[i + 1], key, tokenizer)
            if len(inds) > 0:
                alpha = update_alpha_time_word(alpha, bounds, i, inds)
    return alpha.reshape(num_steps + 1, n_edits, 1, 1, max_num_words)
