"""Prompt token alignment → attention-map mappers (host-side, pure numpy);
this package's copy of ``videop2p_tpu/control/seq_aligner.py``.

Re-implementation of the reference's seq_aligner.py (itself from
google/prompt-to-prompt): Needleman-Wunsch global alignment over token ids
produces, for each edited prompt, a per-token source index (+ validity alphas)
used by AttentionRefine, and a soft (77×77) permutation matrix used by
AttentionReplace. Outputs are fixed-shape numpy arrays that the edit functions
move to the device once.

Semantics preserved exactly (incl. tie-breaking): scoring gap=0 / match=1 /
mismatch=-1 and traceback preference left > up > diag
(reference seq_aligner.py:63-78); refinement padding maps positions past
the target sequence to themselves (seq_aligner.py:115-119); replacement
requires equal word counts and spreads mass 1/|target| over multi-token
targets (seq_aligner.py:154-187).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from videop2p_tpu_torch.utils.tokenizers import MAX_NUM_WORDS, Tokenizer
from videop2p_tpu_torch.control.schedules import get_word_inds

__all__ = [
    "global_align",
    "aligned_target_to_source",
    "get_refinement_mapper",
    "get_replacement_mapper",
]

GAP, MATCH, MISMATCH = 0, 1, -1
# traceback codes
_LEFT, _UP, _DIAG, _STOP = 1, 2, 3, 4


def global_align(x: Sequence[int], y: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Needleman-Wunsch DP over two id sequences.

    Returns (score matrix, traceback matrix) with the reference's exact
    initialization and tie-breaking (seq_aligner.py:48-78).
    """
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    score[0, 1:] = (np.arange(ny) + 1) * GAP
    score[1:, 0] = (np.arange(nx) + 1) * GAP
    trace = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    trace[0, 1:] = _LEFT
    trace[1:, 0] = _UP
    trace[0, 0] = _STOP

    xa = np.asarray(x)
    ya = np.asarray(y)
    for i in range(1, nx + 1):
        # vectorized over j would break the left-dependency; keep the inner
        # loop in numpy scalars (prompts are <77 tokens — negligible cost)
        for j in range(1, ny + 1):
            left = score[i, j - 1] + GAP
            up = score[i - 1, j] + GAP
            diag = score[i - 1, j - 1] + (MATCH if xa[i - 1] == ya[j - 1] else MISMATCH)
            best = max(left, up, diag)
            score[i, j] = best
            if best == left:
                trace[i, j] = _LEFT
            elif best == up:
                trace[i, j] = _UP
            else:
                trace[i, j] = _DIAG
    return score, trace


def aligned_target_to_source(
    x: Sequence[int], y: Sequence[int], trace: np.ndarray
) -> np.ndarray:
    """(len(y), 2) array of (target_pos, source_pos-or--1) pairs from the
    traceback (seq_aligner.py:81-106)."""
    i, j = len(x), len(y)
    pairs: List[Tuple[int, int]] = []
    while i > 0 or j > 0:
        code = trace[i, j]
        if code == _DIAG:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif code == _LEFT:
            j -= 1
            pairs.append((j, -1))
        elif code == _UP:
            i -= 1
        else:  # _STOP
            break
    pairs.reverse()
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _mapper_for_pair(
    x: str, y: str, tokenizer: Tokenizer, max_len: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token source index + validity alphas for one (source, target) pair
    (seq_aligner.py:109-120)."""
    x_ids = tokenizer.encode(x)
    y_ids = tokenizer.encode(y)
    _, trace = global_align(x_ids, y_ids)
    pairs = aligned_target_to_source(x_ids, y_ids, trace)

    alphas = np.ones(max_len, dtype=np.float32)
    alphas[: pairs.shape[0]] = (pairs[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, dtype=np.int64)
    mapper[: pairs.shape[0]] = pairs[:, 1]
    mapper[pairs.shape[0] :] = len(y_ids) + np.arange(max_len - len(y_ids))
    return mapper, alphas


def get_refinement_mapper(
    prompts: Sequence[str], tokenizer: Tokenizer, max_len: int = MAX_NUM_WORDS
) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked refine mappers/alphas for prompts[1:] against prompts[0]
    (seq_aligner.py:123-130). Shapes: (n_edits, max_len) each."""
    mappers, alphas = [], []
    for target in prompts[1:]:
        m, a = _mapper_for_pair(prompts[0], target, tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def _replacement_mapper_for_pair(
    x: str, y: str, tokenizer: Tokenizer, max_len: int
) -> np.ndarray:
    """(max_len, max_len) soft permutation for a word-swap edit
    (seq_aligner.py:154-187). Requires equal word counts."""
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edits need equal word counts, got "
            f"{len(words_x)} vs {len(words_y)} — use a refine edit instead"
        )
    swapped = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [get_word_inds(x, i, tokenizer) for i in swapped]
    inds_target = [get_word_inds(y, i, tokenizer) for i in swapped]

    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = 0
    cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and len(inds_source[cur]) and inds_source[cur][0] == i:
            src, tgt = inds_source[cur], inds_target[cur]
            if len(src) == len(tgt):
                mapper[src, tgt] = 1.0
            else:
                for t in tgt:
                    mapper[src, t] = 1.0 / len(tgt)
            cur += 1
            i += len(src)
            j += len(tgt)
        elif cur < len(inds_source):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(
    prompts: Sequence[str], tokenizer: Tokenizer, max_len: int = MAX_NUM_WORDS
) -> np.ndarray:
    """Stacked (n_edits, max_len, max_len) replace mappers
    (seq_aligner.py:191-197)."""
    return np.stack(
        [_replacement_mapper_for_pair(prompts[0], t, tokenizer, max_len) for t in prompts[1:]]
    )
