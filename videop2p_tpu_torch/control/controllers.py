"""Prompt-to-prompt attention control as a plain function over attention
probabilities (port of ``videop2p_tpu/control/controllers.py``).

    probs' = control_attention(probs, ctx, is_cross=..., step_index=...)

All schedule state is precomputed into a :class:`ControlContext` on the
device; the sampling loop supplies the step index. Only the conditional
streams are edited: cross-attention maps of the source stream are mapped into
each edit stream (refine: per-token gather and alpha blend; replace: a soft
77×77 permutation), optionally reweighted by an equalizer and gated by the
per-step cross-replace alpha; temporal maps of the source stream replace the
edit streams' inside the self-replace step window. The SpatialReplace
controller edits no map: it copies the source stream's latent into every
edit stream after the scheduler step, for the first steps of the walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.control import seq_aligner
from videop2p_tpu_torch.control.local_blend import LocalBlendConfig, make_local_blend
from videop2p_tpu_torch.control.schedules import (
    get_time_words_attention_alpha,
    get_word_inds,
)
from videop2p_tpu_torch.utils.cuda_graphs import index_step
from videop2p_tpu_torch.utils.tokenizers import MAX_NUM_WORDS, Tokenizer

__all__ = ["ControlContext", "make_controller", "make_spatial_replace_controller",
           "control_attention", "get_equalizer"]


@dataclass
class ControlContext:
    """Everything an attention edit needs. ``num_prompts`` counts the
    conditional streams (source + edits)."""

    cross_replace_alpha: torch.Tensor  # (num_steps+1, n_edits, 1, 1, 77)
    refine_mapper: Optional[torch.Tensor] = None  # (n_edits, 77) int64
    refine_alphas: Optional[torch.Tensor] = None  # (n_edits, 77)
    replace_mapper: Optional[torch.Tensor] = None  # (n_edits, 77, 77)
    equalizer: Optional[torch.Tensor] = None  # (n_edits, 77)
    blend: Optional[LocalBlendConfig] = None
    kind: str = "refine"  # "replace" | "refine" | "empty"
    num_prompts: int = 2
    self_replace_range: Tuple[int, int] = (0, 0)
    # SpatialReplace: the sampling loops copy the source stream's latent
    # into every edit stream after each step i < this (0: off)
    spatial_replace_until: int = 0

    @property
    def n_edits(self) -> int:
        return self.num_prompts - 1


def get_equalizer(text: str, words: Sequence[str], values: Sequence[float],
                  tokenizer: Tokenizer, max_len: int = MAX_NUM_WORDS) -> np.ndarray:
    """Per-token attention rescale factors, shape (1, max_len). Raises where
    the reference silently does nothing: a word that tokenizes to no position
    of ``text``, or a words/values length mismatch."""
    eq = np.ones((1, max_len), dtype=np.float32)
    if isinstance(words, str):
        words = (words,)
    if isinstance(values, (int, float)):
        values = (values,)
    words, values = list(words), list(values)
    if len(words) != len(values):
        raise ValueError(
            f"equalizer words/values length mismatch: {len(words)} word(s) "
            f"{words!r} vs {len(values)} value(s) {values!r}")
    for word, val in zip(words, values):
        inds = get_word_inds(text, word, tokenizer)
        if len(inds) == 0:
            raise ValueError(
                f"equalizer word {word!r} does not tokenize to any position "
                f"of the edit prompt {text!r} — the reweight would silently "
                "never apply")
        eq[:, inds] = float(val)
    return eq


def make_controller(prompts: Sequence[str], tokenizer: Tokenizer, num_steps: int, *,
                    is_replace_controller: bool, cross_replace_steps,
                    self_replace_steps,
                    blend_words: Optional[Tuple[Sequence[str], Sequence[str]]] = None,
                    equalizer_params: Optional[Dict] = None,
                    mask_th: Tuple[float, float] = (0.3, 0.3),
                    start_blend: float = 0.2, device=None) -> ControlContext:
    """The edit context for a source prompt plus edit prompts: a replace
    controller for word swaps, else refine; an optional equalizer and
    LocalBlend. Its tensors live on ``device``."""
    n_prompts = len(prompts)
    if n_prompts < 2:
        raise ValueError(
            "attention control needs a source prompt plus at least one edit "
            f"prompt, got {n_prompts} prompt(s)")

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    cra = get_time_words_attention_alpha(prompts, num_steps, cross_replace_steps,
                                         tokenizer)
    refine_mapper = refine_alphas = replace_mapper = None
    if is_replace_controller:
        replace_mapper = dev(seq_aligner.get_replacement_mapper(prompts, tokenizer))
        kind = "replace"
    else:
        m, a = seq_aligner.get_refinement_mapper(prompts, tokenizer)
        refine_mapper, refine_alphas = dev(m.astype(np.int64)), dev(a)
        kind = "refine"

    equalizer = None
    if equalizer_params is not None:
        eq = get_equalizer(prompts[1], equalizer_params["words"],
                           equalizer_params["values"], tokenizer)
        # one row per edit stream, all from prompts[1] (the reference's rule)
        equalizer = dev(np.broadcast_to(eq, (n_prompts - 1, eq.shape[1])).copy())

    blend = None
    if blend_words is not None:
        blend = make_local_blend(prompts, blend_words, tokenizer, num_steps,
                                 th=mask_th, start_blend=start_blend, device=device)

    if isinstance(self_replace_steps, (int, float)):
        self_replace_steps = (0.0, float(self_replace_steps))
    srr = (int(num_steps * self_replace_steps[0]),
           int(num_steps * self_replace_steps[1]))
    return ControlContext(
        cross_replace_alpha=dev(cra), refine_mapper=refine_mapper,
        refine_alphas=refine_alphas, replace_mapper=replace_mapper,
        equalizer=equalizer, blend=blend, kind=kind, num_prompts=n_prompts,
        self_replace_range=srr)


def make_spatial_replace_controller(stop_inject: float, num_steps: int, *,
                                    num_prompts: int = 2, device=None) -> ControlContext:
    """SpatialReplace (JAX: ``controllers.py:187-204``): no attention edit;
    for the first ``int((1 − stop_inject)·num_steps)`` steps every edited
    stream's latent is replaced with the source stream's after the
    scheduler step."""
    return ControlContext(
        cross_replace_alpha=torch.zeros(
            (num_steps + 1, max(num_prompts - 1, 1), 1, 1, MAX_NUM_WORDS), device=device),
        kind="empty", num_prompts=num_prompts, self_replace_range=(0, 0),
        spatial_replace_until=int((1.0 - stop_inject) * num_steps))


def _edit_cross(base: torch.Tensor, repl: torch.Tensor, ctx: ControlContext,
                step_index) -> torch.Tensor:
    """base (F, H, Q, W) source-stream cross maps; repl (E, F, H, Q, W) edit
    streams → the edited edit streams. ``step_index`` (an int, or a 0-d
    int64 tensor on the device) picks the step's gate."""
    if ctx.kind == "replace":
        new = torch.einsum("fhqw,ewn->efhqn", base, ctx.replace_mapper.to(base.dtype))
    elif ctx.kind == "refine":
        # a -1 (a token with no source) wraps to the last position, as
        # jnp.take does; its alpha is 0, so only the blend reads it
        gathered = torch.stack([base.index_select(-1, m % base.shape[-1])
                                for m in ctx.refine_mapper])
        al = ctx.refine_alphas[:, None, None, None, :].to(base.dtype)
        new = gathered * al + repl * (1.0 - al)
    else:
        raise ValueError(f"unknown cross edit kind: {ctx.kind!r}")
    if ctx.equalizer is not None:
        new = new * ctx.equalizer[:, None, None, None, :].to(new.dtype)
    alpha_words = index_step(ctx.cross_replace_alpha, step_index)[:, :, :, None, :].to(new.dtype)
    return new * alpha_words + (1.0 - alpha_words) * repl


def _edit_temporal(base: torch.Tensor, repl: torch.Tensor, ctx: ControlContext,
                   step_index: int) -> torch.Tensor:
    """base (D, H, F, F) source-stream temporal maps; repl (E, D, H, F, F)."""
    lo, hi = ctx.self_replace_range
    if lo <= step_index < hi:
        return base[None].expand_as(repl)
    return repl


def control_attention(probs: torch.Tensor, ctx: Optional[ControlContext], *,
                      is_cross: bool, step_index: int, video_length: int,
                      num_uncond: int = -1,
                      base_map: Optional[torch.Tensor] = None,
                      frame_shards: int = 1,
                      step: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply the edit to full-batch probabilities, U uncond streams first:
    cross ((U+P)·F, H, Q, W) with frames folded into the batch; temporal
    ((U+P)·D, H, F, F) with spatial positions folded into the batch, or,
    with the frames split over ``frame_shards`` ranks, this rank's
    ((U+P)·D, H, F/frame_shards, F) query rows of them.

    ``base_map``: the cached-source mode — the source stream is not in the
    batch (its cond streams are the P − 1 edits only) and its maps for this
    site and step come from this capture: (F, H, Q, W) at cross sites,
    (D, H, F, F) at temporal sites.

    ``step``: ``step_index`` as a 0-d int64 tensor on the device, which
    then indexes the cross gate (a CUDA graph's step body reads it from a
    buffer); ``step_index`` still decides the temporal window."""
    if ctx is None or ctx.kind == "empty":
        return probs
    P = ctx.num_prompts
    U = P if num_uncond < 0 else num_uncond
    ncond = P if base_map is None else P - 1
    B, H, Q, K = probs.shape
    if B % (U + ncond):
        raise ValueError(
            f"attention batch {B} does not factor into {U} uncond + {ncond} cond streams")
    inner = B // (U + ncond)
    if is_cross and inner != video_length:
        raise ValueError(
            f"cross-attention batch {B} does not factor as ({U}+{ncond})·{video_length} "
            "(uncond+cond streams × frames) — batch layout mismatch")
    # a frame-sharded mesh keeps a rank's query rows: (F/sp × F) maps
    if not is_cross and (K != video_length or Q * frame_shards != video_length):
        raise ValueError(
            f"temporal attention maps must be ({video_length // frame_shards}×"
            f"{video_length}) over {frame_shards} frame shard(s), got ({Q}×{K})")
    split = probs.reshape(U + ncond, inner, H, Q, K)
    if base_map is None:
        base, repl = split[U], split[U + 1:]
    else:
        if tuple(base_map.shape) != (inner, H, Q, K):
            raise ValueError(
                f"cached base map shape {tuple(base_map.shape)} does not match the "
                f"site's per-stream probability shape {(inner, H, Q, K)}")
        base, repl = base_map.to(probs.dtype), split[U:]
    if is_cross:
        edited = _edit_cross(base, repl, ctx, step_index if step is None else step)
    else:
        edited = _edit_temporal(base, repl, ctx, step_index)
    keep = split[:U] if base_map is not None else split[:U + 1]
    out = torch.cat([keep, edited], dim=0)
    return out.reshape(B, H, Q, K)
