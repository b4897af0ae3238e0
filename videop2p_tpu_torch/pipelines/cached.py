"""Cached-source fast editing: replay the source stream from the inversion
(port of ``videop2p_tpu/pipelines/cached.py``).

DDIM ``next_step`` and ``prev_step`` are linear in (x, ε) with the same
coefficients, so the source latent at edit step *i* is ``trajectory[N − i]``:
the edit batch drops the source stream, from (P − 1) + P streams to
(P − 1) + (P − 1). What that stream gave the edit comes from the inversion:

  * its latents — read off the reversed trajectory, exactly;
  * its attention maps for the controllers — the full per-head
    probabilities captured during the inversion (bf16), only at the steps
    whose gates are open: the cross gate ``cross_replace_alpha[i]`` is zero
    past its window and the temporal gate is the self-replace window, so
    outside them the base maps are multiplied out exactly;
  * its LocalBlend contribution — captured per step, head-meaned and
    stacked at the blend sites.

The captured maps come from the inversion forward at ``(trajectory[j], t_j)``
while a live source stream would compute them at ``(trajectory[j + 1], t_j)``:
the same timestep, one trajectory position earlier (the JAX package's
disclosed approximation). The latent replay itself is exact.

Maps are keyed by module path (``down_blocks.0.attentions.0.
transformer_blocks.0.attn2``) in flat dicts; every step-indexed tensor is in
edit-step order, the reverse of the inversion walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from videop2p_tpu_torch.utils.cuda_graphs import index_step

__all__ = [
    "CachedSource",
    "capture_windows",
    "check_subset_windows",
    "filter_site_tree",
    "merge_site_trees",
    "slice_site_tree",
    "tree_bytes",
    "validate_step_positions",
]

SiteTree = Dict[str, torch.Tensor]


def capture_windows(ctx, num_steps: int) -> Tuple[int, Tuple[int, int]]:
    """The gate rule deciding which inversion steps capture maps: cross maps
    while any word's ``cross_replace_alpha`` is non-zero (a step prefix),
    temporal maps inside the self-replace window. Returns
    ``(cross_len, (self_lo, self_hi))``."""
    cra = ctx.cross_replace_alpha[:num_steps]
    active = (cra != 0).reshape(cra.shape[0], -1).any(dim=1)
    idx = active.nonzero()
    cross_len = int(idx.max()) + 1 if idx.numel() else 0
    return cross_len, tuple(ctx.self_replace_range)


def validate_step_positions(positions, base_steps: int) -> np.ndarray:
    """A timestep-subset walk's positions into the ``base_steps`` edit-order
    grid (``DDIMScheduler.subset_positions`` makes them), checked: 1-D,
    starting at 0 (the capture's x_T), strictly increasing, inside the base
    grid. Returns them as int64."""
    pos = np.asarray(positions, dtype=np.int64)
    if pos.ndim != 1 or pos.size < 1:
        raise ValueError(f"step_positions must be a 1-D sequence, got {positions!r}")
    if pos[0] != 0:
        raise ValueError(
            f"step_positions must start at 0 (the capture's x_T), got {pos[0]}")
    if pos.size > 1 and (np.diff(pos) <= 0).any():
        raise ValueError(f"step_positions must be strictly increasing: {pos.tolist()}")
    if pos[-1] >= base_steps:
        raise ValueError(
            f"step_positions reach {pos[-1]} but the capture covers [0, {base_steps})")
    return pos


def check_subset_windows(ctx, cached: "CachedSource", positions, num_steps: int) -> None:
    """Every step of a ``num_steps``-step subset walk whose controller gate
    is open must map, through ``positions``, inside the captured window of
    ``cached``: a step outside it would read a clamped, stale base map."""
    if ctx is None or ctx.kind == "empty":
        return
    cross_len_sub, (lo_s, hi_s) = capture_windows(ctx, num_steps)
    pos = np.asarray(positions)
    if cross_len_sub > 0:
        mapped = pos[:cross_len_sub]
        if cached.cross_len <= 0 or int(mapped.max()) >= cached.cross_len:
            raise ValueError(
                f"subset cross window maps to base steps {mapped.tolist()} "
                f"outside the captured cross window [0, {cached.cross_len})")
    if hi_s > lo_s:
        mapped = pos[lo_s:hi_s]
        lo_b, hi_b = cached.self_window
        if mapped.size and (int(mapped.min()) < lo_b or int(mapped.max()) >= hi_b):
            raise ValueError(
                f"subset self window maps to base steps {mapped.tolist()} "
                f"outside the captured self window [{lo_b}, {hi_b})")


def filter_site_tree(tree: SiteTree, site_name: str) -> SiteTree:
    """The entries whose module path ends at a module named ``site_name``
    (``"attn2"`` for cross sites, ``"attn_temp"`` for temporal sites)."""
    return {path: leaf for path, leaf in tree.items()
            if path.rsplit(".", 1)[-1] == site_name}


def merge_site_trees(a: Optional[SiteTree], b: Optional[SiteTree]) -> SiteTree:
    """Union of two site trees with disjoint paths."""
    return {**(a or {}), **(b or {})}


def slice_site_tree(tree: Optional[SiteTree], index) -> Optional[SiteTree]:
    """Every leaf indexed at ``index`` (an int, or a 0-d int64 tensor on the
    leaves' device) along its leading (step) axis."""
    if not tree:
        return None
    return {path: index_step(leaf, index) for path, leaf in tree.items()}


def tree_bytes(*trees: Optional[SiteTree]) -> int:
    """Total bytes of the tensor leaves of the given site trees."""
    return sum(leaf.numel() * leaf.element_size()
               for tree in trees if tree for leaf in tree.values())


@dataclass
class CachedSource:
    """Everything the cached-source edit reads in place of a live source
    stream; step-indexed tensors are in edit-step order."""

    # (num_steps + 1, 1, F, h, w, C): [i] is the source latent entering edit
    # step i, [i + 1] the one after it, [-1] = x_0
    src_latents: torch.Tensor
    # {path: (cross_len, F, H, Q, L)} at attn2 sites, edit steps [0, cross_len)
    cross_maps: Optional[SiteTree] = None
    # {path: (hi − lo, D, H, F, F)} at attn_temp sites, edit steps [lo, hi);
    # bf16, float8_e4m3fn, or int8 holding round(p·127)
    temporal_maps: Optional[SiteTree] = None
    # (num_steps, 1, F, S, r, r, L) float32: the source's LocalBlend maps
    blend_seq: Optional[torch.Tensor] = None
    cross_len: int = 0
    self_window: Tuple[int, int] = (0, 0)

    @property
    def num_steps(self) -> int:
        return self.src_latents.shape[0] - 1

    def _capture_compute_dtype(self) -> torch.dtype:
        """The dtype 1-byte temporal maps decode to: that of the sibling
        cross maps, else of the blend sequence, else float32."""
        for leaf in list((self.cross_maps or {}).values()) + [self.blend_seq]:
            if leaf is not None and leaf.element_size() > 1:
                return leaf.dtype
        return torch.float32

    def base_indices(self, step_index: int) -> Tuple[int, int]:
        """The capture indices edit step ``step_index`` reads: ``(cross,
        temporal)``, each clamped into its window (0 for an empty one)."""
        lo, hi = self.self_window
        return (min(max(step_index, 0), max(self.cross_len - 1, 0)),
                min(max(step_index - lo, 0), max(hi - lo - 1, 0)))

    def base_tree_at(self, step_index, temporal_index=None) -> Optional[SiteTree]:
        """The base maps of edit step ``step_index`` for
        :attr:`AttnControl.cached_base`. Outside a window the index clamps to
        the window's edge: that stale map is multiplied out by its closed
        gate. 1-byte temporal maps decode on read: float8 upcasts, int8
        divides by 127. With ``temporal_index`` both indices are 0-d int64
        tensors on the device (:meth:`base_indices`' pair, read from a step
        body's buffer), and the maps are gathered there."""
        if temporal_index is None:
            cross_index, temporal_index = self.base_indices(step_index)
        else:
            cross_index = step_index
        cross = None
        if self.cross_maps and self.cross_len > 0:
            cross = slice_site_tree(self.cross_maps, cross_index)
        temporal = None
        lo, hi = self.self_window
        if self.temporal_maps and hi > lo:
            temporal = slice_site_tree(self.temporal_maps, temporal_index)
            target = self._capture_compute_dtype()
            for path, leaf in temporal.items():
                if leaf.element_size() == 1:
                    wide = leaf.to(target)
                    if not leaf.dtype.is_floating_point:
                        wide = wide / 127.0
                    temporal[path] = wide
        if cross is None and temporal is None:
            return None
        return merge_site_trees(cross, temporal)
