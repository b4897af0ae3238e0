"""The cached-source fast edit: capture-inversion followed by the controlled
edit (port of ``videop2p_tpu/pipelines/fast.py``), and the memory budget that
decides whether its captured maps fit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from videop2p_tpu_torch.control.controllers import ControlContext
from videop2p_tpu_torch.core.ddim import DDIMScheduler
from videop2p_tpu_torch.core.noise import DependentNoiseSampler
from videop2p_tpu_torch.models.attention import ControlledAttention
from videop2p_tpu_torch.pipelines.inversion import ddim_inversion_captured
from videop2p_tpu_torch.pipelines.sampling import UNetFn, edit_sample

__all__ = [
    "cached_fast_edit",
    "capture_bytes",
    "choose_cached_maps",
    "maps_budget_decision",
    "CACHED_MAPS_BUDGET_GB",
]

# the JAX package's per-chip budget for the captured maps (a TPU figure,
# kept so that the port decides as the reference does)
CACHED_MAPS_BUDGET_GB = 6.0
# the bf16 the capture stores maps in, whatever the compute dtype
_CAPTURE_ITEMSIZE = 2


def _controlled_sites(unet, latent_hw: Tuple[int, int]) -> Dict[str, Tuple[str, int, int]]:
    """{module path: (site, heads, query tokens)} of every controlled site of
    ``unet`` at latents of ``latent_hw``: a down block's sites see its input
    resolution, its downsampler halves it (rounding up); an up block's
    upsampler doubles it."""
    h, w = latent_hw
    level = {}
    for i, block in enumerate(unet.down_blocks):
        level[f"down_blocks.{i}."] = h * w
        if block.downsamplers is not None:
            h, w = (h + 1) // 2, (w + 1) // 2
    level["mid_block."] = h * w
    for i, block in enumerate(unet.up_blocks):
        level[f"up_blocks.{i}."] = h * w
        if block.upsamplers is not None:
            h, w = 2 * h, 2 * w
    sites = {}
    for path, module in unet.named_modules():
        if isinstance(module, ControlledAttention):
            prefix = next(p for p in level if path.startswith(p))
            sites[path] = (module.site, module.heads * module.tp_size, level[prefix])
    return sites


def capture_bytes(unet, latents_shape: Sequence[int], text_len: int, *,
                  cross_len: int, self_window: Tuple[int, int],
                  temporal_maps_dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of the maps :func:`ddim_inversion_captured` keeps for latents of
    ``latents_shape`` (B, F, h, w, C), counted from the controlled sites
    without running the capture (JAX: ``tree_bytes`` of ``capture_shapes``):
    per cross site ``cross_len`` maps of (B·F, H, Q, L) in bf16, per temporal
    site ``hi − lo`` maps of (B·Q, H, F, F) in ``temporal_maps_dtype``."""
    b, f, h, w = latents_shape[:4]
    lo, hi = self_window
    t_item = (_CAPTURE_ITEMSIZE if temporal_maps_dtype is None
              else torch.empty((), dtype=temporal_maps_dtype).element_size())
    total = 0
    for site, heads, tokens in _controlled_sites(unet, (h, w)).values():
        if site == "cross":
            total += cross_len * b * f * heads * tokens * text_len * _CAPTURE_ITEMSIZE
        else:
            total += (hi - lo) * b * tokens * heads * f * f * t_item
    return total


def maps_budget_decision(map_bytes: int, *, sp: int = 1,
                         budget_gb: float = CACHED_MAPS_BUDGET_GB) -> Tuple[bool, float]:
    """Whether ``map_bytes`` of captured maps fit the budget per GPU: on a
    mesh of ``sp`` frame shards each GPU holds 1/sp of them (its frames'
    cross maps, its query rows' temporal maps). ``(fits, map_gib)``, the
    GiB of the whole capture."""
    map_gb = map_bytes / 2 ** 30
    return map_gb / max(int(sp), 1) <= budget_gb, map_gb


def choose_cached_maps(bytes_for: Callable[[Optional[torch.dtype]], int], *,
                       sp: int = 1, budget_gb: float = CACHED_MAPS_BUDGET_GB):
    """The cached-mode decision: full-precision (bf16) maps first, then the
    temporal maps at one byte per probability, ``float8_e4m3fn`` (about 6 %
    relative step on [0, 1]) and then ``int8`` as round(p·127) (a uniform
    1/254 step). ``bytes_for(temporal_maps_dtype)`` is
    :func:`capture_bytes` for that storage dtype; the budget is per GPU of
    ``sp`` frame shards (JAX's per-chip ``sp``). Returns ``(use_cached,
    temporal_maps_dtype, map_gib)``; dtype None means full precision."""
    candidates = [None]
    if hasattr(torch, "float8_e4m3fn"):
        candidates.append(torch.float8_e4m3fn)
    candidates.append(torch.int8)
    for dtype in candidates:
        fits, map_gb = maps_budget_decision(bytes_for(dtype), sp=sp, budget_gb=budget_gb)
        if fits:
            return True, dtype, map_gb
    return False, None, map_gb


@torch.no_grad()
def cached_fast_edit(unet_fn: UNetFn, scheduler: DDIMScheduler, latents: torch.Tensor,
                     cond_src: torch.Tensor, cond_all: torch.Tensor,
                     uncond: torch.Tensor, ctx: Optional[ControlContext], *,
                     num_inference_steps: int = 50, guidance_scale: float = 7.5,
                     cross_len: int = 0, self_window: Tuple[int, int] = (0, 0),
                     temporal_maps_dtype: Optional[torch.dtype] = None,
                     dependent_weight: float = 0.0,
                     dependent_sampler: Optional[DependentNoiseSampler] = None,
                     generator: Optional[torch.Generator] = None,
                     reuse_schedule: Optional[str] = None,
                     student_head: Optional[dict] = None, telemetry: bool = False,
                     attn_maps: bool = False, device_probe: Optional[Callable] = None,
                     cuda_graphs: Optional[bool] = None):
    """Capture-inversion of ``latents`` under ``cond_src``, then the
    cached-source controlled edit under ``cond_all`` / ``uncond``. Returns
    ``(trajectory, edited)``: the trajectory (N + 1, 1, F, h, w, C) and the
    (P, F, h, w, C) latents whose stream 0 is the trajectory's x_0. The
    dependent-noise arguments go to the capture-inversion (one draw a step);
    the edit replays the trajectory it recorded, so stream 0 stays x_0
    exactly under dependent noise too. ``reuse_schedule`` reuses the deep
    feature across the edit's steps (``pipelines/reuse.py``); the capture
    always runs the full UNet (its maps feed the controllers).
    ``student_head`` runs the edit as the consistency-distilled student
    (``train/distill.py``): its time head modulates the edit streams' ε;
    the capture runs the UNet it is given without the head.

    ``telemetry`` adds the edit's per-step statistics, ``attn_maps`` the
    attention records ``{"inversion": the source stream's, from the
    capture walk; "edit": the edit streams' with the blend-mask series}``
    (``edit_sample``'s records), ``device_probe`` the edit's per-device
    channels; the return is then ``(trajectory, edited[, tel][, dev][,
    attn])``, the outputs the same bits as without them.

    ``cuda_graphs``: both loops' steps replay as CUDA graphs when None (the
    default) on a CUDA device, on one card or a mesh (``utils/cuda_graphs.py``);
    False runs the eager loops, the same bits."""
    if attn_maps and reuse_schedule not in (None, "off"):
        # edit_sample refuses it too; refuse before the capture runs
        raise ValueError(
            "attn_maps capture reads every step's attention store and "
            "shallow reuse steps do not produce one — run attention "
            "capture with reuse_schedule='off'")
    inv = ddim_inversion_captured(
        unet_fn, scheduler, latents, cond_src,
        num_inference_steps=num_inference_steps, cross_len=cross_len,
        self_window=self_window,
        capture_blend=ctx is not None and ctx.blend is not None,
        temporal_maps_dtype=temporal_maps_dtype, dependent_weight=dependent_weight,
        dependent_sampler=dependent_sampler, generator=generator, attn_maps=attn_maps,
        cuda_graphs=cuda_graphs)
    trajectory, cached = inv[0], inv[1]
    edited = edit_sample(unet_fn, scheduler, trajectory[-1], cond_all, uncond,
                         num_inference_steps=num_inference_steps,
                         guidance_scale=guidance_scale, ctx=ctx,
                         source_uses_cfg=False, cached_source=cached,
                         reuse_schedule=reuse_schedule, student_head=student_head,
                         telemetry=telemetry, attn_maps=attn_maps,
                         device_probe=device_probe, cuda_graphs=cuda_graphs)
    if not (telemetry or attn_maps or device_probe is not None):
        return trajectory, edited
    edited, *extras = edited
    out = (trajectory, edited)
    if telemetry:
        out += (extras.pop(0),)
    if device_probe is not None:
        out += (extras.pop(0),)
    if attn_maps:
        out += ({"inversion": inv[2], "edit": extras.pop(0)},)
    return out
