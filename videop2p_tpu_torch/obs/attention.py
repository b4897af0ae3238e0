"""Cross-attention observability (port of ``videop2p_tpu/obs/attention.py``):
per-step records of the pipelines' loops, and the ``.npz`` sidecar the
ledger events point at.

The UNet's store maps each controlled site's module path to its head-mean
probability map (``models/attention.py``). :func:`attn_step_record` turns
one step's store into a few fixed-shape tensors, left on the device, that
a loop stacks once after its last step (``obs/telemetry.py``'s pattern):

  * ``cross_heat`` — (C, rh, rw, L): per conditional stream, the
    head/site/frame-averaged cross-attention heatmap pooled to
    :data:`ATTN_HEAT_RES` per token (the reference's
    ``show_cross_attention`` aggregates at 16×16);
  * ``entropy`` — {site: ()} per controlled site, the mean Shannon entropy
    of its attention rows;
  * ``mask_cov`` / ``mask_heat`` / ``blend_active`` — the LocalBlend mask
    series (added by the sampling loop, which owns the running map sum).

Sites carry the JAX package's flax paths (``down_blocks_0/attentions_0/
blocks_0/attn2``), so that the ledger's ``sites`` and ``entropy_mean`` keys
read the same in either package's ledger. The pooling reproduces
``jax.image.resize(method="linear")``: a triangle filter widened by the
scale when it downsamples (antialiasing), as an explicit separable matrix.
Capture is opt-in (``attn_maps=False`` everywhere); the outputs are the
same bits with it on or off.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ATTN_HEAT_RES",
    "ATTN_SUMMARY_FIELDS",
    "attn_store_leaves",
    "resize_linear",
    "cross_attention_heat",
    "site_entropies",
    "attn_step_record",
    "summarize_attn_record",
    "save_obs_sidecar",
    "load_obs_sidecar",
]

# the reference's aggregation resolution (show_cross_attention res=16)
ATTN_HEAT_RES: Tuple[int, int] = (16, 16)

# keys every summarize_attn_record carries (the ledger `attn_maps` event);
# mask keys appear only when the record holds a LocalBlend mask series
ATTN_SUMMARY_FIELDS = ("steps", "heat_shape", "sites", "entropy_mean")


def _site_name(path: str) -> str:
    """A module path of the port's UNet as the JAX package's flax site
    name: ``down_blocks.0.attentions.0.transformer_blocks.0.attn2`` →
    ``down_blocks_0/attentions_0/blocks_0/attn2``."""
    from videop2p_tpu_torch.models.convert import _flax_module_tokens

    return "/".join(_flax_module_tokens(path))


def attn_store_leaves(store) -> List[Tuple[str, torch.Tensor]]:
    """(site name, head-mean map) pairs of a UNet store, in the JAX store's
    tree-flatten order (flax names compared level by level); the nested
    capture dict (``store["attn_base"]``) is not among them."""
    named = [(_site_name(path).split("/"), leaf) for path, leaf in store.items()
             if isinstance(leaf, torch.Tensor)]
    return [("/".join(tokens), leaf) for tokens, leaf in sorted(named, key=lambda kv: kv[0])]


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of
    ``jax.image.resize(method="linear")`` along one axis: half-pixel sample
    positions, a triangle kernel widened by in/out when downsampling, each
    column normalized, a sample outside the input zeroed
    (``jax._src.image.scale.compute_weight_mat``). Made on ``device``, so a
    loop copies nothing from the host."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / float(np.float32(out_size) / np.float32(in_size))
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / max(inv_scale, 1.0)
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int], *, axes=(-2, -1)) -> torch.Tensor:
    """``jax.image.resize(x, ..., method="linear")`` over the two ``axes``
    of a float32 tensor (the other axes keep their size)."""
    ax_h, ax_w = (a % x.dim() for a in axes)
    for axis, size in ((ax_h, out_hw[0]), (ax_w, out_hw[1])):
        if x.shape[axis] == size:
            continue
        w = _resize_weights(x.shape[axis], size, x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, axis, -1), w, dims=1), -1, axis)
    return x


def _factor_queries(q: int, latent_hw: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """A cross site's query count as its (h, w) grid at the latent's aspect
    ratio; None when it does not factor."""
    lh, lw = latent_hw
    if lh <= 0 or lw <= 0:
        return None
    qh = int(round((q * lh / lw) ** 0.5))
    if qh <= 0 or q % qh:
        return None
    return qh, q // qh


def cross_attention_heat(store, *, num_uncond: int, num_cond: int, video_length: int,
                         text_len: int, latent_hw: Tuple[int, int],
                         heat_res: Tuple[int, int] = ATTN_HEAT_RES) -> torch.Tensor:
    """One step's head/site/frame-averaged per-token cross-attention
    heatmaps pooled to ``heat_res``: (num_cond, rh, rw, text_len). A site
    counts when its map is (B, Q, L) with B = (num_uncond + num_cond) ·
    video_length, L = text_len and Q a grid at the latent's aspect ratio;
    the uncond streams are dropped, the frames averaged. No such site gives
    zeros."""
    b_expect = (num_uncond + num_cond) * video_length
    acc = None
    n = 0
    for name, leaf in attn_store_leaves(store):
        if not name.endswith("attn2"):
            continue
        if leaf.dim() != 3 or leaf.shape[-1] != text_len or leaf.shape[0] != b_expect:
            continue
        grid = _factor_queries(leaf.shape[-2], latent_hw)
        if grid is None:
            continue
        maps = leaf.reshape(num_uncond + num_cond, video_length, grid[0], grid[1],
                            text_len)[num_uncond:].float().mean(dim=1)
        maps = resize_linear(maps, heat_res, axes=(1, 2))
        acc = maps if acc is None else acc + maps
        n += 1
    if acc is None:
        device = next((leaf.device for leaf in store.values()
                       if isinstance(leaf, torch.Tensor)), None)
        return torch.zeros((num_cond, *heat_res, text_len), device=device)
    return acc / n


def site_entropies(store) -> Dict[str, torch.Tensor]:
    """{site: the mean Shannon entropy (nats) of its attention rows} over
    every stored map (cross and temporal sites), each a 0-d tensor."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in attn_store_leaves(store):
        if leaf.dim() != 3:
            continue
        p = leaf.float()
        out[name] = (-(p * torch.log(p + 1e-12)).sum(dim=-1)).mean()
    return out


def attn_step_record(store, *, num_uncond: int, num_cond: int, video_length: int,
                     text_len: int, latent_hw: Tuple[int, int],
                     heat_res: Tuple[int, int] = ATTN_HEAT_RES) -> Dict:
    """One step's capture: ``cross_heat`` and ``entropy`` (the sampling
    loop adds the mask series where a LocalBlend is configured)."""
    return {"cross_heat": cross_attention_heat(
                store, num_uncond=num_uncond, num_cond=num_cond,
                video_length=video_length, text_len=text_len, latent_hw=latent_hw,
                heat_res=heat_res),
            "entropy": site_entropies(store)}


def summarize_attn_record(rec: Dict) -> Dict:
    """A stacked (num_steps, ...) capture record → the ledger ``attn_maps``
    event's payload: the step count, the heat's shape, the sites with their
    mean entropies, and the mask-coverage digest when the mask series
    exists (the arrays go to the sidecar)."""
    from videop2p_tpu_torch.obs.telemetry import to_host

    rec = to_host(rec)
    heat = rec["cross_heat"]
    entropy = {k: v.astype(np.float64) for k, v in rec.get("entropy", {}).items()}
    out: Dict = {
        "steps": int(heat.shape[0]),
        "heat_shape": list(heat.shape),
        "sites": sorted(entropy),
        "entropy_mean": {k: round(float(v.mean()), 4) if v.size else None
                         for k, v in sorted(entropy.items())},
    }
    if "mask_cov" in rec:
        cov = rec["mask_cov"].astype(np.float64)  # (T, P, F)
        out["mask_cov_final"] = [round(float(v), 4) for v in cov[-1].mean(-1)]
        out["mask_cov_mean"] = round(float(cov.mean()), 4)
    if "blend_active" in rec:
        out["blend_active_steps"] = int(rec["blend_active"].sum())
    return out


def save_obs_sidecar(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write the observability arrays as one compressed ``.npz`` the ledger
    events point at. numpy-only — readable on any box."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})
    return path


def load_obs_sidecar(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
