"""Still-image helpers: P2P's notebook surface (port of
``videop2p_tpu/utils/images.py``).

Grid and caption compositing is numpy + PIL; text → image sampling is the
video pipeline's ``edit_sample`` at a single frame, so the controlled CFG
loop, the scheduler step and LocalBlend are the video path's; decoding is
the port's VAE. PIL is imported where an image is composed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from videop2p_tpu_torch.utils.video_io import to_uint8

__all__ = [
    "text_under_image",
    "view_images",
    "latent2image",
    "latent2image_video",
    "init_latent",
    "text2image_ldm",
    "text2image_stable",
]


def text_under_image(
    image: np.ndarray,
    text: str,
    text_color: Tuple[int, int, int] = (0, 0, 0),
) -> np.ndarray:
    """Extend ``image`` (H, W, 3 uint8) downward by 20 % and center ``text``
    in the new strip."""
    from PIL import Image, ImageDraw

    img = np.asarray(image, dtype=np.uint8)
    h, w, c = img.shape
    offset = int(h * 0.2)
    out = np.full((h + offset, w, c), 255, dtype=np.uint8)
    out[:h] = img
    pil = Image.fromarray(out)
    draw = ImageDraw.Draw(pil)
    left, top, right, bottom = draw.textbbox((0, 0), text)
    tw, th = right - left, bottom - top
    draw.text(((w - tw) // 2, h + (offset - th) // 2), text, fill=text_color)
    return np.asarray(pil)


def view_images(
    images: Union[np.ndarray, Sequence[np.ndarray]],
    num_rows: int = 1,
    offset_ratio: float = 0.02,
    save_path: Optional[str] = None,
):
    """Tile images (each H, W, 3 uint8) into a white-padded grid. Returns the
    PIL image; saves to ``save_path`` when given and displays inline only
    under IPython."""
    from PIL import Image

    if isinstance(images, np.ndarray) and images.ndim == 3:
        images = [images]
    images = [np.asarray(im, dtype=np.uint8) for im in images]
    num_empty = len(images) % num_rows
    if num_empty:
        images += [np.full_like(images[0], 255)] * (num_rows - num_empty)

    h, w, _ = images[0].shape
    offset = int(h * offset_ratio)
    num_cols = len(images) // num_rows
    grid = np.full(
        (h * num_rows + offset * (num_rows - 1),
         w * num_cols + offset * (num_cols - 1), 3),
        255,
        dtype=np.uint8,
    )
    for idx, im in enumerate(images):
        r, c = divmod(idx, num_cols)
        grid[r * (h + offset): r * (h + offset) + h,
             c * (w + offset): c * (w + offset) + w] = im
    pil = Image.fromarray(grid)
    if save_path is not None:
        pil.save(save_path)
    try:  # pragma: no cover - notebook-only path
        from IPython.display import display

        get_ipython  # noqa: B018 — defined only inside IPython
        display(pil)
    except (ImportError, NameError):
        pass
    return pil


def _images(x: torch.Tensor) -> np.ndarray:
    """Images in [-1, 1] → uint8."""
    return to_uint8(x.detach().float().cpu().numpy() / 2 + 0.5)


@torch.no_grad()
def latent2image(vae, latents: torch.Tensor) -> np.ndarray:
    """Scaled image latents (B, h, w, 4) → uint8 images (B, 8h, 8w, 3):
    ÷ the scaling factor, decode, [-1, 1] → [0, 255]."""
    z = latents.to(vae.dtype) / vae.config.scaling_factor
    return _images(vae.decode(z))


@torch.no_grad()
def latent2image_video(vae, latents: torch.Tensor, *, chunk: int = 4) -> np.ndarray:
    """Scaled video latents (1, F, h, w, 4) → uint8 frames (F, 8h, 8w, 3),
    decoded ``chunk`` frames at a time."""
    from videop2p_tpu_torch.models.vae import decode_video

    return _images(decode_video(vae, latents, chunk=chunk)[0])


def init_latent(latent: Optional[torch.Tensor], batch_size: int, *, height: int = 512,
                width: int = 512, channels: int = 4, vae_scale_factor: int = 8,
                generator: Optional[torch.Generator] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (from ``generator``, on ``device``) or pass through a batch-1
    latent (1, h, w, C) and expand it to the prompt batch, so every stream
    shares x_T. Returns ``(latent, latents)``."""
    if latent is None:
        if generator is None:
            raise ValueError("init_latent needs a generator when latent is None")
        latent = torch.randn(
            (1, height // vae_scale_factor, width // vae_scale_factor, channels),
            generator=generator, device=device if device is not None else generator.device)
    return latent, latent.expand(batch_size, *latent.shape[1:])


def text2image_ldm(unet_fn, scheduler, vq_decode_fn, cond_embeddings: torch.Tensor,
                   uncond_embeddings: torch.Tensor, *, ctx=None,
                   num_inference_steps: int = 50, guidance_scale: float = 7.0,
                   height: int = 256, width: int = 256, vae_scale_factor: int = 8,
                   channels: int = 4, latent: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Controlled text → image sampling for latent-diffusion checkpoints with
    a VQ decoder (256², guidance 7.0): the caller's ``cond_embeddings``
    (P, L, D) and ``uncond_embeddings`` (L, D) through the shared
    ``edit_sample`` loop at one frame, then ``vq_decode_fn`` (latents
    (B, h, w, C) → images in [-1, 1]). Returns ``(images uint8, latent)``."""
    from videop2p_tpu_torch.pipelines.sampling import edit_sample

    latent, latents = init_latent(
        latent, cond_embeddings.shape[0], height=height, width=width, channels=channels,
        vae_scale_factor=vae_scale_factor, generator=generator,
        device=cond_embeddings.device)
    out = edit_sample(unet_fn, scheduler, latents[:, None], cond_embeddings,
                      uncond_embeddings, num_inference_steps=num_inference_steps,
                      guidance_scale=guidance_scale, ctx=ctx)
    return _images(vq_decode_fn(out[:, 0])), latent


def text2image_stable(unet_fn, scheduler, vae, cond_embeddings: torch.Tensor,
                      uncond_embeddings: torch.Tensor, *, ctx=None,
                      num_inference_steps: int = 50, guidance_scale: float = 7.5,
                      height: int = 512, width: int = 512, vae_scale_factor: int = 8,
                      latent: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Controlled text → image sampling as a 1-frame video: the shared
    ``edit_sample`` loop runs the CFG denoise with the P2P controller and
    LocalBlend, then the VAE decodes. ``cond_embeddings`` (P, 77, D), the
    source prompt first. Returns ``(images uint8, latent)``."""
    from videop2p_tpu_torch.pipelines.sampling import edit_sample

    latent, latents = init_latent(
        latent, cond_embeddings.shape[0], height=height, width=width,
        vae_scale_factor=vae_scale_factor, generator=generator,
        device=cond_embeddings.device)
    out = edit_sample(unet_fn, scheduler, latents[:, None], cond_embeddings,
                      uncond_embeddings, num_inference_steps=num_inference_steps,
                      guidance_scale=guidance_scale, ctx=ctx)
    return latent2image(vae, out[:, 0]), latent
