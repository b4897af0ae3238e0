"""Video output: GIF grids (port of ``videop2p_tpu/utils/video_io.py``).

A batch of videos is tiled into one animated grid; a single video is written
as a looping GIF. Inputs are channels-last numpy arrays, float in [0, 1] or
uint8. A single video is written with PIL (imageio, which writes the same
bytes through PIL, may be missing); a grid with imageio, imported where the
file is written.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

__all__ = ["to_uint8", "make_grid", "save_video_gif", "save_videos_grid"]


def to_uint8(videos: np.ndarray) -> np.ndarray:
    """float [0, 1] (or uint8, passed through) → uint8."""
    videos = np.asarray(videos)
    if videos.dtype == np.uint8:
        return videos
    return (np.clip(np.asarray(videos, dtype=np.float32), 0.0, 1.0) * 255).astype(np.uint8)


def make_grid(frames: np.ndarray, n_rows: int, pad: int = 2) -> np.ndarray:
    """(B, H, W, C) uint8 → one tiled (gH, gW, C) frame, ``n_rows`` images a
    row."""
    b, h, w, c = frames.shape
    cols = n_rows
    rows = math.ceil(b / cols)
    grid = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, cols)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = frames[i]
    return grid


def save_video_gif(video: np.ndarray, path: str, *, fps: int = 4) -> str:
    """Write one (F, H, W, C) video as a looping GIF (the Stage-2 artifact:
    250 ms a frame at the default 4 fps). Each frame's adaptive palette —
    what PIL's GIF writer makes of an RGB frame, nearly all of the write —
    is made in a thread pool (PIL releases the GIL there): the same bytes
    as handing PIL the RGB frames, in about half the time for 8 frames of
    512² noise."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    frames = [Image.fromarray(f) for f in to_uint8(video)]
    if frames[0].mode == "RGB":
        with ThreadPoolExecutor(max_workers=min(len(frames), os.cpu_count() or 1)) as pool:
            frames = list(pool.map(
                lambda im: im.convert("P", palette=Image.Palette.ADAPTIVE), frames))
    frames[0].save(path, format="GIF", save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return path


def save_videos_grid(videos: np.ndarray, path: str, *, n_rows: Optional[int] = None,
                     fps: int = 8) -> str:
    """Write (B, F, H, W, C) videos as one animated GIF grid; a ``.mp4``
    path writes mp4 when imageio can, else the ``.gif`` beside it."""
    import imageio

    videos = to_uint8(videos)
    b, f = videos.shape[:2]
    n_rows = n_rows if n_rows is not None else b
    frames = [make_grid(videos[:, t], n_rows) for t in range(f)]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    if path.endswith(".mp4"):
        try:
            imageio.mimsave(path, frames, fps=fps)
            return path
        except Exception:
            path = path[:-4] + ".gif"
    import imageio.v3 as iio

    iio.imwrite(path, np.stack(frames), extension=".gif", duration=int(1000 / fps), loop=0)
    return path
