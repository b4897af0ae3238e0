"""The single-video dataset and the Stage-2 frame loader (port of
``videop2p_tpu/data/dataset.py``).

A clip is a directory of numbered frames or a video file (decoded through
imageio, else OpenCV). Frames come back as numpy channels-last arrays:
training clips (F, H, W, 3) float32 in [-1, 1]; Stage-2 sequences
(F, S, S, 3) uint8, center-cropped squares. PIL, imageio and OpenCV are
imported where a frame is read.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional

import numpy as np

__all__ = ["SingleVideoDataset", "load_frame_sequence"]

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _numeric_sort(names: List[str]) -> List[str]:
    """Names whose stem ends in digits first, by that number ('f_2.png'
    before 'f_10.png'), then the rest lexicographically."""

    def key(n):
        m = re.search(r"(\d+)$", os.path.splitext(n)[0])
        return (0, int(m.group(1)), n) if m else (1, 0, n)

    return sorted(names, key=key)


def _read_video_frames(path: str) -> List[np.ndarray]:
    """Every frame of a video file, RGB uint8."""
    try:
        import imageio.v3 as iio

        return [np.asarray(f) for f in iio.imiter(path)]
    except Exception:
        import cv2

        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
        if not frames:
            raise IOError(f"could not decode any frames from {path!r}")
        return frames


def _load_dir_frames(path: str) -> List[np.ndarray]:
    from PIL import Image

    names = _numeric_sort([n for n in os.listdir(path) if n.lower().endswith(_IMG_EXT)])
    if not names:
        raise IOError(f"no image frames in {path!r}")
    return [np.asarray(Image.open(os.path.join(path, n)).convert("RGB")) for n in names]


def _resize(frame: np.ndarray, width: int, height: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(frame).resize((width, height), Image.BICUBIC))


@dataclasses.dataclass
class SingleVideoDataset:
    """The one-clip training set: ``n_sample_frames`` frames of
    ``video_path`` (a video file or a directory of numbered frames) from
    ``sample_start_idx`` with stride ``sample_frame_rate``."""

    video_path: str
    prompt: str
    width: int = 512
    height: int = 512
    n_sample_frames: int = 8
    sample_start_idx: int = 0
    sample_frame_rate: int = 1

    def __len__(self) -> int:
        return 1

    def load(self) -> np.ndarray:
        """(F, H, W, 3) float32 in [-1, 1]."""
        if os.path.isdir(self.video_path):
            frames = _load_dir_frames(self.video_path)
        else:
            frames = _read_video_frames(self.video_path)
        idx = [self.sample_start_idx + i * self.sample_frame_rate
               for i in range(self.n_sample_frames)]
        if idx[-1] >= len(frames):
            raise ValueError(f"sampling indices {idx} exceed the {len(frames)} available "
                             f"frames of {self.video_path!r}")
        picked = [_resize(frames[i], self.width, self.height) for i in idx]
        return np.stack(picked).astype(np.float32) / 127.5 - 1.0


def load_frame_sequence(path: str, size: int = 512, num_frames: Optional[int] = None, *,
                        left: int = 0, right: int = 0, top: int = 0,
                        bottom: int = 0) -> np.ndarray:
    """The Stage-2 loader: the directory's frames in numeric order, each
    cropped by ``left``/``right``/``top``/``bottom`` pixels, center-cropped
    to a square and resized to ``size``², the first ``num_frames`` kept.
    Returns (F, size, size, 3) uint8."""
    out = []
    for img in _load_dir_frames(path):
        h, w = img.shape[:2]
        img = img[top:h - bottom if bottom else h, left:w - right if right else w]
        h, w = img.shape[:2]
        if h < w:
            off = (w - h) // 2
            img = img[:, off:off + h]
        elif w < h:
            off = (h - w) // 2
            img = img[off:off + w]
        out.append(_resize(img, size, size))
    if num_frames is not None:
        out = out[:num_frames]
    return np.stack(out).astype(np.uint8)
