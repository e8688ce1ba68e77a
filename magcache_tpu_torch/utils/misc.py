"""Seeding and save helpers (counterpart of ``magcache_tpu.utils.misc``)."""

from __future__ import annotations

import os
import numpy as np
import torch


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed -> ``torch.Generator`` on ``device``. A CPU generator gives the
    same numbers whichever card the tensors then move to."""
    return torch.Generator(device=device).manual_seed(seed)


def to_uint8_video(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8."""
    x = np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255)
    return x.astype(np.uint8)


def save_video(video: np.ndarray, path: str, fps: int = 16) -> str:
    """Save [T, H, W, 3] frames with imageio when it is installed, else as
    ``.npy`` beside ``path``. Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if video.dtype != np.uint8:
        video = to_uint8_video(video)
    try:
        import imageio
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, video)
        return alt
    imageio.mimwrite(path, list(video), fps=fps)
    return path


def save_image(img: np.ndarray, path: str) -> str:
    """Save one [H, W, 3] frame, like ``save_video``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if img.dtype != np.uint8:
        img = to_uint8_video(img[None])[0]
    try:
        import imageio
    except ImportError:
        alt = os.path.splitext(path)[0] + ".npy"
        np.save(alt, img)
        return alt
    imageio.imwrite(path, img)
    return path
