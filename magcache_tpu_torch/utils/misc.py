"""Seeding, image and save helpers (counterpart of
``magcache_tpu.utils.misc``)."""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def set_seed(seed: int, device="cpu") -> torch.Generator:
    """Seed -> ``torch.Generator`` on ``device``. A CPU generator gives the
    same numbers whichever card the tensors then move to."""
    return torch.Generator(device=device).manual_seed(seed)


def resize_bicubic(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Channel-last images ``[B, H, W, C]`` -> ``[B, h, w, C]`` f32, as
    ``jax.image.resize(method="bicubic")`` resizes them: the Keys cubic with
    a = -0.5, stretched by the scale when shrinking (antialiased), taps
    outside the image dropped and the weights renormalised. That is
    PyTorch's antialiased bicubic (its plain bicubic uses a = -0.75 and
    no antialiasing, up to 0.6 away on a natural downsample)."""
    x = img.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1).contiguous()


def resize_video_bicubic(video: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """Channel-last videos ``[B, F, H, W, C]`` -> ``[B, T, h, w, C]`` f32, as
    ``jax.image.resize(method="bicubic")`` resizes them over time and space:
    ``resize_bicubic`` over H and W, then over time with the H*W pixels as
    the second axis (at an unchanged size the antialiased cubic is the
    identity)."""
    b, f, _, _, c = video.shape
    t, h, w = size
    x = resize_bicubic(video.reshape((b * f,) + tuple(video.shape[2:])), (h, w))
    if t != f:
        x = resize_bicubic(x.reshape(b, f, h * w, c), (t, h * w))
    return x.reshape(b, t, h, w, c)


def resize_nearest(x: torch.Tensor, size: Tuple[int, ...]) -> torch.Tensor:
    """The last ``len(size)`` axes of ``x`` resized to ``size`` by nearest
    neighbour at half-pixel centres (``jax.image.resize(method="nearest")``:
    PyTorch's "nearest-exact"; its "nearest" picks other rows)."""
    lead = x.shape[:x.ndim - len(size)]
    y = F.interpolate(x.float().reshape((-1, 1) + tuple(x.shape[len(lead):])),
                      size=tuple(size), mode="nearest-exact")
    return y.reshape(tuple(lead) + tuple(size))


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
