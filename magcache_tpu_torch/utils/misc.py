"""Seeding, image and save helpers (counterpart of
``magcache_tpu.utils.misc``)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def set_seed(seed: int, device="cpu", dp_rank: Optional[int] = None) -> torch.Generator:
    """Seed -> ``torch.Generator`` on ``device``. A CPU generator gives the
    same numbers whichever card the tensors then move to. ``dp_rank``
    offsets the seed (``seed + dp_rank``), so each data-parallel element of
    a batch draws its own noise (``videosys/utils/utils.py:19-34``)."""
    if dp_rank is not None:
        seed = seed + dp_rank
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


def _save_npy(arr: np.ndarray, path: str) -> str:
    alt = os.path.splitext(path)[0] + ".npy"
    np.save(alt, arr)
    return alt


def _imageio_write(write, arr: np.ndarray, path: str) -> str:
    """``write(imageio)`` when imageio is installed and has a backend for
    ``path``'s format (an mp4 needs its ffmpeg plugin), else ``arr`` as
    ``.npy`` beside ``path``. Any other error of the write (malformed
    frames) propagates. Returns the path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio
    except ImportError:
        return _save_npy(arr, path)
    try:
        write(imageio)
    except ValueError as exc:
        if not str(exc).startswith("Could not find a backend"):
            raise
        return _save_npy(arr, path)
    return path


def save_video(video: np.ndarray, path: str, fps: int = 16) -> str:
    """Save [T, H, W, 3] frames with imageio, or as ``.npy`` beside ``path``
    where it has no writer for the format (``_imageio_write``)."""
    if video.dtype != np.uint8:
        video = to_uint8_video(video)
    return _imageio_write(lambda io: io.mimwrite(path, list(video), fps=fps), video, path)


def save_image(img: np.ndarray, path: str) -> str:
    """Save one [H, W, 3] frame, like ``save_video``."""
    if img.dtype != np.uint8:
        img = to_uint8_video(img[None])[0]
    return _imageio_write(lambda io: io.imwrite(path, img), img, path)


# The reference CLIs' save rates, which the HTTP server (cli/serve.py) saves at
# (Wan's sample_fps 16, ti2v 24; hyvideo 24; FramePack 30; videosys:
# cogvideox, latte and vchitect 8, open-sora(-plan) 24). First prefix match
# wins; anything else saves at 16.
_TASK_FPS = (("ti2v", 24), ("hunyuan", 24), ("framepack", 30),
             ("cogvideox", 8), ("latte", 8), ("vchitect", 8),
             ("open-sora", 24))


def task_fps(task: str) -> int:
    """Frames per second the reference CLIs save ``task``'s videos at."""
    return next((v for k, v in _TASK_FPS if task.startswith(k)), 16)
