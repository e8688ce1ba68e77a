"""Rotary position embeddings, interleaved-pair convention.

Pairs are adjacent channels (x0, x1), (x2, x3), ... as in Wan's
``view_as_complex`` on ``[..., d/2, 2]``:
``(x_e, x_o) -> (x_e*cos - x_o*sin, x_e*sin + x_o*cos)``. Rotations are
(cos, sin) tables of shape ``[seq, head_dim/2]`` built on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["rope_freqs_1d", "apply_rope", "grouped_rope_tables"]


def rope_freqs_1d(positions: np.ndarray, dim: int,
                  theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 tables ``[len(positions), dim/2]`` for
    ``freq_k = pos * theta^(-2k/dim)``, computed in f64."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    inv_freq = theta ** (-np.arange(0, dim, 2, dtype=np.float64) / dim)
    angles = np.asarray(positions, dtype=np.float64)[:, None] * inv_freq[None, :]
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x[..., seq, heads, head_dim]`` by ``[seq, head_dim/2]`` tables,
    in f32; returns the input dtype."""
    x32 = x.float()
    xe, xo = x32[..., 0::2], x32[..., 1::2]
    c = cos.float()[:, None, :]
    s = sin.float()[:, None, :]
    out = torch.stack([xe * c - xo * s, xe * s + xo * c], dim=-1).flatten(-2)
    return out.to(x.dtype)


def grouped_rope_tables(n_pos: int, group: int, dim: int,
                        theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 ``[group, dim/2]`` over in-group positions for the
    grouped kernel (K5): ``rope_freqs_1d(arange(n_pos))`` with the identity
    rotation (cos 1, sin 0) on padded positions ``n_pos..group-1``. The
    unpadded counterpart of ``magcache_tpu.models.packed.grouped_rope_tables``,
    which also pads lanes to 128 and duplicates each pair's entry."""
    cos = np.ones((group, dim // 2), np.float32)
    sin = np.zeros((group, dim // 2), np.float32)
    cos[:n_pos], sin[:n_pos] = rope_freqs_1d(np.arange(n_pos), dim, theta)
    return cos, sin
