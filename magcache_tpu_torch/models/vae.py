"""Causal-VAE primitives that the Wan, Open-Sora-Plan and CogVideoX VAEs are
built from (the ported part of ``magcache_tpu.models.vae``).

The JAX package keeps activations channel-last (NDHWC, XLA's TPU layout).
Here they are NCDHW, cuDNN's layout, with weights in PyTorch's conv layout
``[C_out, C_in, kt, kh, kw]``; the VAE's API converts at its boundary. The
convolutions are plain ``F.conv3d`` (cuDNN on a card): the JAX functions
reach no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["channel_rms_norm", "causal_conv3d", "group_norm", "GroupNormAffine",
           "init_convs_", "blend_edge", "stitch_tiles"]


def channel_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the channel axis (dim 1) of ``x [B, C, ...]`` with f32
    statistics and f32 ``weight``/``bias`` ``[C]``; returns x's dtype.
    Position-local statistics: a streamed decode equals a whole one."""
    shape = (-1,) + (1,) * (x.dim() - 2)
    x32 = x.float()
    out = x32 * torch.rsqrt((x32 * x32).mean(1, keepdim=True) + eps)
    out = out * weight.float().reshape(shape)
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of ``x [B, C, ...]`` (channel dim 1) with f32 statistics over
    each group's channels and every position, and f32 ``weight``/``bias``
    ``[C]``; returns x's dtype. ``groups`` falls back to the largest count
    that divides C (JAX ``group_norm``: ``while c % g: g -= 1``). The
    statistics span every frame: a decode in time slices differs from a
    whole one."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    return F.group_norm(x.float(), g, weight.float(), bias.float(), eps).to(x.dtype)


def causal_conv3d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: Union[int, Tuple[int, int, int]] = 1,
                  tcache: Optional[torch.Tensor] = None):
    """Causal-in-time 3-D convolution of ``x [B, C, T, H, W]`` by ``weight
    [C_out, C_in, kt, kh, kw]``, zero 'same' padding in space.

    The time axis is left-padded with ``kt - 1`` frames: the first frame
    replicated at clip start, or ``tcache`` (the previous chunk's tail) when
    streaming, which makes a chunked decode equal to a whole one. The next
    chunk's first window starts right after the ``n_out`` windows of step
    ``st`` this call consumed, which keeps a strided conv's window phase.
    Returns ``(y, new_tcache)`` (``new_tcache`` None for ``kt == 1``)."""
    kt, kh, kw = weight.shape[2:]
    stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    if kt > 1:
        front = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if tcache is None else tcache
        stream = torch.cat([front, x], dim=2)
        n_out = (stream.shape[2] - kt) // stride[0] + 1
        new_cache = stream[:, :, n_out * stride[0]:].clone()   # not a view of stream
    else:
        stream, new_cache = x, None
    y = F.conv3d(stream, weight, bias, stride=stride, padding=(0, (kh - 1) // 2, (kw - 1) // 2))
    return y, new_cache


class GroupNormAffine(nn.Module):
    """A GroupNorm's f32 ``weight`` (ones) and ``bias`` (zeros) ``[C]``; the
    norm itself is ``group_norm``."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))


def init_convs_(module: nn.Module, generator: torch.Generator) -> None:
    """Random conv weights as the JAX VAEs draw them (the draws themselves
    differ): ``N(0, 1/fan_in)`` from ``generator`` on its device, zero
    biases; every other parameter keeps its value."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                w = torch.randn(m.weight.shape, generator=generator, device=generator.device)
                m.weight.copy_(w / math.sqrt(m.weight[0].numel()))
                m.bias.zero_()


def blend_edge(a: torch.Tensor, b: torch.Tensor, ext: int, dim: int) -> torch.Tensor:
    """Tile ``b`` with its first ``ext`` entries along ``dim`` blended
    linearly (weights ``i / ext``) with the last ``ext`` of its neighbour
    ``a`` (the reference VAEs' ``blend_v`` / ``blend_h``); ``ext`` is clipped
    to both tiles."""
    ext = min(a.shape[dim], b.shape[dim], ext)
    if ext <= 0:
        return b
    shape = [1] * b.dim()
    shape[dim] = ext
    w = (torch.arange(ext, dtype=torch.float32, device=b.device) / ext).reshape(shape)
    edge = a.narrow(dim, a.shape[dim] - ext, ext) * (1 - w) + b.narrow(dim, 0, ext) * w
    return torch.cat([edge, b.narrow(dim, ext, b.shape[dim] - ext)], dim=dim)


def stitch_tiles(rows: List[List[torch.Tensor]], ext: int, limit: int) -> torch.Tensor:
    """Rows of decoded, overlapping ``[B, C, T, h, w]`` tiles -> one clip:
    each tile blended over ``ext`` pixels with its upper and left
    neighbours, cropped to ``limit`` x ``limit`` and concatenated."""
    out_rows = []
    for i, row in enumerate(rows):
        out = []
        for j, t in enumerate(row):
            if i > 0:
                t = blend_edge(rows[i - 1][j], t, ext, 3)
            if j > 0:
                t = blend_edge(row[j - 1], t, ext, 4)
            out.append(t[:, :, :, :limit, :limit])
        out_rows.append(torch.cat(out, dim=4))
    return torch.cat(out_rows, dim=3)
