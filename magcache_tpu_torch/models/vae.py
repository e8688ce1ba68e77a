"""Causal-VAE primitives that Wan's VAE is built from (the ported part of
``magcache_tpu.models.vae``).

The JAX package keeps activations channel-last (NDHWC, XLA's TPU layout).
Here they are NCDHW, cuDNN's layout, with weights in PyTorch's conv layout
``[C_out, C_in, kt, kh, kw]``; the VAE's API converts at its boundary. The
convolutions are plain ``F.conv3d`` (cuDNN on a card): the JAX functions
reach no Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["channel_rms_norm", "causal_conv3d"]


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
