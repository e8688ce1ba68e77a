"""Normalization primitives with f32 statistics that return the input dtype
(as ``magcache_tpu.ops.norms``)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["rms_norm", "layer_norm"]


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim: f32 statistics, optional f32 gain, output
    rounded to the input dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """Two-pass LayerNorm over the last dim (optionally affine-free), f32
    statistics, output rounded to the input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    cent = x32 - mean
    var = (cent * cent).mean(-1, keepdim=True)
    out = cent * torch.reciprocal(torch.sqrt(var + eps))
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
