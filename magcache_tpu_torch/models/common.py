"""Shared building blocks for DiT model families.

The JAX package's ``linear`` (``x @ w + b`` with ``w: [d_in, d_out]``) is
``torch.nn.Linear`` here, whose weight is ``[d_out, d_in]``;
``models/convert.py`` transposes. Mixed-dtype products never promote in
PyTorch, so callers upcast explicitly where JAX would promote.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_linear_(layer: nn.Linear, generator: torch.Generator) -> None:
    """LeCun-normal weight (std ``1/sqrt(d_in)``) and zero bias, drawn in f32
    from ``generator`` on its device, then cast to the layer's dtype."""
    d_out, d_in = layer.weight.shape
    w = torch.randn((d_out, d_in), generator=generator,
                    device=generator.device, dtype=torch.float32)
    with torch.no_grad():
        layer.weight.copy_(w * (1.0 / math.sqrt(d_in)))
        if layer.bias is not None:
            layer.bias.zero_()


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       *, scale: float = 1.0) -> torch.Tensor:
    """Sinusoidal timestep features in f32: half cos, half sin, with
    frequencies ``max_period^{-i/(dim/2)}``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = scale * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
