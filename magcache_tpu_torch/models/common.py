"""Shared building blocks for DiT model families.

The JAX package's ``linear`` (``x @ w + b`` with ``w: [d_in, d_out]``) is
``torch.nn.Linear`` here, whose weight is ``[d_out, d_in]``;
``models/convert.py`` transposes. Mixed-dtype products never promote in
PyTorch, so callers upcast explicitly where JAX would promote.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# a model config's ``dtype`` name -> its torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def embedder_linears(d_in: int, d: int, device=None) -> nn.ModuleDict:
    """The f32 ``in`` (``d_in -> d``) and ``out`` (``d -> d``) linears of a
    two-layer embedder whose activation its caller applies (STDiT3's and
    Latte's timestep and caption embedders)."""
    return nn.ModuleDict({"in": nn.Linear(d_in, d, device=device),
                          "out": nn.Linear(d, d, device=device)})


class MLPEmbedder(nn.ModuleDict):
    """``out(silu(in(x)))`` with f32 ``in``/``out`` linears: the JAX
    package's ``mlp_embedder`` parameters and ``apply_mlp_embedder``."""

    def __init__(self, d_in: int, d_hidden: int, device=None):
        f32 = torch.float32
        super().__init__({
            "in": nn.Linear(d_in, d_hidden, device=device, dtype=f32),
            "out": nn.Linear(d_hidden, d_hidden, device=device, dtype=f32)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self["out"](F.silu(self["in"](x)))
