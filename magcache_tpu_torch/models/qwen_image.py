"""Qwen-Image and Qwen-Image-Edit DiT, as PyTorch modules.

Same model as ``magcache_tpu.models.qwen_image`` (the reference adapters
``MagCache4QwenImage`` and ``MagCache4QwenImageEdit``): a joint text/image
MMDiT of double-stream blocks only (60 at hidden 3,072, 24 heads of 128; no
single-stream stage), FLUX's blocks through ``models/flux.py`` (K1 with the
fixed max, K2 in head scope, K3 mod) with ``depth_single = 0``, no guidance
embedding and no pooled text vector, and an RMSNorm gain (``txt_norm``) on
the Qwen2.5-VL text states before the text projection. It is not
guidance-distilled: the pipeline runs true CFG, two lanes a step.

Edit: the reference image's packed latents follow the noise tokens in the
image stream, each reference on its own rope block (index-axis id k for
reference k, as diffusers' per-image ``img_shapes``); the MagCache residual
covers them, and the head keeps only the noise tokens.

The timestep: ``prepare`` takes the sampler's ``t`` on the 0..1000 scale
(``sigma * 1000``) and the FLUX core embeds it as it is. The JAX pipeline
hands its FLUX core the same ``sigma * 1000``, which that core multiplies by
1000 again; the port does not carry that over (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.flux import (FluxConfig, FluxModel, flux_img_rope_block,
                                            flux_rope_tables, make_flux_core)
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["QwenImageConfig", "QwenImageModel", "QWEN_IMAGE", "make_qwen_image_core",
           "qwen_image_rope_tables"]


@dataclasses.dataclass(frozen=True)
class QwenImageConfig:
    in_channels: int = 64            # 16 latent channels x 2x2 pack
    hidden: int = 3072
    heads: int = 24
    depth: int = 60
    mlp_ratio: int = 4
    text_dim: int = 3584             # Qwen2.5-VL hidden
    axes_dims: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    time_embed_dim: int = 256
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def to_flux(self) -> FluxConfig:
        """The MMDiT's config: double blocks only, no guidance embedding;
        ``vec_dim`` 8 sizes the unused pooled-vector embedder, as in JAX."""
        return FluxConfig(
            in_channels=self.in_channels, hidden=self.hidden, heads=self.heads,
            depth_double=self.depth, depth_single=0, mlp_ratio=self.mlp_ratio,
            text_dim=self.text_dim, vec_dim=8, axes_dims=self.axes_dims, theta=self.theta,
            guidance_embed=False, time_embed_dim=self.time_embed_dim, dtype=self.dtype)

    @staticmethod
    def tiny(**kw) -> "QwenImageConfig":
        """A test-size config (the JAX package's ``QwenImageConfig.tiny``)."""
        defaults = dict(in_channels=16, hidden=96, heads=4, depth=2, text_dim=24,
                        axes_dims=(8, 8, 8), time_embed_dim=32)
        defaults.update(kw)
        return QwenImageConfig(**defaults)


# Qwen-Image at the published width (20.4 B parameters, 40.8 GB in bf16)
QWEN_IMAGE = QwenImageConfig()


class QwenImageModel(nn.Module):
    """The MMDiT (``mmdit``, a ``FluxModel`` of ``cfg.to_flux()``) and the f32
    ``txt_norm`` gain. Build on ``device``, then ``init(generator)`` or
    ``load_state_dict`` (``models/convert.py::qwen_image_params_from_numpy``)."""

    def __init__(self, cfg: QwenImageConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mmdit = FluxModel(cfg.to_flux(), device)
        self.txt_norm = nn.Parameter(torch.ones(cfg.text_dim, device=device))

    def init(self, generator: torch.Generator) -> "QwenImageModel":
        """Random weights from ``generator``: FLUX's init, a unit gain."""
        self.mmdit.init(generator)
        return self


def qwen_image_rope_tables(cfg: FluxConfig, txt_len: int, grid_h: int, grid_w: int,
                           ref_images: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) over ``[txt; img; ref_1 ... ref_R]``: FLUX's tables, then
    reference k's image block at index-axis id k."""
    base = flux_rope_tables(cfg, txt_len, grid_h, grid_w)
    refs = [flux_img_rope_block(cfg, grid_h, grid_w, k) for k in range(1, ref_images + 1)]
    return tuple(np.concatenate([base[i]] + [r[i] for r in refs], axis=0) for i in (0, 1))


def make_qwen_image_core(model: QwenImageModel, txt_len: int, grid_h: int, grid_w: int,
                         ref_images: int = 0) -> DiTCore:
    """(prepare, trunk, head) for a static text length and packed grid.

    cond = {"txt": f[B, txt_len, text_dim] (Qwen2.5-VL states),
            "ref": f[B, R * grid_h * grid_w, in_channels] (Edit: the
            references' packed latents)}
    x    = packed latents f[B, grid_h * grid_w, in_channels]
    t    = timesteps on the 0..1000 scale, f32[B]
    """
    cur = grid_h * grid_w
    rope = (qwen_image_rope_tables(model.mmdit.cfg, txt_len, grid_h, grid_w, ref_images)
            if ref_images else None)
    mmdit = make_flux_core(model.mmdit, txt_len, grid_h, grid_w, rope_tables=rope)

    @torch.inference_mode()
    def prepare(x, t, cond):
        txt = rms_norm(cond["txt"].float(), model.txt_norm, eps=1e-6)
        if ref_images:
            x = torch.cat([x, cond["ref"].to(x.dtype)], dim=1)
        return mmdit.prepare(x, t, {"txt": txt})

    @torch.inference_mode()
    def head(img, ctx):
        # the noise tokens only; LayerNorm and the linear act per token
        return mmdit.head(img[:, :cur] if ref_images else img, ctx)

    return DiTCore(prepare, mmdit.trunk, head)
