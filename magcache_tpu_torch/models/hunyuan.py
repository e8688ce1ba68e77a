"""HunyuanVideo T2V DiT and FramePack's packed variant, as PyTorch modules.

Same model as ``magcache_tpu.models.hunyuan`` (the reference adapters
``MagCache4HunyuanVideo`` and ``MagCache4FramePack``): FLUX's double-stream
+ single-stream MMDiT (20 + 40 blocks at hidden 3,072, 24 heads of 128;
``models/flux.py`` runs it, so K1, K2 in head scope and K3) with

- 3-D RoPE over the (t, y, x) latent patch grid, axes (16, 56, 56), theta
  256, passed to the FLUX core as its rope tables;
- text conditioning from an LLM encoder through a 2-block "individual token
  refiner" (f32 self-attention blocks gated by the timestep and the pooled
  context) instead of FLUX's plain linear; its attention is ``attention()``
  (K1 with the running max above 128 tokens, in bf16 on the card);
- with ``framepack``: three f32 clean-latent projections (patch kernels
  (1, 2, 2), (2, 4, 4) and (4, 8, 8)) whose tokens ride the image stream
  ahead of the noise window (``img_pre_tokens``), at the rope positions of
  ``framepack_rope_tables``.

The timestep: the sampler's ``t`` is on the 0..1000 scale (``sigma *
1000``). The FLUX core embeds it as it is and so does the refiner. The JAX
FLUX core multiplies it by 1000 again while the JAX refiner does not; the
port does not carry that over (ROADMAP §3).

The MagCache residual covers the whole image stream ([clean tokens or
history; window]); the head keeps only the current window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import (DTYPES, MLPEmbedder, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.models.flux import FluxConfig, FluxModel, make_flux_core
from magcache_tpu_torch.ops.attention import attention
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d

__all__ = ["HunyuanConfig", "HunyuanModel", "HUNYUAN_VIDEO", "make_hunyuan_core",
           "hunyuan_rope_tables", "framepack_rope_tables", "refine_text",
           "patchify_video", "unpatchify_video", "patchify_k"]


@dataclasses.dataclass(frozen=True)
class HunyuanConfig:
    in_channels: int = 16
    hidden: int = 3072
    heads: int = 24
    depth_double: int = 20
    depth_single: int = 40
    mlp_ratio: int = 4
    text_dim: int = 4096          # LLM hidden states
    vec_dim: int = 768            # CLIP pooled
    refiner_depth: int = 2
    patch: Tuple[int, int, int] = (1, 2, 2)
    axes_dims: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 256.0
    time_embed_dim: int = 256
    guidance_embed: bool = True
    framepack: bool = False       # FramePack's clean-latent projections
    dtype: str = "float32"        # the MMDiT's dtype; refiner and clean
                                  # projections stay f32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def patch_in(self) -> int:
        pt, ph, pw = self.patch
        return self.in_channels * pt * ph * pw

    def to_flux(self) -> FluxConfig:
        """The MMDiT trunk's config (the refiner's output is its text)."""
        return FluxConfig(
            in_channels=self.patch_in, hidden=self.hidden, heads=self.heads,
            depth_double=self.depth_double, depth_single=self.depth_single,
            mlp_ratio=self.mlp_ratio, text_dim=self.hidden, vec_dim=self.vec_dim,
            axes_dims=self.axes_dims, theta=self.rope_theta,
            guidance_embed=self.guidance_embed, time_embed_dim=self.time_embed_dim,
            dtype=self.dtype)

    @staticmethod
    def tiny(**kw) -> "HunyuanConfig":
        """A test-size config (the JAX package's ``HunyuanConfig.tiny``)."""
        defaults = dict(in_channels=8, hidden=96, heads=4, depth_double=2,
                        depth_single=2, text_dim=32, vec_dim=16, axes_dims=(8, 8, 8),
                        refiner_depth=1, time_embed_dim=32)
        defaults.update(kw)
        return HunyuanConfig(**defaults)


# HunyuanVideo T2V at the published width (12.8 B parameters)
HUNYUAN_VIDEO = HunyuanConfig()


def _f32_linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, device=device, dtype=torch.float32)


class RefinerBlock(nn.Module):
    """One token-refiner block (f32); names follow the JAX pytree."""

    def __init__(self, cfg: HunyuanConfig, device=None):
        super().__init__()
        d = cfg.hidden
        self.qkv = _f32_linear(d, 3 * d, device)
        self.proj = _f32_linear(d, d, device)
        self.mlp1 = _f32_linear(d, cfg.mlp_ratio * d, device)
        self.mlp2 = _f32_linear(cfg.mlp_ratio * d, d, device)
        self.mod = _f32_linear(d, 2 * d, device)
        for n in ("norm1", "norm2"):
            setattr(self, f"{n}_w", nn.Parameter(torch.ones(d, device=device)))
            setattr(self, f"{n}_b", nn.Parameter(torch.zeros(d, device=device)))


class TokenRefiner(nn.Module):
    def __init__(self, cfg: HunyuanConfig, device=None):
        super().__init__()
        self.proj_in = _f32_linear(cfg.text_dim, cfg.hidden, device)
        self.t_embed = MLPEmbedder(cfg.time_embed_dim, cfg.hidden, device)
        self.c_embed = MLPEmbedder(cfg.text_dim, cfg.hidden, device)
        self.blocks = nn.ModuleList(RefinerBlock(cfg, device)
                                    for _ in range(cfg.refiner_depth))


class HunyuanModel(nn.Module):
    """The MMDiT (``mmdit``, a ``FluxModel`` of ``cfg.to_flux()``), the token
    refiner and, with ``cfg.framepack``, the clean-latent projections. Build
    on ``device``, then ``init(generator)`` or ``load_state_dict`` (see
    ``models/convert.py::hunyuan_params_from_numpy``)."""

    def __init__(self, cfg: HunyuanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.mmdit = FluxModel(cfg.to_flux(), device)
        self.refiner = TokenRefiner(cfg, device)
        if cfg.framepack:
            c, d = cfg.in_channels, cfg.hidden
            self.clean_proj = _f32_linear(c * 1 * 2 * 2, d, device)
            self.clean_proj_2x = _f32_linear(c * 2 * 4 * 4, d, device)
            self.clean_proj_4x = _f32_linear(c * 4 * 8 * 8, d, device)

    def init(self, generator: torch.Generator) -> "HunyuanModel":
        """Random weights from ``generator``: LeCun-normal linears with zero
        bias, unit gains and norm weights, zero norm biases, as
        ``init_hunyuan_params`` draws them (the draws themselves differ)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def patchify_k(lat: torch.Tensor, pt: int, ph: int, pw: int) -> torch.Tensor:
    """``[B, F, H, W, C]`` -> ``[B, (F/pt)(H/ph)(W/pw), C*pt*ph*pw]`` with an
    arbitrary patch kernel (the clean-latent pyramid's levels)."""
    b, f, h, w, c = lat.shape
    lat = lat.reshape(b, f // pt, pt, h // ph, ph, w // pw, pw, c)
    lat = lat.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return lat.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def patchify_video(cfg: HunyuanConfig, lat: torch.Tensor) -> torch.Tensor:
    return patchify_k(lat, *cfg.patch)


def unpatchify_video(cfg: HunyuanConfig, x: torch.Tensor,
                     grid: Tuple[int, int, int]) -> torch.Tensor:
    """Inverse of ``patchify_video`` over the token grid ``(gt, gh, gw)``."""
    b = x.shape[0]
    gt, gh, gw = grid
    pt, ph, pw = cfg.patch
    c = cfg.in_channels
    x = x.reshape(b, gt, gh, gw, c, pt, ph, pw).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, gt * pt, gh * ph, gw * pw, c)


def _tables(cfg: HunyuanConfig, txt_len: int, coords: np.ndarray):
    """(cos, sin) over ``[txt; img]``: the identity rotation on text, each
    rope axis over its channel segment on the image tokens' (t, y, x)."""
    parts = [rope_freqs_1d(coords[:, ax], dim, cfg.rope_theta)
             for ax, dim in enumerate(cfg.axes_dims)]
    half = cfg.head_dim // 2
    cos = np.concatenate([np.ones((txt_len, half), np.float32),
                          np.concatenate([p[0] for p in parts], -1)], 0)
    sin = np.concatenate([np.zeros((txt_len, half), np.float32),
                          np.concatenate([p[1] for p in parts], -1)], 0)
    return cos, sin


def hunyuan_rope_tables(cfg: HunyuanConfig, txt_len: int, grid: Tuple[int, int, int]):
    """(cos, sin) f32 over ``[txt; img]`` for the token grid ``(gt, gh, gw)``."""
    gt, gh, gw = grid
    coords = np.stack(np.meshgrid(np.arange(gt), np.arange(gh), np.arange(gw),
                                  indexing="ij"), -1).reshape(-1, 3)
    return _tables(cfg, txt_len, coords)


def framepack_rope_tables(cfg: HunyuanConfig, txt_len: int, grid: Tuple[int, int, int],
                          pad: int, order: str = "padded"):
    """(cos, sin) over ``[txt; clean (2 frames); 2x (1); 4x (4); window]`` for
    one FramePack section, the JAX ``framepack_rope_tables``.

    ``order="padded"`` (back to front): the timeline is [pre 1][blank pad]
    [window][post 1][2x 2][4x 16]; ``order="f1"`` (forward): [start 1][4x 16]
    [2x 2][1x 1][window], ``pad`` unused. A pyramid group takes its first
    timeline index and stride-scaled spatial coordinates."""
    if order not in ("padded", "f1"):
        raise ValueError(f"framepack order {order!r}: 'padded' or 'f1'")
    gt, gh, gw = grid

    def coords_for(times, hh, ww, stride):
        ys, xs = np.meshgrid(np.arange(hh) * stride, np.arange(ww) * stride, indexing="ij")
        return np.concatenate([np.stack([np.full(hh * ww, t), ys.reshape(-1),
                                         xs.reshape(-1)], axis=-1) for t in times], axis=0)

    if order == "f1":
        idx_clean, idx_2x = [0, 19], [17]
        idx_4x = list(range(1, 17, 4))
        idx_window = list(range(20, 20 + gt))
    else:
        idx_clean, idx_2x = [0, 1 + pad + gt], [1 + pad + gt + 1]
        idx_4x = list(range(1 + pad + gt + 3, 1 + pad + gt + 19, 4))
        idx_window = list(range(1 + pad, 1 + pad + gt))
    coords = np.concatenate([coords_for(idx_clean, gh, gw, 1),
                             coords_for(idx_2x, gh // 2, gw // 2, 2),
                             coords_for(idx_4x, gh // 4, gw // 4, 4),
                             coords_for(idx_window, gh, gw, 1)], axis=0)
    return _tables(cfg, txt_len, coords)


def _refiner_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attention()`` on the refiner's f32 ``[B, S, H, D]``: rounded to bf16
    for K1 on the card, f32 throughout on the CPU."""
    if q.is_cuda:
        return attention(*(t.to(torch.bfloat16) for t in (q, k, v))).float()
    return attention(q, k, v)


@torch.inference_mode()
def refine_text(model: HunyuanModel, txt_raw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The individual token refiner, f32 ``[B, L, hidden]``: self-attention
    blocks gated by ``c = t_embed(t) + c_embed(mean of the context)``, with
    ``t`` on the 0..1000 scale (the JAX ``_refine_text``)."""
    cfg, p = model.cfg, model.refiner
    c = p.t_embed(timestep_embedding(t, cfg.time_embed_dim))
    c = c + p.c_embed(txt_raw.float().mean(1))
    h = p.proj_in(txt_raw.float())
    b, s, _ = h.shape
    for blk in p.blocks:
        g1, g2 = blk.mod(F.silu(c))[:, None].chunk(2, dim=-1)
        q, k, v = blk.qkv(layer_norm(h, blk.norm1_w, blk.norm1_b)).chunk(3, dim=-1)
        a = _refiner_attention(*(x.reshape(b, s, cfg.heads, -1) for x in (q, k, v)))
        h = h + blk.proj(a.reshape(b, s, -1)) * g1
        hn = layer_norm(h, blk.norm2_w, blk.norm2_b)
        h = h + blk.mlp2(F.silu(blk.mlp1(hn))) * g2
    return h


def make_hunyuan_core(model: HunyuanModel, txt_len: int, grid: Tuple[int, int, int],
                      history_frames: int = 0, framepack_pad: Optional[int] = None,
                      framepack_order: str = "padded") -> DiTCore:
    """(prepare, trunk, head) for a static latent token grid ``(gt, gh, gw)``.

    cond = {"txt": f[B, txt_len, text_dim] (LLM states), "vec": f[B, vec_dim]
            (CLIP pooled), "guidance": f[B],
            "history": f[B, history_frames, H, W, C] (flat history),
            "clean": f[B, 2, H, W, C], "clean_2x": f[B, 2, H, W, C],
            "clean_4x": f[B, 16, H, W, C] (a FramePack section)}
    x    = latents f[B, gt, 2 gh, 2 gw, C] channel-last
    t    = timesteps on the 0..1000 scale, f32[B]

    ``history_frames``: prior clean latents ride the image stream at the
    preceding temporal rope positions. ``framepack_pad`` (a model with
    ``cfg.framepack``): FramePack's clean-latent pyramid, at the rope
    positions of ``framepack_rope_tables(pad, framepack_order)``.
    """
    cfg = model.cfg
    gt, gh, gw = grid
    if framepack_pad is not None:
        if not cfg.framepack:
            raise ValueError("framepack_pad needs a model built with framepack=True "
                             "(the clean-latent projections)")
        rope = framepack_rope_tables(cfg, txt_len, grid, framepack_pad, framepack_order)
    else:
        rope = hunyuan_rope_tables(cfg, txt_len, (gt + history_frames, gh, gw))
    mmdit = make_flux_core(model.mmdit, txt_len, gh, gw, rope_tables=rope, grid_t=gt)
    cur_tokens = gt * gh * gw

    @torch.inference_mode()
    def prepare(x, t, cond):
        tokens = patchify_video(cfg, x)
        flux_cond = {"txt": refine_text(model, cond["txt"], t), "vec": cond["vec"]}
        if cfg.guidance_embed and "guidance" in cond:
            flux_cond["guidance"] = cond["guidance"]
        if framepack_pad is not None:
            flux_cond["img_pre_tokens"] = [
                model.clean_proj(patchify_video(cfg, cond["clean"].float())),
                model.clean_proj_2x(patchify_k(cond["clean_2x"].float(), 2, 4, 4)),
                model.clean_proj_4x(patchify_k(cond["clean_4x"].float(), 4, 8, 8))]
        elif history_frames:
            tokens = torch.cat([patchify_video(cfg, cond["history"].to(x.dtype)), tokens],
                               dim=1)
        return mmdit.prepare(tokens, t, flux_cond)

    @torch.inference_mode()
    def head(img, ctx):
        # the current window only; LayerNorm and the linear act per token
        out = mmdit.head(img[:, -cur_tokens:], ctx)
        return unpatchify_video(cfg, out, grid)

    return DiTCore(prepare, mmdit.trunk, head)
