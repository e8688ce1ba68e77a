"""FLUX.1 image DiT (double-stream MMDiT + single-stream blocks), as PyTorch
modules.

Same model as ``magcache_tpu.models.flux`` (FLUX.1-dev and FLUX.1-Kontext,
the reference adapters ``MagCache4FLUX/magcache_flux.py`` and
``MagCache4FLUX_Kontext``):

- ``depth_double`` joint text/image blocks (separate streams and weights,
  joint attention), then ``depth_single`` fused blocks over the
  concatenated ``[txt; img]`` sequence;
- AdaLN modulation from ``vec = time_emb + guidance_emb + pooled_text_emb``;
- per-head q/k RMSNorm and 3-axis RoPE over (index, y, x) ids, fused into
  K2 in head scope, reading q and k in place from the fused projections;
- joint attention through K1 with the static softmax shift;
- every ``layer_norm(x) * (1 + scale) + shift`` site through K3 ``mod``,
  whose rounding points are the composition's.

Dtypes: in a bf16 config the image/text input projections and the block
linears (modulation included) are bf16; ``time_in``, ``vector_in``,
``guidance_in``, ``final_mod`` and ``final_out`` stay f32. ``_mod`` casts
the f32 ``vec`` to the weight dtype before the silu, as the JAX model does.
PyTorch does not promote mixed-dtype products, so the head upcasts its bf16
input to f32 explicitly where JAX promotes.

The timestep: ``prepare`` takes the sampler's timestep on the scheduler's
0..1000 scale (``sigma * 1000``) and embeds it as it is, as the published
diffusers transformer does (it is handed ``t / 1000`` and multiplies by
1000). ``magcache_tpu.models.flux`` multiplies the pipeline's ``sigma *
1000`` by 1000 again; the port does not carry that over (ROADMAP §3).
Guidance is embedded as ``guidance * 1000``.

The MagCache boundary is the image stream: ``trunk`` takes and returns the
image tokens (with Kontext, the conditioning tokens after them; with
``img_pre_tokens``, FramePack's clean-latent tokens ahead of them); the text
tokens ride through the double blocks inside it. A video MMDiT
(``models/hunyuan.py``) passes its own 3-D ``[txt; img]`` rope tables and
its grid's frame count. Qwen-Image (``models/qwen_image.py``) runs double
blocks only (``depth_single = 0``) and conditions without a pooled vector:
``vec`` is then the time embedding alone.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import (DTYPES, MLPEmbedder, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, attention
from magcache_tpu_torch.ops.fused_prologue import layer_norm_mod, rms_norm_rope
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d

__all__ = ["FluxConfig", "FluxModel", "make_flux_core", "flux_rope_tables",
           "flux_img_rope_block", "first_block_modulated", "pack_latents",
           "unpack_latents", "FLUX_DEV"]

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64            # 16 latent channels x 2x2 patch pack
    hidden: int = 3072
    heads: int = 24
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: int = 4
    text_dim: int = 4096             # T5-XXL states
    vec_dim: int = 768               # CLIP pooled
    axes_dims: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    guidance_embed: bool = True
    time_embed_dim: int = 256
    dtype: str = "float32"           # trunk compute/storage dtype

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_ratio * self.hidden

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "FluxConfig":
        """A test-size config (the JAX package's ``FluxConfig.tiny``)."""
        defaults = dict(in_channels=16, hidden=128, heads=4, depth_double=2,
                        depth_single=2, text_dim=32, vec_dim=16,
                        axes_dims=(8, 12, 12), time_embed_dim=32)
        defaults.update(kw)
        return FluxConfig(**defaults)


# FLUX.1-dev and FLUX.1-Kontext-dev (12 B parameters)
FLUX_DEV = FluxConfig()


def flux_img_rope_block(cfg: FluxConfig, grid_h: int, grid_w: int,
                        t_pos: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 ``[grid_h*grid_w, head_dim/2]`` for one image's
    tokens at index-axis id ``t_pos`` (Kontext's conditioning image is 1)."""
    img_len = grid_h * grid_w
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    cos_parts, sin_parts = [], []
    axis_pos = [np.full(img_len, t_pos), ys.reshape(-1), xs.reshape(-1)]
    for dim_a, pos in zip(cfg.axes_dims, axis_pos):
        c, s = rope_freqs_1d(pos, dim_a, cfg.theta)
        cos_parts.append(c)
        sin_parts.append(s)
    return np.concatenate(cos_parts, -1), np.concatenate(sin_parts, -1)


def flux_rope_tables(cfg: FluxConfig, txt_len: int, grid_h: int, grid_w: int,
                     kontext: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) over the ``[txt; img(; kontext)]`` sequence: text ids are
    all zero (the identity rotation), image ids are (0, y, x) over the packed
    latent grid, and with ``kontext`` a second image block at (1, y, x)."""
    if sum(cfg.axes_dims) != cfg.head_dim:
        raise ValueError(f"axes_dims {cfg.axes_dims} must sum to the head dim "
                         f"{cfg.head_dim}")
    img_cos, img_sin = flux_img_rope_block(cfg, grid_h, grid_w, 0)
    cos = [np.ones((txt_len, cfg.head_dim // 2), np.float32), img_cos]
    sin = [np.zeros((txt_len, cfg.head_dim // 2), np.float32), img_sin]
    if kontext:
        kc, ks = flux_img_rope_block(cfg, grid_h, grid_w, 1)
        cos.append(kc)
        sin.append(ks)
    return np.concatenate(cos, 0), np.concatenate(sin, 0)


def _mod(vec: torch.Tensor, layer: nn.Linear, n: int) -> List[torch.Tensor]:
    """silu(vec in the weight dtype) -> linear -> n f32 chunks ``[B, 1, D]``."""
    out = layer(F.silu(vec.to(layer.weight.dtype)))
    return list(out[:, None, :].float().chunk(n, dim=-1))


def _gated(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x + gate * y``: the f32 gate product rounded to x's dtype first."""
    return x + (gate * y.float()).to(x.dtype)


def _qk_norm_rope(qkv: torch.Tensor, gains: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, heads: int, width: int):
    """q and k, per-head RMS-normed and rotated (K2 head scope), read in
    place from the first ``2 * width`` columns of a fused projection."""
    return tuple(rms_norm_rope(qkv[..., i * width:(i + 1) * width], gains[i],
                               cos, sin, heads, eps=_EPS, norm_scope="head")
                 for i in (0, 1))


def _ones(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, dtype=torch.float32, device=device))


class FluxDoubleBlock(nn.Module):
    """A joint text/image block; parameter names follow the JAX pytree."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", lin(d, 6 * d))
            setattr(self, f"{s}_qkv", lin(d, 3 * d))
            setattr(self, f"{s}_qk_scale", _ones((2, cfg.head_dim), device))
            setattr(self, f"{s}_proj", lin(d, d))
            setattr(self, f"{s}_mlp1", lin(d, cfg.mlp_dim))
            setattr(self, f"{s}_mlp2", lin(cfg.mlp_dim, d))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
                rope_txt, rope_img) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        heads, d = cfg.heads, cfg.hidden
        b, txt_len = txt.shape[:2]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(vec, self.img_mod, 6)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(vec, self.txt_mod, 6)

        # joint attention over [txt; img], each stream normed and rotated
        # with its slice of the rope table
        iqkv = self.img_qkv(layer_norm_mod(img, scale=i_sc1, shift=i_sh1, eps=_EPS))
        tqkv = self.txt_qkv(layer_norm_mod(txt, scale=t_sc1, shift=t_sh1, eps=_EPS))
        iq, ik = _qk_norm_rope(iqkv, self.img_qk_scale, *rope_img, heads, d)
        tq, tk = _qk_norm_rope(tqkv, self.txt_qk_scale, *rope_txt, heads, d)
        q = torch.cat([tq, iq], dim=1)
        k = torch.cat([tk, ik], dim=1)
        v = torch.cat([tqkv[..., 2 * d:], iqkv[..., 2 * d:]], dim=1)
        o = attention(q, k, v.reshape(q.shape), fixed_max=QKNORM_FIXED_MAX)
        o = o.reshape(b, -1, d)
        img = _gated(img, i_g1, self.img_proj(o[:, txt_len:]))
        txt = _gated(txt, t_g1, self.txt_proj(o[:, :txt_len]))

        img_m = layer_norm_mod(img, scale=i_sc2, shift=i_sh2, eps=_EPS)
        img = _gated(img, i_g2, self.img_mlp2(
            F.gelu(self.img_mlp1(img_m), approximate="tanh")))
        txt_m = layer_norm_mod(txt, scale=t_sc2, shift=t_sh2, eps=_EPS)
        txt = _gated(txt, t_g2, self.txt_mlp2(
            F.gelu(self.txt_mlp1(txt_m), approximate="tanh")))
        return img, txt


class FluxSingleBlock(nn.Module):
    """A fused block over ``[txt; img]``: one projection to q|k|v|mlp, one
    projection back from attention|gelu(mlp)."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.torch_dtype
        self.mod = nn.Linear(d, 3 * d, device=device, dtype=dt)
        self.lin1 = nn.Linear(d, 3 * d + cfg.mlp_dim, device=device, dtype=dt)
        self.qk_scale = _ones((2, cfg.head_dim), device)
        self.lin2 = nn.Linear(d + cfg.mlp_dim, d, device=device, dtype=dt)

    def forward(self, h: torch.Tensor, vec: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        heads, d = cfg.heads, cfg.hidden
        b, s, _ = h.shape
        shift, scale, gate = _mod(vec, self.mod, 3)
        proj = self.lin1(layer_norm_mod(h, scale=scale, shift=shift, eps=_EPS))
        q, k = _qk_norm_rope(proj, self.qk_scale, cos, sin, heads, d)
        v = proj[..., 2 * d:3 * d].reshape(b, s, heads, -1).contiguous()
        o = attention(q, k, v, fixed_max=QKNORM_FIXED_MAX).reshape(b, s, d)
        mlp = F.gelu(proj[..., 3 * d:], approximate="tanh")
        return _gated(h, gate, self.lin2(torch.cat([o, mlp], dim=-1)))


class FluxModel(nn.Module):
    """FLUX.1 DiT. Build on ``device``, then ``init(generator)`` for random
    weights or ``load_state_dict`` (see ``models/convert.py``)."""

    def __init__(self, cfg: FluxConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, f32 = cfg.hidden, cfg.torch_dtype, torch.float32
        self.img_in = nn.Linear(cfg.in_channels, d, device=device, dtype=dt)
        self.txt_in = nn.Linear(cfg.text_dim, d, device=device, dtype=dt)
        self.time_in = MLPEmbedder(cfg.time_embed_dim, d, device)
        self.vector_in = MLPEmbedder(cfg.vec_dim, d, device)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(cfg.time_embed_dim, d, device)
        self.double_blocks = nn.ModuleList(FluxDoubleBlock(cfg, device)
                                    for _ in range(cfg.depth_double))
        self.single_blocks = nn.ModuleList(FluxSingleBlock(cfg, device)
                                    for _ in range(cfg.depth_single))
        self.final_mod = nn.Linear(d, 2 * d, device=device, dtype=f32)
        self.final_out = nn.Linear(d, cfg.in_channels, device=device, dtype=f32)

    def init(self, generator: torch.Generator) -> "FluxModel":
        """Random weights from ``generator`` (on its device): LeCun-normal
        linears with zero bias and unit q/k gains, as
        ``magcache_tpu.models.flux.init_flux_params`` draws them (the draws
        themselves differ)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def first_block_modulated(model: FluxModel, img: torch.Tensor, ctx: dict) -> torch.Tensor:
    """TeaCache's signal for a FLUX-family trunk (FLUX, HunyuanVideo,
    FramePack): the first double block's AdaLN-modulated image-stream input,
    ``layer_norm(img) * (1 + scale1) + shift1`` in f32, the signal the
    published FramePack rescale polynomial was fitted to (the JAX
    ``first_block_modulated``; plain ops there and here)."""
    shift1, scale1 = _mod(ctx["vec"], model.double_blocks[0].img_mod, 6)[:2]
    return layer_norm(img, eps=_EPS).float() * (1 + scale1) + shift1


def make_flux_core(model: FluxModel, txt_len: int, grid_h: int, grid_w: int,
                   kontext: bool = False, rope_tables=None, grid_t: int = 1) -> DiTCore:
    """(prepare, trunk, head) for a static text length and packed grid.

    cond = {"txt": f[B, txt_len, text_dim], "vec": f[B, vec_dim] (optional:
            Qwen-Image has none), "guidance": f[B] (optional), "kontext": f[B, img_len, in_ch]
            (with ``kontext``: the conditioning image's packed latents),
            "img_pre_tokens": [f[B, n_i, hidden], ...] (optional: already
            embedded tokens that join the image stream ahead of x's)}
    x    = packed latent patches f[B, img_len, in_channels], ``img_len =
           grid_t * grid_h * grid_w``
    t    = timesteps on the 0..1000 scale, f32[B]

    ``rope_tables`` (numpy ``(cos, sin)`` over the whole ``[txt; img]``
    sequence, pre tokens included) replaces FLUX's 2-D tables: a video
    MMDiT passes its 3-D ones. The head keeps every image-stream token but
    Kontext's conditioning ones; the pre tokens are its caller's to drop.
    """
    cfg = model.cfg
    device = model.img_in.weight.device
    cos_np, sin_np = (rope_tables if rope_tables is not None else
                      flux_rope_tables(cfg, txt_len, grid_h, grid_w, kontext=kontext))
    cos, sin = torch.from_numpy(cos_np).to(device), torch.from_numpy(sin_np).to(device)
    rope_txt = (cos[:txt_len], sin[:txt_len])
    rope_img = (cos[txt_len:], sin[txt_len:])
    img_len = grid_t * grid_h * grid_w

    @torch.inference_mode()
    def prepare(x, t, cond):
        dt = cfg.torch_dtype
        img = model.img_in(x.to(dt))
        if kontext:
            # the conditioning image's tokens follow the noise tokens, share
            # img_in and the trunk, and ride in the cached residual
            img = torch.cat([img, model.img_in(cond["kontext"].to(dt))], dim=1)
        if "img_pre_tokens" in cond:
            # FramePack's clean-latent tokens, embedded by the caller, join
            # the image stream ahead of the noise window
            img = torch.cat([p.to(dt) for p in cond["img_pre_tokens"]] + [img], dim=1)
        txt = model.txt_in(cond["txt"].to(dt))
        # f32 modulation vector: timestep (already x1000) + guidance + pooled
        vec = model.time_in(timestep_embedding(t, cfg.time_embed_dim))
        if cfg.guidance_embed and "guidance" in cond:
            vec = vec + model.guidance_in(timestep_embedding(
                cond["guidance"].float() * 1000.0, cfg.time_embed_dim))
        if "vec" in cond:    # Qwen-Image has no pooled text vector
            vec = vec + model.vector_in(cond["vec"].float())
        return img, {"txt": txt, "vec": vec}

    @torch.inference_mode()
    def trunk(img, ctx):
        txt, vec = ctx["txt"], ctx["vec"]
        for blk in model.double_blocks:
            img, txt = blk(img, txt, vec, rope_txt, rope_img)
        if not model.single_blocks:
            return img       # double blocks only (Qwen-Image): no concat, no copy
        h = torch.cat([txt, img], dim=1)
        for blk in model.single_blocks:
            h = blk(h, vec, cos, sin)
        return h[:, txt.shape[1]:]   # image tokens only: the cacheable stream

    @torch.inference_mode()
    def head(img, ctx):
        if kontext:
            img = img[:, :img_len]   # drop the conditioning tokens
        shift, scale = _mod(ctx["vec"], model.final_mod, 2)
        h = layer_norm_mod(img.contiguous(), scale=scale, shift=shift, eps=_EPS)
        # the f32 head weight promotes the bf16 activations in JAX
        return model.final_out(h.float())

    return DiTCore(prepare, trunk, head)


def pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/2)*(W/2), C*4] (FLUX 2x2 patch packing)."""
    b, h, w, c = lat.shape
    lat = lat.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return lat.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(x: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """Inverse of ``pack_latents``."""
    b, _, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, grid_h, grid_w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * 2, grid_w * 2, c)
