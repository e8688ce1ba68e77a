"""Wan 2.1 video DiT (t2v), as PyTorch modules.

Same model as ``magcache_tpu.models.wan``:

- 3D patch embedding, patch (1, 2, 2) over (F, H, W) latents, as
  reshape + linear;
- f32 time path: sinusoidal(freq_dim) -> MLP -> e, then the 6-way
  projection e0;
- per-block learned modulation table added to e0 (shift/scale/gate for
  self-attention and FFN), kept in f32;
- self-attention with token-scope q/k RMSNorm and 3D RoPE (head dim split
  t/h/w = (d - 4*d6, 2*d6, 2*d6), d6 = d // 6), full attention;
- cross-attention to the padded text context, no masking;
- head: LayerNorm + 2-way modulation from the unprojected e, linear to patch
  voxels, unpatchify.

Dtypes: in a bf16 config only ``patch_embedding`` and the block linears are
bf16; the text/time embeddings, time projection, modulation tables, norm
gains and the head stay f32. PyTorch does not promote mixed-dtype products,
so every point where JAX promotes bf16 to f32 upcasts explicitly.

The MagCache boundary is the whole block stack: ``make_wan_core`` splits the
model into ``prepare`` / ``trunk`` / ``head``. Only t2v is ported; i2v, VACE
and ti2v raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import init_linear_, timestep_embedding
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, attention
from magcache_tpu_torch.ops.fused_prologue import layer_norm_mod, rms_norm_rope
from magcache_tpu_torch.ops.norms import layer_norm, rms_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d

__all__ = ["WanConfig", "WanModel", "make_wan_core", "wan_rope_tables",
           "patchify", "unpatchify", "WAN_1_3B"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class WanConfig:
    dim: int = 1536
    ffn_dim: int = 8960
    heads: int = 12
    layers: int = 30
    freq_dim: int = 256
    text_dim: int = 4096
    text_len: int = 512
    in_channels: int = 16
    out_channels: int = 16
    patch: Tuple[int, int, int] = (1, 2, 2)
    eps: float = 1e-6
    model_type: str = "t2v"
    vace_layers: Tuple[int, ...] = ()
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def patch_in(self) -> int:
        pt, ph, pw = self.patch
        return self.in_channels * pt * ph * pw

    @property
    def patch_out(self) -> int:
        pt, ph, pw = self.patch
        return self.out_channels * pt * ph * pw

    @staticmethod
    def tiny(**kw) -> "WanConfig":
        defaults = dict(dim=96, ffn_dim=192, heads=4, layers=2, freq_dim=32,
                        text_dim=24, text_len=16)
        defaults.update(kw)
        return WanConfig(**defaults)


# Published Wan2.1 sizes
WAN_1_3B = WanConfig(dim=1536, ffn_dim=8960, heads=12, layers=30)


def wan_rope_tables(cfg: WanConfig, grid: Tuple[int, int, int]):
    """(cos, sin) f32 numpy ``[F*H*W, head_dim/2]`` over the flattened patch
    grid, head dim split (t, h, w) = (d - 4*d6, 2*d6, 2*d6), d6 = d // 6."""
    d = cfg.head_dim
    d6 = d // 6
    dims = (d - 4 * d6, 2 * d6, 2 * d6)
    f, h, w = grid
    coords = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                                  indexing="ij"), -1).reshape(-1, 3)
    cos_p, sin_p = [], []
    for ax, dim_a in enumerate(dims):
        c, s = rope_freqs_1d(coords[:, ax], dim_a, 10000.0)
        cos_p.append(c)
        sin_p.append(s)
    return np.concatenate(cos_p, -1), np.concatenate(sin_p, -1)


def patchify(cfg: WanConfig, lat: torch.Tensor) -> torch.Tensor:
    """[B, F, H, W, C] -> [B, (F/pt)(H/ph)(W/pw), C*pt*ph*pw]."""
    b, f, h, w, c = lat.shape
    pt, ph, pw = cfg.patch
    lat = lat.reshape(b, f // pt, pt, h // ph, ph, w // pw, pw, c)
    lat = lat.permute(0, 1, 3, 5, 7, 2, 4, 6)
    return lat.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(cfg: WanConfig, x: torch.Tensor,
               grid: Tuple[int, int, int]) -> torch.Tensor:
    b = x.shape[0]
    gf, gh, gw = grid
    pt, ph, pw = cfg.patch
    c = cfg.out_channels
    x = x.reshape(b, gf, gh, gw, c, pt, ph, pw)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, gf * pt, gh * ph, gw * pw, c)


def _param(shape, device, fill: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32, device=device))


class WanBlock(nn.Module):
    """One WanAttentionBlock; parameter names follow the JAX pytree keys."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.modulation = _param((6, d), device, 0.0)
        self.q, self.k, self.v, self.o = lin(d, d), lin(d, d), lin(d, d), lin(d, d)
        self.norm_q = _param((d,), device, 1.0)
        self.norm_k = _param((d,), device, 1.0)
        self.cross_q, self.cross_k = lin(d, d), lin(d, d)
        self.cross_v, self.cross_o = lin(d, d), lin(d, d)
        self.cross_norm_q = _param((d,), device, 1.0)
        self.cross_norm_k = _param((d,), device, 1.0)
        self.norm3_w = _param((d,), device, 1.0)
        self.norm3_b = _param((d,), device, 0.0)
        self.ffn1, self.ffn2 = lin(d, cfg.ffn_dim), lin(cfg.ffn_dim, d)

    def forward(self, x: torch.Tensor, e0: torch.Tensor, context: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        heads, eps = cfg.heads, cfg.eps
        # per-block modulation table added in f32: [B, 6, D]
        e = (self.modulation + e0).float()
        mods = [e[:, i:i + 1] for i in range(6)]

        def gate(x, y, i):
            return x + (y.float() * mods[i]).to(x.dtype)

        # self-attention
        xn = layer_norm_mod(x, scale=mods[1], shift=mods[0], eps=eps)
        q = rms_norm_rope(self.q(xn), self.norm_q, cos, sin, heads, eps=eps)
        k = rms_norm_rope(self.k(xn), self.norm_k, cos, sin, heads, eps=eps)
        v = self.v(xn).reshape(b, s, heads, -1)
        a = attention(q, k, v, fixed_max=QKNORM_FIXED_MAX).reshape(x.shape)
        x = gate(x, self.o(a), 2)

        # cross-attention to the text context (residual in the activation dtype)
        xc = layer_norm_mod(x, weight=self.norm3_w, bias=self.norm3_b, eps=eps)
        sc = context.shape[1]
        cq = rms_norm(self.cross_q(xc), self.cross_norm_q, eps=eps).reshape(b, s, heads, -1)
        ck = rms_norm(self.cross_k(context), self.cross_norm_k, eps=eps).reshape(b, sc, heads, -1)
        cv = self.cross_v(context).reshape(b, sc, heads, -1)
        ca = attention(cq, ck, cv, fixed_max=QKNORM_FIXED_MAX).reshape(x.shape)
        x = x + self.cross_o(ca)

        # FFN, tanh-gelu
        xm = layer_norm_mod(x, scale=mods[4], shift=mods[3], eps=eps)
        y = self.ffn2(F.gelu(self.ffn1(xm), approximate="tanh"))
        return gate(x, y, 5)


class WanHead(nn.Module):
    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.modulation = _param((2, cfg.dim), device, 0.0)
        self.out = nn.Linear(cfg.dim, cfg.patch_out, device=device,
                             dtype=torch.float32)


class WanModel(nn.Module):
    """Wan2.1 t2v DiT. Build on ``device``, then ``init(generator)`` for
    random weights or ``load_state_dict`` (see ``models/convert.py``)."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        if cfg.model_type != "t2v" or cfg.vace_layers:
            raise NotImplementedError(
                f"Wan {cfg.model_type!r}{' + VACE' if cfg.vace_layers else ''}"
                " is not ported yet; only t2v is")
        self.cfg = cfg
        d = cfg.dim
        f32 = torch.float32

        def lin(d_in, d_out, dtype=f32):
            return nn.Linear(d_in, d_out, device=device, dtype=dtype)

        self.patch_embedding = lin(cfg.patch_in, d, cfg.torch_dtype)
        self.text_embedding = nn.ModuleDict({"in": lin(cfg.text_dim, d),
                                             "out": lin(d, d)})
        self.time_embedding = nn.ModuleDict({"in": lin(cfg.freq_dim, d),
                                             "out": lin(d, d)})
        self.time_projection = lin(d, 6 * d)
        self.blocks = nn.ModuleList(WanBlock(cfg, device) for _ in range(cfg.layers))
        self.head = WanHead(cfg, device)

    def init(self, generator: torch.Generator) -> "WanModel":
        """Random weights from ``generator`` (on its device): LeCun-normal
        linears with zero bias, modulation tables ``N(0, 1/dim)``, unit norm
        gains and zero norm bias, as ``magcache_tpu.models.wan.init_wan_params``
        draws them (the draws themselves differ)."""
        d = self.cfg.dim
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for m in (*self.blocks, self.head):
                m.modulation.copy_(torch.randn(
                    m.modulation.shape, generator=generator,
                    device=generator.device) / math.sqrt(d))
        return self


def make_wan_core(model: WanModel, grid: Tuple[int, int, int]) -> DiTCore:
    """(prepare, trunk, head) for a static latent patch grid (F, H, W).

    cond = {"context": f[B, text_len, text_dim]}
    x    = latent video f[B, F*pt, H*ph, W*pw, C] (channel-last)
    """
    cfg = model.cfg
    device = model.patch_embedding.weight.device
    cos_np, sin_np = wan_rope_tables(cfg, grid)
    cos = torch.from_numpy(cos_np).to(device)
    sin = torch.from_numpy(sin_np).to(device)

    @torch.inference_mode()
    def prepare(x, t, cond):
        dt = cfg.torch_dtype
        hidden = model.patch_embedding(patchify(cfg, x.to(dt)))
        te = model.time_embedding
        e = te["out"](F.silu(te["in"](timestep_embedding(t, cfg.freq_dim))))
        e0 = model.time_projection(F.silu(e)).reshape(e.shape[0], 6, cfg.dim)
        tx = model.text_embedding
        ctx = F.gelu(tx["in"](cond["context"].float()), approximate="tanh")
        ctx = tx["out"](ctx).to(dt)
        return hidden, {"e": e, "e0": e0, "context": ctx}

    @torch.inference_mode()
    def trunk(hidden, ctx):
        x = hidden
        for blk in model.blocks:
            x = blk(x, ctx["e0"], ctx["context"], cos, sin)
        return x

    @torch.inference_mode()
    def head(hidden, ctx):
        hp = model.head
        mod = hp.modulation[None] + ctx["e"][:, None, :]
        shift, scale = mod[:, 0:1], mod[:, 1:2]
        # bf16 LayerNorm output times f32 modulation promotes to f32 in JAX
        h = layer_norm(hidden, eps=cfg.eps).float() * (1 + scale) + shift
        # round to the activation dtype, then the f32 head weight promotes
        out = hp.out(h.to(hidden.dtype).float())
        return unpatchify(cfg, out, grid)

    return DiTCore(prepare, trunk, head)
