"""OmniGen2 decoder DiT, as PyTorch modules.

Same model as ``magcache_tpu.models.omnigen2`` (the reference adapter
``MagCache4OmniGen2``): a Lumina2-lineage single-stream transformer at
hidden 2,520 with grouped-query attention (21 query heads over 7 kv heads
of 120) and SwiGLU feed-forwards:

1. the timestep MLP gives ``temb``; the caption states are RMS-normed
   (``cap_norm``, f32) and projected to the hidden width;
2. ``context_refiner``: text-only blocks over sequential rope ids, without
   modulation;
3. ``noise_refiner`` / ``ref_refiner``: image-only blocks with ``temb``
   modulation on the patch-embedded noise and reference tokens;
4. ``layers``: the 32 joint blocks over ``[text; refs; noise]`` with a
   3-axis rope (sequence id, y, x): the trunk MagCache elides;
5. the head: an affine-free LayerNorm times ``1 + scale(temb)`` on the noise
   tokens, the f32 projection and the ``(h w)(p1 p2 c)`` unpatchify.

Block (``_run_blocks``): sandwich RMSNorm with tanh-gated
``LuminaRMSNormZero`` modulation,

    x = x + tanh(g_msa) * norm2(attn(norm1(x) * (1 + s_msa)))
    x = x + tanh(g_mlp) * ffn_norm2(swiglu(ffn_norm1(x) * (1 + s_mlp)))

with both products taken in f32 and rounded to the stream's dtype, as the
JAX block rounds them. q/k get a per-head RMS norm and the interleaved-pair
rope as the plain composition (``rms_norm_rope_plain``, head scope): the
JAX ``rms_norm_rope`` lowers its unfused composition at head dim 120 (no
Pallas kernel there), and the port's K2 takes head dim 128 only. The kv
heads repeat to the query heads as ``jnp.repeat`` does (k0, k0, k0, k1,
...: ``repeat_interleave``). Attention is ``attention()`` with the fixed
softmax shift: above 128 tokens K1, zero-padded from 120 to 128 on the card
with the softmax scale of 120; the context refiner's sequence of at most
128 text tokens takes ``attention()``'s einsum path, as the JAX dispatcher
does at that length.

Dtypes: in a bf16 config the block linears (``q``, ``kv``, ``o``,
``w1``-``w3``), ``cap_proj``, ``x_embed`` and ``ref_embed`` are bf16; the
modulations (``mod``), ``t_embed``, ``norm_out_mod``, ``final_out`` and
every norm gain stay f32. Where JAX promotes an f32 operand against a bf16
weight (``cap_proj`` on the f32 normed caption, ``final_out`` on the bf16
head input) the port computes in f32 explicitly.
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
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, attention
from magcache_tpu_torch.ops.fused_prologue import rms_norm_rope_plain
from magcache_tpu_torch.ops.norms import layer_norm, rms_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d

__all__ = ["OmniGen2Config", "OmniGen2Model", "OMNIGEN2", "make_omnigen2_core",
           "omnigen2_rope_tables", "make_teacache_signal", "patchify", "unpatchify",
           "repeat_kv"]


@dataclasses.dataclass(frozen=True)
class OmniGen2Config:
    hidden: int = 2520
    heads: int = 21
    kv_heads: int = 7                  # grouped-query attention
    layers: int = 32
    refiner_layers: int = 2            # context + noise + ref refiners
    ffn_mult: float = 8 / 3            # SwiGLU inner = mult * hidden (rounded)
    in_channels: int = 16
    text_dim: int = 2304               # Qwen2.5-VL-3B hidden states
    patch: int = 2
    axes_dims: Tuple[int, int, int] = (40, 40, 40)  # (seq-id, y, x) rope
    time_embed_dim: int = 256
    temb_dim: int = 1024               # modulation width
    eps: float = 1e-5
    dtype: str = "float32"
    # exact SwiGLU inner width when known; overrides the ffn_mult rounding
    ffn_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def ffn_dim(self) -> int:
        if self.ffn_dim_override is not None:
            return self.ffn_dim_override
        # Llama-style rounding up to a multiple of 256
        d = int(self.hidden * self.ffn_mult)
        return ((d + 255) // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def patch_in(self) -> int:
        return self.in_channels * self.patch * self.patch

    @staticmethod
    def tiny(**kw) -> "OmniGen2Config":
        """A test-size config (the JAX package's ``OmniGen2Config.tiny``)."""
        defaults = dict(hidden=96, heads=4, kv_heads=2, layers=2, refiner_layers=1,
                        text_dim=24, axes_dims=(8, 8, 8), time_embed_dim=32, temb_dim=48)
        defaults.update(kw)
        return OmniGen2Config(**defaults)


# OmniGen2 at the JAX defaults' width: 3.012 B parameters
OMNIGEN2 = OmniGen2Config()


class OmniGen2Block(nn.Module):
    """One block; names follow the JAX pytree (``mod`` only when modulated)."""

    def __init__(self, cfg: OmniGen2Config, modulated: bool, device=None):
        super().__init__()
        d, dk, dt = cfg.hidden, cfg.kv_heads * cfg.head_dim, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dt)

        self.q, self.kv, self.o = lin(d, d), lin(d, 2 * dk), lin(d, d)
        self.w1, self.w3, self.w2 = lin(d, cfg.ffn_dim), lin(d, cfg.ffn_dim), lin(cfg.ffn_dim, d)
        for n, width in (("q_norm", cfg.head_dim), ("k_norm", cfg.head_dim), ("norm1", d),
                         ("norm2", d), ("ffn_norm1", d), ("ffn_norm2", d)):
            setattr(self, n, nn.Parameter(torch.ones(width, device=device)))
        if modulated:
            self.mod = nn.Linear(cfg.temb_dim, 4 * d, device=device, dtype=torch.float32)


class OmniGen2Model(nn.Module):
    """The OmniGen2 DiT. Build on ``device``, then ``init(generator)`` or
    ``load_state_dict`` (``models/convert.py::omnigen2_params_from_numpy``)."""

    def __init__(self, cfg: OmniGen2Config, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, f32 = cfg.hidden, cfg.torch_dtype, torch.float32
        self.t_embed = MLPEmbedder(cfg.time_embed_dim, cfg.temb_dim, device)
        self.cap_norm = nn.Parameter(torch.ones(cfg.text_dim, device=device))
        self.cap_proj = nn.Linear(cfg.text_dim, d, device=device, dtype=dt)
        self.x_embed = nn.Linear(cfg.patch_in, d, device=device, dtype=dt)
        self.ref_embed = nn.Linear(cfg.patch_in, d, device=device, dtype=dt)
        for name, modulated, depth in (("context_refiner", False, cfg.refiner_layers),
                                       ("noise_refiner", True, cfg.refiner_layers),
                                       ("ref_refiner", True, cfg.refiner_layers),
                                       ("layers", True, cfg.layers)):
            setattr(self, name, nn.ModuleList(OmniGen2Block(cfg, modulated, device)
                                              for _ in range(depth)))
        self.norm_out_mod = nn.Linear(cfg.temb_dim, d, device=device, dtype=f32)
        self.final_out = nn.Linear(d, cfg.patch_in, device=device, dtype=f32)

    def init(self, generator: torch.Generator) -> "OmniGen2Model":
        """Random weights from ``generator``: LeCun-normal linears with zero
        bias and unit gains, as ``init_omnigen2_params`` draws them (the
        draws themselves differ)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def omnigen2_rope_tables(cfg: OmniGen2Config, txt_len: int, grid: Tuple[int, int],
                         ref_images: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) f32 ``[txt_len + (R + 1) * gh * gw, head_dim / 2]`` over
    ``[text; ref_0 ..; noise]``: text ids (i, 0, 0) for i < txt_len; image k
    (the references first, then the noise) takes the sequence id
    ``txt_len + k`` and its (y, x) grid; each axis rotates its own channel
    segment (``axes_dims``)."""
    gh, gw = grid
    rows = [np.stack([np.arange(txt_len), np.zeros(txt_len), np.zeros(txt_len)], axis=-1)]
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    for k in range(ref_images + 1):
        sid = np.full(gh * gw, txt_len + k)
        rows.append(np.stack([sid, ys.reshape(-1), xs.reshape(-1)], axis=-1))
    coords = np.concatenate(rows, axis=0)
    parts = [rope_freqs_1d(coords[:, ax], dim) for ax, dim in enumerate(cfg.axes_dims)]
    return (np.concatenate([p[0] for p in parts], -1),
            np.concatenate([p[1] for p in parts], -1))


def _modulation(blk: OmniGen2Block, temb: torch.Tensor, d: int):
    """``(s_msa, g_msa, s_mlp, g_mlp)``, each f32 ``[B, 1, d]``:
    ``LuminaRMSNormZero``'s projection of ``silu(temb)``."""
    mod = blk.mod(F.silu(temb)).float()
    return tuple(mod[:, None, i * d:(i + 1) * d] for i in range(4))


def _scaled(n: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
    return n if s is None else (n.float() * (1 + s)).to(n.dtype)


def _gated(a: torch.Tensor, g: Optional[torch.Tensor]) -> torch.Tensor:
    return a if g is None else (torch.tanh(g) * a.float()).to(a.dtype)


def repeat_kv(t: torch.Tensor, rep: int) -> torch.Tensor:
    """``[B, S, Hk, D] -> [B, S, Hk * rep, D]`` as ``jnp.repeat(t, rep,
    axis=2)``: kv head j serves query heads ``j * rep .. j * rep + rep - 1``
    (k0, k0, k0, k1, ...), not the tiled order."""
    return t.repeat_interleave(rep, dim=2)


def _block(cfg: OmniGen2Config, blk: OmniGen2Block, x: torch.Tensor,
           temb: Optional[torch.Tensor], cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d, hq, hk = cfg.hidden, cfg.heads, cfg.kv_heads
    mods = _modulation(blk, temb, d) if temb is not None else (None,) * 4
    s_msa, g_msa, s_mlp, g_mlp = mods
    b, s_len = x.shape[:2]
    n = _scaled(rms_norm(x, blk.norm1, eps=cfg.eps), s_msa)
    kf, vf = blk.kv(n).chunk(2, dim=-1)
    q = rms_norm_rope_plain(blk.q(n), blk.q_norm, cos, sin, hq, eps=cfg.eps,
                            norm_scope="head")
    k = rms_norm_rope_plain(kf, blk.k_norm, cos, sin, hk, eps=cfg.eps, norm_scope="head")
    v = vf.reshape(b, s_len, hk, cfg.head_dim)
    k, v = repeat_kv(k, hq // hk), repeat_kv(v, hq // hk)
    a = attention(q, k, v, fixed_max=QKNORM_FIXED_MAX).reshape(b, s_len, d)
    x = x + _gated(rms_norm(blk.o(a), blk.norm2, eps=cfg.eps), g_msa)
    n = _scaled(rms_norm(x, blk.ffn_norm1, eps=cfg.eps), s_mlp)
    f = blk.w2(F.silu(blk.w1(n)) * blk.w3(n))
    return x + _gated(rms_norm(f, blk.ffn_norm2, eps=cfg.eps), g_mlp)


def _run_blocks(cfg: OmniGen2Config, blocks: nn.ModuleList, x: torch.Tensor,
                temb: Optional[torch.Tensor], rope) -> torch.Tensor:
    for blk in blocks:
        x = _block(cfg, blk, x, temb, *rope)
    return x


def patchify(cfg: OmniGen2Config, img: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, (H/p)(W/p), p*p*C]`` in ``(h w)(p1 p2 c)``
    order (the checkpoint's layout)."""
    b, hh, ww, c = img.shape
    pp = cfg.patch
    x = img.reshape(b, hh // pp, pp, ww // pp, pp, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // pp) * (ww // pp), pp * pp * c)


def unpatchify(cfg: OmniGen2Config, x: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """Inverse of ``patchify`` over the token grid ``(gh, gw)``."""
    b = x.shape[0]
    gh, gw = grid
    pp, c = cfg.patch, cfg.in_channels
    x = x.reshape(b, gh, gw, pp, pp, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * pp, gw * pp, c)


def make_teacache_signal(model: OmniGen2Model):
    """TeaCache's signal ``(hidden, ctx) -> f32``: the first main layer's
    ``LuminaRMSNormZero``-modulated attention input ``norm1(x) * (1 +
    s_msa)``, in f32 (the JAX ``make_teacache_signal``)."""
    blk, cfg = model.layers[0], model.cfg

    @torch.inference_mode()
    def fn(hidden, ctx):
        s_msa = _modulation(blk, ctx["temb"], cfg.hidden)[0]
        return rms_norm(hidden, blk.norm1, eps=cfg.eps).float() * (1 + s_msa)

    return fn


def make_omnigen2_core(model: OmniGen2Model, txt_len: int, grid: Tuple[int, int],
                       ref_images: int = 0) -> DiTCore:
    """(prepare, trunk, head) for a static text length, latent grid and
    number of references.

    cond = {"txt": f[B, txt_len, text_dim] (the text encoder's states),
            "ref": f[B, R, gh*p, gw*p, C] (edit: the reference latents)}
    x    = channel-last latents f[B, gh*p, gw*p, C]
    t    = timesteps f32[B]

    The MagCache residual rides the joint ``[text; refs; noise]`` stream; the
    refiners run in ``prepare``, so they run on skipped steps too.
    """
    cfg = model.cfg
    gh, gw = grid
    img_tokens = gh * gw
    dev = model.cap_norm.device
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in omnigen2_rope_tables(cfg, txt_len, grid, ref_images))

    def seg(k):
        lo = txt_len + k * img_tokens
        return cos[lo:lo + img_tokens], sin[lo:lo + img_tokens]

    @torch.inference_mode()
    def prepare(x, t, cond):
        dt = cfg.torch_dtype
        temb = model.t_embed(timestep_embedding(t, cfg.time_embed_dim))
        txt = rms_norm(cond["txt"].float(), model.cap_norm, eps=cfg.eps)
        # f32 caption against the bf16 projection: JAX promotes to f32
        txt = F.linear(txt, model.cap_proj.weight.float(), model.cap_proj.bias.float()).to(dt)
        segs = [_run_blocks(cfg, model.context_refiner, txt, None,
                            (cos[:txt_len], sin[:txt_len]))]
        for r in range(ref_images):
            rt = model.ref_embed(patchify(cfg, cond["ref"][:, r].to(dt)))
            segs.append(_run_blocks(cfg, model.ref_refiner, rt, temb, seg(r)))
        noise = model.x_embed(patchify(cfg, x.to(dt)))
        segs.append(_run_blocks(cfg, model.noise_refiner, noise, temb, seg(ref_images)))
        return torch.cat(segs, dim=1), {"temb": temb}

    @torch.inference_mode()
    def trunk(hidden, ctx):
        return _run_blocks(cfg, model.layers, hidden, ctx["temb"], (cos, sin))

    @torch.inference_mode()
    def head(hidden, ctx):
        # LuminaLayerNormContinuous on the noise tokens: affine-free layer
        # norm, the temb scale, the f32 projection (JAX promotes the bf16 h)
        h = hidden[:, -img_tokens:]
        scale = model.norm_out_mod(F.silu(ctx["temb"])).float()
        h = (layer_norm(h, eps=cfg.eps).float() * (1 + scale[:, None])).to(hidden.dtype)
        out = model.final_out(h.float())
        return unpatchify(cfg, out, grid).float()

    return DiTCore(prepare, trunk, head)
