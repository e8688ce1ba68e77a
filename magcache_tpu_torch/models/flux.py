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

Under a plan (``make_flux_core(plan=)``, the JAX model's ``maybe_shard``
hooks): the image tokens split over ``sp`` (each rank holds a contiguous
``1/sp`` of the image stream, Kontext's conditioning tokens included), the
text tokens stay whole on every rank, and the heads and the MLP split over
``tp`` (``parallel.shard.slice_flux``). The joint ``[txt; img]`` attention
goes through ``attention(plan=, whole_prefix=txt_len)``, so the text tokens
enter it once: Ulysses runs K1b over ``heads / (sp * tp)`` heads of the whole
joint sequence, the ring runs K1c with the text rows split over sp. K2 in
head scope normalizes each head alone, so a tp rank runs it on its own heads
with no statistics pass; K3 runs on whole rows; every row-parallel
projection (``img_proj``, ``txt_proj``, ``img_mlp2``, ``txt_mlp2``, ``lin2``)
ends in ``row_parallel``'s f32 all-reduce over tp before its gate. The head
gathers the image tokens over sp, so every rank returns the whole output.
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
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, RING_THRESHOLD, attention
from magcache_tpu_torch.ops.fused_prologue import layer_norm_mod, rms_norm_rope
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d
from magcache_tpu_torch.parallel.collectives import tp_out
from magcache_tpu_torch.parallel.shard import check_flux_split, row_parallel, slice_flux

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


@dataclasses.dataclass(frozen=True)
class _Par:
    """A block's share of the grid: ``plan`` the rank's ``MeshPlan`` (None
    on one rank), ``sp`` the sequence-parallel arguments of ``attention()``
    (empty on one sp rank)."""

    plan: object = None
    sp: dict = dataclasses.field(default_factory=dict)

    @property
    def tp(self) -> int:
        return 1 if self.plan is None else self.plan.tp

    def widths(self, cfg: FluxConfig) -> Tuple[int, int, int]:
        """(heads, attention width, MLP width) of this rank's slices."""
        return cfg.heads // self.tp, cfg.hidden // self.tp, cfg.mlp_dim // self.tp


_ONE = _Par()


def _joint_attention(q, k, v, txt_len: int, par: _Par) -> torch.Tensor:
    """The joint attention over ``[txt; img]``; under sp the text rows are
    whole on every rank and enter it once (``whole_prefix``)."""
    if not par.sp:
        return attention(q, k, v, fixed_max=QKNORM_FIXED_MAX)
    return attention(q, k, v, fixed_max=QKNORM_FIXED_MAX, kv_replicated=False,
                     whole_prefix=txt_len, **par.sp)


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
                rope_txt, rope_img, par: _Par = _ONE) -> Tuple[torch.Tensor, torch.Tensor]:
        """``par``: this rank's share of the grid (``make_flux_core``); img
        then holds the rank's image tokens and the block its tp slices."""
        cfg = self.cfg
        heads, w, _ = par.widths(cfg)
        b, txt_len = txt.shape[:2]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = _mod(vec, self.img_mod, 6)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = _mod(vec, self.txt_mod, 6)

        # joint attention over [txt; img], each stream normed and rotated
        # with its slice of the rope table
        iqkv = self.img_qkv(layer_norm_mod(img, scale=i_sc1, shift=i_sh1, eps=_EPS))
        tqkv = self.txt_qkv(layer_norm_mod(txt, scale=t_sc1, shift=t_sh1, eps=_EPS))
        iq, ik = _qk_norm_rope(iqkv, self.img_qk_scale, *rope_img, heads, w)
        tq, tk = _qk_norm_rope(tqkv, self.txt_qk_scale, *rope_txt, heads, w)
        q = torch.cat([tq, iq], dim=1)
        k = torch.cat([tk, ik], dim=1)
        v = torch.cat([tqkv[..., 2 * w:], iqkv[..., 2 * w:]], dim=1)
        o = _joint_attention(q, k, v.reshape(q.shape), txt_len, par)
        o = o.reshape(b, -1, w)
        img = _gated(img, i_g1, tp_out(self.img_proj, o[:, txt_len:], par.plan))
        txt = _gated(txt, t_g1, tp_out(self.txt_proj, o[:, :txt_len], par.plan))

        img_m = layer_norm_mod(img, scale=i_sc2, shift=i_sh2, eps=_EPS)
        img = _gated(img, i_g2, tp_out(self.img_mlp2,
                                       F.gelu(self.img_mlp1(img_m), approximate="tanh"),
                                       par.plan))
        txt_m = layer_norm_mod(txt, scale=t_sc2, shift=t_sh2, eps=_EPS)
        txt = _gated(txt, t_g2, tp_out(self.txt_mlp2,
                                       F.gelu(self.txt_mlp1(txt_m), approximate="tanh"),
                                       par.plan))
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
                sin: torch.Tensor, par: _Par = _ONE, txt_len: int = 0) -> torch.Tensor:
        """``par`` as the double block's; h then holds the whole ``txt_len``
        text rows and the rank's image tokens."""
        cfg = self.cfg
        heads, w, _ = par.widths(cfg)
        b, s, _ = h.shape
        shift, scale, gate = _mod(vec, self.mod, 3)
        proj = self.lin1(layer_norm_mod(h, scale=scale, shift=shift, eps=_EPS))
        q, k = _qk_norm_rope(proj, self.qk_scale, cos, sin, heads, w)
        v = proj[..., 2 * w:3 * w].reshape(b, s, heads, -1).contiguous()
        o = _joint_attention(q, k, v, txt_len, par).reshape(b, s, w)
        mlp = F.gelu(proj[..., 3 * w:], approximate="tanh")
        if par.tp > 1:      # lin2 reads [o | mlp] slices: two segments
            return _gated(h, gate, row_parallel(self.lin2, [o, mlp], par.plan.tp_group))
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
                   kontext: bool = False, rope_tables=None, grid_t: int = 1,
                   plan=None, *, sp_impl: str = "auto",
                   ring_threshold: int = RING_THRESHOLD) -> DiTCore:
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

    With ``plan`` the core is one rank's (module docstring): ``prepare``
    embeds the rank's contiguous ``1/sp`` of the image stream, the trunk
    takes and returns those tokens (the MagCache residual is the rank's
    share), and the head returns the whole output on every rank. Under
    ``tp > 1`` the blocks run on the rank's slices (views of ``model``
    unless it already is that rank's slice). ``sp_impl`` ("auto",
    "ulysses", "ring") and ``ring_threshold`` pick the joint attention's
    strategy as ``attention()`` does, on the global joint sequence. Raises
    ``ValueError`` naming the counts when the heads do not split over tp (or
    over ``sp * tp`` under Ulysses), the image tokens over sp, or (ring) the
    text tokens over sp. ``dp`` is the caller's: the core runs the rows it
    is given.
    """
    cfg = model.cfg
    device = model.img_in.weight.device
    cos_np, sin_np = (rope_tables if rope_tables is not None else
                      flux_rope_tables(cfg, txt_len, grid_h, grid_w, kontext=kontext))
    cos, sin = torch.from_numpy(cos_np).to(device), torch.from_numpy(sin_np).to(device)
    img_len = grid_t * grid_h * grid_w
    par, seq = _ONE, None
    sliced = getattr(model, "tp_slice", None)
    if plan is not None and (plan.sp > 1 or plan.tp > 1):
        stream = cos.shape[0] - txt_len        # the image stream, Kontext's tokens too
        ring = sp_impl == "ring" or (sp_impl == "auto"
                                     and cos.shape[0] >= ring_threshold)
        check_flux_split(cfg, plan.tp, plan.sp, ring)
        if plan.tp > 1:
            if sliced is None:      # local ranks: views of the one whole model
                model = slice_flux(model, plan.tp_rank, plan.tp)
            elif sliced != (plan.tp_rank, plan.tp):
                raise ValueError(f"make_flux_core: the model holds tp slice {sliced}, "
                                 f"the plan is tp rank {plan.tp_rank} of {plan.tp}")
        sp = {}
        if plan.sp > 1:
            rows = plan.shard_len(stream, f"make_flux_core: the image stream of "
                                          f"{stream} tokens")
            if ring and txt_len % plan.sp:
                raise ValueError(f"make_flux_core: ring attention splits the {txt_len} "
                                 f"text tokens over sp = {plan.sp}; they do not divide")
            seq = (plan, rows)
            # the rank's rows of the image tables; the text rows stay whole
            img_rows = slice(txt_len + plan.rank * rows, txt_len + (plan.rank + 1) * rows)
            cos = torch.cat([cos[:txt_len], cos[img_rows]]).contiguous()
            sin = torch.cat([sin[:txt_len], sin[img_rows]]).contiguous()
            sp = dict(plan=plan, sp_impl=sp_impl, ring_threshold=ring_threshold)
        par = _Par(plan=plan, sp=sp)
    elif sliced is not None and sliced[1] > 1:
        raise ValueError(f"make_flux_core: the model is tp slice {sliced}; pass the plan "
                         f"of that tp rank")
    rope_txt = (cos[:txt_len], sin[:txt_len])
    rope_img = (cos[txt_len:], sin[txt_len:])

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
        if seq is not None:         # this rank's rows of the image stream
            plan_, rows = seq
            img = img.narrow(1, plan_.rank * rows, rows)
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
            img, txt = blk(img, txt, vec, rope_txt, rope_img, par)
        if not model.single_blocks:
            return img       # double blocks only (Qwen-Image): no concat, no copy
        h = torch.cat([txt, img], dim=1)
        for blk in model.single_blocks:
            h = blk(h, vec, cos, sin, par, txt_len)
        return h[:, txt.shape[1]:]   # image tokens only: the cacheable stream

    @torch.inference_mode()
    def head(img, ctx):
        if kontext and seq is None:
            img = img[:, :img_len]   # drop the conditioning tokens
        shift, scale = _mod(ctx["vec"], model.final_mod, 2)
        h = layer_norm_mod(img.contiguous(), scale=scale, shift=shift, eps=_EPS)
        # the f32 head weight promotes the bf16 activations in JAX
        out = model.final_out(h.float())
        if seq is not None:         # every rank gets the whole image back
            out = seq[0].group.all_gather(out, 1)[:, :img_len]
        return out

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
