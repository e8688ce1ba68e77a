"""Wan 2.1 / 2.2 video DiT (t2v, i2v, flf2v, VACE and ti2v), as PyTorch
modules.

Same model as ``magcache_tpu.models.wan``:

- 3D patch embedding, patch (1, 2, 2) over (F, H, W) latents, as
  reshape + linear;
- f32 time path: sinusoidal(freq_dim) -> MLP -> e, then the 6-way
  projection e0;
- per-block learned modulation table added to e0 (shift/scale/gate for
  self-attention and FFN), kept in f32;
- self-attention with token-scope q/k RMSNorm and 3D RoPE (head dim split
  t/h/w = (d - 4*d6, 2*d6, 2*d6), d6 = d // 6), full attention;
- cross-attention to the padded text context, no masking; the i2v variant
  (``model_type="i2v"``, also flf2v) adds a parallel cross-attention to the
  CLIP image tokens, which sit in front of the text tokens in one context
  (``clip_tokens`` of them), with its own k/v projections and k norm; its
  output is added to the text output before ``cross_o``. Its ``prepare``
  concatenates the conditioning latents ``y`` (4 mask + 16 latent channels)
  to x on channels before the patchify, and embeds the CLIP features with
  ``img_emb`` (f32 linear -> tanh-gelu -> linear, rounded to the activation
  dtype);
- head: LayerNorm + 2-way modulation from the unprojected e, linear to patch
  voxels, unpatchify;
- VACE (``vace_layers``): a parallel stack of ``len(vace_layers)`` Wan
  blocks reads the conditioning context (``VACE_IN_CHANNELS`` = 96: the
  latents of the inactive and reactive halves of a source video and an 8x8
  space-to-depth mask), patch-embedded, projected by ``before_proj`` and
  added to the hidden tokens; each VACE block's ``after_proj`` output is a
  hint, added (times ``vace_scale``, rounded to the activation dtype) to the
  output of main block ``vace_layers[j]``;
- the Wan2.2 per-token timestep (ti2v with an image, ``cond["ti2v_img"]``):
  ``prepare`` runs the time path a second time at t = 0, so ``e`` is
  ``[B, 2, D]`` and ``e0`` ``[B, 2, 6, D]``; latent frame 0's H*W tokens
  (a time patch of 1) take row 1's modulation and gates in every block and
  in the head, the rest row 0's: each LayerNorm and gate runs over every
  token at row 0, then again on a contiguous copy of the prefix at row 1,
  written over the prefix's rows (both work row by row).

Dtypes: in a bf16 config only ``patch_embedding`` and the block linears are
bf16; the text/time embeddings, time projection, modulation tables, norm
gains and the head stay f32. PyTorch does not promote mixed-dtype products,
so every point where JAX promotes bf16 to f32 upcasts explicitly.

The MagCache boundary is the whole block stack, the VACE stack included:
``make_wan_core`` splits the model into ``prepare`` / ``trunk`` / ``head``.
``WAN_1_3B``, ``WAN_14B`` (Wan2.1, and each expert of the Wan2.2 A14B MoE)
and ``WAN_5B`` (Wan2.2 TI2V-5B, 48 latent channels) are the published
widths.

Tensor parallelism: under a plan with ``tp > 1`` a rank holds ``heads / tp``
heads of every block (the Megatron slices of ``parallel.shard``: q, k, v,
the cross projections and ffn1 by output features, o, cross_o and ffn2 by
input features). The q/k norms run over the whole ``dim``-wide rows: each
rank's f32 sums of squares of its slice (K2's statistics pass) are summed
over tp, and K2's apply pass and the cross-attention's ``rms_norm`` read the
total. o, cross_o and ffn2 end in an f32 all-reduce over tp, the bias added
once and the sum rounded once. Everything between blocks (the activations,
the modulation, K3 / K3p, the gates, the embeddings, the head, VACE's
``before_proj`` / ``after_proj`` and its hint adds) is whole on every tp
rank.

Sequence parallelism: with a ``plan`` (``parallel.mesh.MeshPlan``) every rank
runs the same core on its ``1/sp`` of the tokens. ``prepare`` embeds only the
rank's token rows, the RoPE tables are cut to those rows, the text context
stays whole on every rank, self-attention goes through Ulysses or the ring
and cross-attention keeps q sharded against the whole context, and ``head``
all-gathers the sequence before it unpatchifies, so every rank returns the
whole output. Weights are replicated over sp. VACE's context is patch-embedded on
the rank's rows only and its blocks run on the same plan as the trunk's. The
per-token timestep's t = 0 prefix is global: rank r holds rows ``[r*L,
(r+1)*L)``, so its own prefix is ``clamp(n0 - r*L, 0, L)`` rows (all, some or
none of its shard), in the blocks and in the head, which modulates before it
gathers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import DTYPES, init_linear_, timestep_embedding
from magcache_tpu_torch.ops.attention import QKNORM_FIXED_MAX, RING_THRESHOLD, attention
from magcache_tpu_torch.ops.fused_prologue import layer_norm_mod, rms_norm_rope
from magcache_tpu_torch.ops.norms import rms_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d
from magcache_tpu_torch.parallel.shard import (check_tp_split, row_parallel, slice_wan,
                                               tp_row_sums)

__all__ = ["WanConfig", "WanModel", "make_wan_core", "wan_rope_tables",
           "patchify", "unpatchify", "WAN_1_3B", "WAN_14B", "WAN_5B", "VACE_IN_CHANNELS"]

# VACE's conditioning context: the inactive and reactive halves' latents
# (16 + 16 channels) and the mask folded 8x8 (64)
VACE_IN_CHANNELS = 96


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
    model_type: str = "t2v"              # "t2v" | "i2v" (i2v and flf2v)
    clip_dim: int = 1280                 # i2v: the CLIP features' width
    clip_tokens: int = 257               # i2v: image tokens (flf2v: 514)
    vace_layers: Tuple[int, ...] = ()    # VACE: the main blocks that take hints
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def has_clip(self) -> bool:
        """The i2v image cross-attention branch (``clip_tokens`` 0: an i2v
        model conditioned by the ``y`` concat alone)."""
        return self.model_type == "i2v" and self.clip_tokens > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

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
WAN_14B = WanConfig(dim=5120, ffn_dim=13824, heads=40, layers=40)
# Wan2.2 TI2V-5B: a dense trunk on the Wan2.2 VAE's 48-channel latents; its
# image conditioning replaces latent frame 0, so in and out stay 48
WAN_5B = WanConfig(dim=3072, ffn_dim=14336, heads=24, layers=30,
                   in_channels=48, out_channels=48)


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
        if cfg.has_clip:
            self.cross_k_img, self.cross_v_img = lin(d, d), lin(d, d)
            self.cross_norm_k_img = _param((d,), device, 1.0)

    def forward(self, x: torch.Tensor, e0: torch.Tensor, context: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, sp: Optional[dict] = None,
                n0: int = 0, tp=None) -> torch.Tensor:
        """``sp``: the sequence-parallel arguments of ``attention()``
        (``plan``, ``sp_impl``, ``ring_threshold``) when x holds one rank's
        tokens (cos/sin then hold those rows' tables); None on one rank.

        ``tp``: the rank's tp ``Group`` when this block holds a tensor-parallel
        rank's slices (``parallel.shard.slice_wan``): ``heads / tp`` heads,
        the q/k norms over the whole rows from statistics summed over the
        group, and o, cross_o and ffn2 each ending in an all-reduce; x, the
        modulation and the gates stay whole.

        ``e0`` is ``[B, 6, D]``, or ``[B, 2, 6, D]`` for the per-token
        timestep: the first ``n0`` tokens of x take row 1's modulation and
        gates, the others row 0's (under a plan, ``n0`` counts the prefix
        rows of this rank's shard)."""
        cfg = self.cfg
        sp = sp or {}
        b, s, _ = x.shape
        eps = cfg.eps
        ntp = tp.size if tp is not None else 1
        heads = cfg.heads // ntp

        def gain(g):
            """The rank's slice of a whole-row norm gain."""
            n = g.shape[0] // ntp
            return g if tp is None else g.narrow(0, tp.rank * n, n)

        def row_sums(*ts):
            return tp_row_sums(tp, ts) if tp is not None else [None] * len(ts)

        def out_proj(lin, a):
            return lin(a) if tp is None else row_parallel(lin, a, tp)
        # per-block modulation table added in f32: [B, 6, D] ([B, 2, 6, D])
        e = (self.modulation + e0).float()
        seg = e.ndim == 4
        mods = [(e[:, 0] if seg else e)[:, i:i + 1] for i in range(6)]
        mods0 = [e[:, 1, i:i + 1] for i in range(6)] if seg else mods

        # K3 and the gate work row by row: every token at row 0's modulation,
        # then the t = 0 prefix overwritten at row 1's (a copy of n0 rows
        # only; a rank whose shard holds none of the prefix launches nothing)
        prefix = seg and n0 > 0

        def ln_mod(x, i_shift, i_scale):
            out = layer_norm_mod(x, scale=mods[i_scale], shift=mods[i_shift], eps=eps)
            if prefix:
                out[:, :n0] = layer_norm_mod(x[:, :n0].contiguous(), scale=mods0[i_scale],
                                             shift=mods0[i_shift], eps=eps)
            return out

        def gate(x, y, i):
            g = y.float() * mods[i]
            if prefix:
                g[:, :n0] = y[:, :n0].float() * mods0[i]
            return x + g.to(x.dtype)

        # self-attention
        xn = ln_mod(x, 0, 1)
        q, k = self.q(xn), self.k(xn)
        ss_q, ss_k = row_sums(q, k)
        q = rms_norm_rope(q, gain(self.norm_q), cos, sin, heads, eps=eps, row_sumsq=ss_q,
                          width=cfg.dim)
        k = rms_norm_rope(k, gain(self.norm_k), cos, sin, heads, eps=eps, row_sumsq=ss_k,
                          width=cfg.dim)
        v = self.v(xn).reshape(b, s, heads, -1)
        a = attention(q, k, v, fixed_max=QKNORM_FIXED_MAX, kv_replicated=False,
                      **sp).reshape(b, s, -1)
        x = gate(x, out_proj(self.o, a), 2)

        # cross-attention to the text context, and with the CLIP branch to
        # the image tokens in front of it; the two outputs are summed in the
        # activation dtype (residual in the activation dtype)
        xc = layer_norm_mod(x, weight=self.norm3_w, bias=self.norm3_b, eps=eps)
        n_img = cfg.clip_tokens if cfg.has_clip else 0
        srcs = [(context[:, n_img:], self.cross_k, self.cross_v, self.cross_norm_k)]
        if n_img:
            srcs.append((context[:, :n_img], self.cross_k_img, self.cross_v_img,
                         self.cross_norm_k_img))
        cq = self.cross_q(xc)
        cks = [k_proj(ctx) for ctx, k_proj, _, _ in srcs]
        sums = row_sums(cq, *cks)
        cq = rms_norm(cq, gain(self.cross_norm_q), eps=eps, row_sumsq=sums[0],
                      width=cfg.dim).reshape(b, s, heads, -1)
        ca = None
        for (ctx, _, v_proj, k_norm), ck, ss in zip(srcs, cks, sums[1:]):
            sc = ctx.shape[1]
            ck = rms_norm(ck, gain(k_norm), eps=eps, row_sumsq=ss,
                          width=cfg.dim).reshape(b, sc, heads, -1)
            cv = v_proj(ctx).reshape(b, sc, heads, -1)
            o = attention(cq, ck, cv, fixed_max=QKNORM_FIXED_MAX, kv_replicated=True,
                          **sp).reshape(b, s, -1)
            ca = o if ca is None else ca + o
        x = x + out_proj(self.cross_o, ca)

        # FFN, tanh-gelu
        xm = ln_mod(x, 3, 4)
        y = out_proj(self.ffn2, F.gelu(self.ffn1(xm), approximate="tanh"))
        return gate(x, y, 5)


class WanHead(nn.Module):
    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        self.modulation = _param((2, cfg.dim), device, 0.0)
        self.out = nn.Linear(cfg.dim, cfg.patch_out, device=device,
                             dtype=torch.float32)


class WanVace(nn.Module):
    """The VACE stack: the context's patch embedding, ``before_proj``, one
    ``WanBlock`` and one ``after_proj`` per hint (bf16 in a bf16 config)."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype
        pt, ph, pw = cfg.patch

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.patch_embedding = lin(VACE_IN_CHANNELS * pt * ph * pw, d)
        self.before_proj = lin(d, d)
        self.after_proj = nn.ModuleList(lin(d, d) for _ in cfg.vace_layers)
        self.blocks = nn.ModuleList(WanBlock(cfg, device) for _ in cfg.vace_layers)


class WanModel(nn.Module):
    """Wan t2v or i2v DiT, with the VACE stack when ``cfg.vace_layers`` is
    set. Build on ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict`` (see ``models/convert.py``). The i2v model's
    ``img_emb`` linears are f32."""

    def __init__(self, cfg: WanConfig, device=None):
        super().__init__()
        if cfg.model_type not in ("t2v", "i2v"):
            raise NotImplementedError(
                f"Wan model_type {cfg.model_type!r}: the model types are t2v and i2v")
        if cfg.vace_layers and cfg.has_clip:
            raise ValueError("VACE rides the t2v trunk, not one with the CLIP branch")
        if not all(0 <= i < cfg.layers for i in cfg.vace_layers):
            raise ValueError(f"vace_layers {cfg.vace_layers} name blocks outside "
                             f"0..{cfg.layers - 1}")
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
        if cfg.has_clip:
            self.img_emb = nn.ModuleDict({"in": lin(cfg.clip_dim, cfg.clip_dim),
                                          "out": lin(cfg.clip_dim, d)})
        if cfg.vace_layers:
            self.vace = WanVace(cfg, device)

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
            vace = self.vace.blocks if self.cfg.vace_layers else ()
            for m in (*self.blocks, self.head, *vace):
                m.modulation.copy_(torch.randn(
                    m.modulation.shape, generator=generator,
                    device=generator.device) / math.sqrt(d))
        return self


def make_wan_core(model: WanModel, grid: Tuple[int, int, int], plan=None, *,
                  sp_impl: str = "auto",
                  ring_threshold: int = RING_THRESHOLD) -> DiTCore:
    """(prepare, trunk, head) for a static latent patch grid (F, H, W).

    cond = {"context": f[B, text_len, text_dim]; i2v adds "y": the
            conditioning latents f[B, F*pt, H*ph, W*pw, C_y] (concatenated
            to x on channels, C + C_y = in_channels) and, with the CLIP
            branch, "clip_fea": f[B, clip_tokens, clip_dim]; VACE adds
            "vace_context": f[B, F*pt, H*ph, W*pw, VACE_IN_CHANNELS] and
            optionally "vace_scale" (a float, default 1.0); the key
            "ti2v_img" (any value) turns on the per-token timestep}
    x    = latent video f[B, F*pt, H*ph, W*pw, C] (channel-last)

    With ``plan`` the core is one rank's: hidden holds the rank's
    ``F*H*W / sp`` token rows (the count must divide by ``sp``), x and the
    head's output are whole on every rank. ``sp_impl`` ("auto", "ulysses",
    "ring") and ``ring_threshold`` pick self-attention's strategy (see
    ``ops.attention.attention``). Under ``tp > 1`` the blocks run on the
    rank's slices (``parallel.shard.slice_wan``; views of ``model`` unless
    ``model`` is already that rank's slice): ``heads / tp`` heads a rank,
    and under Ulysses ``heads / (sp * tp)`` after its all-to-all, else the
    split raises naming the counts. ``dp`` is the sampler's: the core runs
    whatever rows it is given.
    """
    cfg = model.cfg
    device = model.patch_embedding.weight.device
    # latent frame 0's tokens: the per-token timestep's t = 0 prefix (this
    # rank's share of it under a plan, below)
    n0 = grid[1] * grid[2]
    hint_of_layer = {layer: j for j, layer in enumerate(cfg.vace_layers)}
    cos_np, sin_np = wan_rope_tables(cfg, grid)
    cos = torch.from_numpy(cos_np).to(device)
    sin = torch.from_numpy(sin_np).to(device)
    sp = tp = None
    seq = plan if plan is not None and plan.sp > 1 else None
    ring = sp_impl == "ring" or (sp_impl == "auto" and cos.shape[0] >= ring_threshold)
    sliced = getattr(model, "tp_slice", None)
    if plan is not None and plan.tp > 1:
        check_tp_split(cfg, plan.tp, plan.sp, ring)
        if sliced is None:          # local ranks: views of the one whole model
            model = slice_wan(model, plan.tp_rank, plan.tp)
        elif sliced != (plan.tp_rank, plan.tp):
            raise ValueError(f"make_wan_core: the model holds tp slice {sliced}, the plan "
                             f"is tp rank {plan.tp_rank} of {plan.tp}")
        tp = plan.tp_group
    elif sliced is not None and sliced[1] > 1:
        raise ValueError(f"make_wan_core: the model is tp slice {sliced}; pass the plan "
                         f"of that tp rank")
    tp_arg = () if tp is None else (tp,)    # the blocks' signature without tp, on one rank
    if seq is not None:
        from magcache_tpu_torch.parallel.collectives import (gather_sequence,
                                                             split_sequence)
        what = f"make_wan_core: the token sequence of grid {tuple(grid)}"
        if cfg.vace_layers:
            what += " (VACE's R2V reference frames included)"
        rows = plan.shard_len(cos.shape[0], what)
        n0 = min(max(n0 - plan.rank * rows, 0), rows)
        if plan.tp == 1 and not ring and cfg.heads % plan.sp:
            raise ValueError(f"make_wan_core: {cfg.heads} heads do not divide by "
                             f"sp = {plan.sp} (Ulysses attention)")
        cos = split_sequence(cos, plan, 0).contiguous()
        sin = split_sequence(sin, plan, 0).contiguous()
        sp = dict(plan=plan, sp_impl=sp_impl, ring_threshold=ring_threshold)

    @torch.inference_mode()
    def prepare(x, t, cond):
        dt = cfg.torch_dtype
        if cfg.model_type == "i2v":
            if "y" not in cond:
                raise ValueError("the i2v model needs the conditioning latents cond['y']")
            x = torch.cat([x, cond["y"].to(x.dtype)], dim=-1)
        tokens = patchify(cfg, x.to(dt))
        if seq is not None:         # embed this rank's token rows only
            tokens = split_sequence(tokens, plan, 1)
        hidden = model.patch_embedding(tokens)
        te = model.time_embedding

        def time_path(tv):
            e = te["out"](F.silu(te["in"](timestep_embedding(tv, cfg.freq_dim))))
            return e, model.time_projection(F.silu(e)).reshape(e.shape[0], 6, cfg.dim)

        e, e0 = time_path(t)
        if "ti2v_img" in cond:
            # the per-token timestep: latent frame 0's tokens run at t = 0
            if cfg.patch[0] != 1:
                raise ValueError(f"the per-token timestep needs a time patch of 1, "
                                 f"got {cfg.patch}")
            ez, e0z = time_path(torch.zeros_like(t))
            e, e0 = torch.stack([e, ez], dim=1), torch.stack([e0, e0z], dim=1)
        tx = model.text_embedding
        ctx = F.gelu(tx["in"](cond["context"].float()), approximate="tanh")
        ctx = tx["out"](ctx).to(dt)
        if cfg.has_clip:
            if "clip_fea" not in cond:
                raise ValueError("the i2v model's CLIP branch needs cond['clip_fea']")
            im = model.img_emb
            img = F.gelu(im["in"](cond["clip_fea"].float()), approximate="tanh")
            ctx = torch.cat([im["out"](img).to(dt), ctx], dim=1)
        out = {"e": e, "e0": e0, "context": ctx}
        if cfg.vace_layers:
            if "vace_context" not in cond:
                raise ValueError("the VACE model needs its conditioning context "
                                 "cond['vace_context']")
            out["vace_context"] = cond["vace_context"].to(dt)
            out["vace_scale"] = cond.get("vace_scale", 1.0)
        return hidden, out

    def vace_hints(hidden, ctx):
        """Each VACE block's hint: the stack runs from the patch-embedded
        context (under a plan, the rank's rows of it), projected and added to
        the hidden tokens."""
        vace = model.vace
        tokens = patchify(cfg, ctx["vace_context"])
        if seq is not None:
            tokens = split_sequence(tokens, plan, 1)
        c = vace.before_proj(vace.patch_embedding(tokens)) + hidden
        hints = []
        for blk, proj in zip(vace.blocks, vace.after_proj):
            c = blk(c, ctx["e0"], ctx["context"], cos, sin, sp, n0, *tp_arg)
            hints.append(proj(c))
        return hints

    @torch.inference_mode()
    def trunk(hidden, ctx):
        hints = vace_hints(hidden, ctx) if cfg.vace_layers else None
        x = hidden
        for i, blk in enumerate(model.blocks):
            x = blk(x, ctx["e0"], ctx["context"], cos, sin, sp, n0, *tp_arg)
            if i in hint_of_layer:
                x = x + (hints[hint_of_layer[i]] * ctx["vace_scale"]).to(x.dtype)
        return x

    @torch.inference_mode()
    def head(hidden, ctx):
        hp = model.head

        def mod_head(xn, ev):
            mod = hp.modulation[None] + ev[:, None, :]
            shift, scale = mod[:, 0:1], mod[:, 1:2]
            return xn * (1 + scale) + shift

        # bf16 LayerNorm output times f32 modulation promotes to f32 in JAX;
        # the affine-free LayerNorm is K3p on the card (ops.norms.layer_norm's
        # arithmetic: f32 statistics, one rounding)
        xn = layer_norm_mod(hidden.contiguous(), eps=cfg.eps).float()
        e = ctx["e"]
        if e.ndim == 3:     # the per-token timestep: the t = 0 prefix at row 1
            h = mod_head(xn, e[:, 0])
            if n0:
                h[:, :n0] = mod_head(xn[:, :n0], e[:, 1])
        else:
            h = mod_head(xn, e)
        # round to the activation dtype, then the f32 head weight promotes
        out = hp.out(h.to(hidden.dtype).float())
        if seq is not None:         # every rank gets the whole sequence back
            out = gather_sequence(out, plan, 1)
        return unpatchify(cfg, out, grid)

    return DiTCore(prepare, trunk, head)
