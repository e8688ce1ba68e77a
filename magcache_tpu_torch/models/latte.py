"""Latte T2V (Latte-1), the VideoSys spatial-temporal DiT, as PyTorch modules.

Same model as ``magcache_tpu.models.latte`` (behavioral source
``videosys/models/transformers/latte_transformer_3d.py``, ``LatteT2V``):
``depth`` paired (spatial, temporal) blocks; the spatial block is
self-attention over each frame's S patches, cross-attention to the caption
and an MLP, the temporal block self-attention over the T frames at each
location and an MLP; PixArt-style AdaLN-single (one 6-way modulation from
the timestep, plus each block's ``scale_shift`` table); absolute 2-D sincos
position embeddings, and a temporal sincos table added to the residual
stream once, before the first temporal block. Heads are 72 wide and have no
qk-norm or RoPE.

``make_latte_core(..., route=)`` picks the block composition explicitly (the
JAX package switches on ``MAGCACHE_STDIT3_PACKED`` and
``MAGCACHE_TINY_ATTN``; the route here depends on neither the environment
nor the device):

- ``"packed"``, the TPU default: spatial K7 ``lnmod_matmul`` (LayerNorm +
  modulate + qkv) -> K5r (``grouped_attention_fused_qkv`` without gains, one
  group per frame, row-max softmax) -> K8 ``matmul_gated_residual`` (out
  projection + gate + residual) -> K6 ``fused_cross_attention`` with the
  residual; temporal K3 ``layer_norm_mod`` -> qkv ``nn.Linear`` on the
  [S, T] view -> K5r over groups of T -> K8 (gate, no residual) -> transpose
  back and add; the MLP K7 with gelu -> K8 with the residual.
- ``"grouped"`` and ``"vpu"``, the unpacked composition: every attention and
  MLP branch starts with K3; ``nn.Linear`` projections; spatial
  self-attention and cross-attention through ``attention()`` (K1 at head
  dim 72 zero-padded to 128, running max); temporal attention through
  ``tiny_temporal_attention`` in that mode (K4 or K9); f32 gates.

Frames of more than 2,048 tokens (768x768: 2,304) take the JAX unfused
block on the packed route: K3, ``qkv``, ``attention()`` (K1) and ``proj``
in the spatial blocks, K3, ``qkv``, K5r over groups of T and ``proj`` in the
temporal ones, cross-attention through ``attention()``, the MLP K3 ->
``ff1`` -> gelu -> ``ff2``, f32 gates; no K6, K7 or K8.

The TPU's 128-lane head padding and its frame padding (``Tp``, ``Sg``) are
not carried over: groups are T and S, and heads stay 72 wide. Dtypes: in a
bf16 config the patch embedding and the block linears are bf16; the
embedders, the modulation tables and the final layer stay f32, as the JAX
parameters are.

PAB (``make_latte_core(pab=, timesteps=)``, the JAX ``_block(cached=...)``,
on every route) runs every step on that composed block: spatial attention
K3 -> qkv -> K5r (packed, up to 2,048 tokens) or ``attention()`` ->
``proj``, temporal K3 -> qkv -> K5r (packed) or ``tiny_temporal_attention``
(K4 / K9) -> ``proj``, cross-attention ``cross_q`` -> ``attention()`` (K1)
-> ``cross_o``, the MLP K3 -> ``ff1`` -> gelu -> ``ff2``, f32 gates; each
site replays its slot by the step's host mask, and the MLP slots follow the
block-granular masks (refreshed only on save steps). Temporal blocks have
no cross slot.

Under a plan (``make_latte_core(plan=)``; the JAX package's gates at
``models/latte.py:131-150, 225-240, 255-268, 339-372``) the trunk keeps its
activations sharded as STDiT3's does (``models/stdit3.py``'s docstring,
``parallel.collectives.VideoShards``): on the packed route the spatial
blocks over frames (K7, K5r on the rank's heads, K8, K6) and the temporal
blocks over each frame's tokens (K3, ``qkv``, K5r over groups of T, K8),
the MLP K7 / K8 token-parallel, one all-to-all over sp between the two
layouts; at ``tp > 1`` Megatron slices of the JAX patterns (``qkv``, the
cross projections and ``ff1`` / ``ff2``), each row-parallel projection
ending in the f32 all-reduce over tp. Frames above 2,048 tokens, PAB and
``route="unpacked"`` run the unpacked composition on the tokens layout
(spatial and cross attention through ``attention(plan=)``, K1b; the
temporal attention K5r over groups of T on the rank's heads). The temporal
position table joins the stream on the tokens layout. "grouped" and "vpu"
under a plan raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.pab import broadcast_masks, mlp_skip_masks
from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import (DTYPES, embedder_linears, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.models.stdit3 import (MAX_GROUP_TOKENS, PLAN_ROUTES, ROUTES,
                                              _pab_site, check_ulysses, pab_slots,
                                              plan_setup, pos_embed_2d)
from magcache_tpu_torch.ops.attention import attention, grouped_attention_fused_qkv
from magcache_tpu_torch.ops.fused_prologue import layer_norm_mod
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d
from magcache_tpu_torch.ops.tiny_attention import tiny_temporal_attention
from magcache_tpu_torch.parallel.collectives import (VideoShards, sharded_fused_cross_attention,
                                                     sharded_grouped_attention_fused_qkv,
                                                     sharded_lnmod_matmul,
                                                     sharded_matmul_gated_residual, tp_out)

__all__ = ["LatteConfig", "LatteModel", "LATTE_1", "ROUTES", "latte_pab_masks",
           "make_latte_core"]


@dataclasses.dataclass(frozen=True)
class LatteConfig:
    hidden: int = 1152
    heads: int = 16
    depth: int = 28                 # pairs (spatial, temporal)
    mlp_ratio: int = 4
    in_channels: int = 4
    # published Latte-1 predicts epsilon + variance (8); the variance half is
    # dropped by the head. 0 -> in_channels
    out_channels: int = 0
    caption_dim: int = 4096
    patch: int = 2                  # spatial patch
    time_embed_dim: int = 256
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def c_out(self) -> int:
        return self.out_channels or self.in_channels

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "LatteConfig":
        d = dict(hidden=64, heads=4, depth=2, caption_dim=24, time_embed_dim=32)
        d.update(kw)
        return LatteConfig(**d)


# Latte-1 (LatteT2V, 1.057 B parameters)
LATTE_1 = LatteConfig(out_channels=8)


class LatteBlock(nn.Module):
    """One spatial (``cross=True``) or temporal block; parameter names follow
    the JAX keys."""

    def __init__(self, cfg: LatteConfig, cross: bool, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.scale_shift = nn.Parameter(torch.zeros((6, d), device=device))
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        self.ff1, self.ff2 = lin(d, cfg.mlp_ratio * d), lin(cfg.mlp_ratio * d, d)
        self.cross = cross
        if cross:
            self.cross_q, self.cross_kv, self.cross_o = lin(d, d), lin(d, 2 * d), lin(d, d)

    def forward(self, h: torch.Tensor, t6: torch.Tensor, y: torch.Tensor, *,
                grid: Tuple[int, int, int], route: str, pab=None, plan=None,
                frame_tokens=None) -> torch.Tensor:
        """One block on ``h`` ``[rows, T*S, d]``. ``pab``: ``(slots, reuse,
        save_mlp)``, the block's PAB slots (``"attn"``, ``"cross"``,
        ``"mlp"`` -> ``[rows, T*S, d]`` or absent), this step's reuse bits
        per site and whether the MLP slot refreshes. ``plan`` and
        ``frame_tokens`` as STDiT3's block takes them."""
        e = (self.scale_shift[None] + t6).float()          # [rows, 6, d]
        if pab is None and route == "packed" and grid[1] * grid[2] <= MAX_GROUP_TOKENS:
            return self._packed(h, e, y, grid, plan)
        return self._composed(h, e, y, grid, route, plan, frame_tokens, pab)

    def _packed(self, h, e, y, grid, plan=None):
        """The packed block through the ``sharded_*`` wrappers: under
        ``plan`` on a rank's shard (a spatial block's frames, a temporal
        one's tokens), K5r on the rank's heads and, at ``tp > 1``, the
        row-parallel all-reduces in place of K8's GEMM and K6."""
        cfg = self.cfg
        rows, n, d = h.shape
        t, s = grid[0], grid[1] * grid[2]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = e.unbind(1)
        attn = dict(scale=1.0 / math.sqrt(cfg.head_dim), true_d=cfg.head_dim)
        if self.cross:
            hf = h.reshape(rows * t, s, d)
            qkv = sharded_lnmod_matmul(hf, sc_a, sh_a, self.qkv, plan, eps=cfg.eps,
                                       batch_repeat=t)
            o = sharded_grouped_attention_fused_qkv(qkv, cfg.heads, plan, group=s, **attn)
            h = sharded_matmul_gated_residual(o, self.proj, g_a, hf, plan,
                                              batch_repeat=t).reshape(rows, n, d)
            k, v = (c.contiguous() for c in self.cross_kv(y).chunk(2, -1))
            h = sharded_fused_cross_attention(h, self.cross_q, k, v, self.cross_o, cfg.heads,
                                              plan, residual=True, **attn)
        else:
            xn = layer_norm_mod(h, scale=sc_a, shift=sh_a, eps=cfg.eps)
            xr = xn.reshape(rows, t, s, d).transpose(1, 2).reshape(rows * s, t, d)
            qkv = self.qkv(xr)
            o = sharded_grouped_attention_fused_qkv(qkv.reshape(1, rows * s * t, -1),
                                                    cfg.heads, plan, group=t, **attn)
            a = sharded_matmul_gated_residual(o.reshape(rows * s, t, -1), self.proj, g_a,
                                              None, plan, rows_out=t, batch_repeat=s)
            h = h + a.reshape(rows, s, t, d).transpose(1, 2).reshape(rows, n, d)
        y1 = sharded_lnmod_matmul(h, sc_m, sh_m, self.ff1, plan, act="gelu", eps=cfg.eps)
        return sharded_matmul_gated_residual(y1, self.ff2, g_m, h, plan)

    def _composed(self, h, e, y, grid, route, plan=None, frame_tokens=None, pab=None):
        """The block as its sites and f32 gates (JAX ``_block`` off its fused
        packed path): the unpacked routes, packed frames above 2,048 tokens
        and PAB on every route. Each branch starts with K3; spatial
        attention runs K5r with one group per frame on the packed route up
        to 2,048 tokens, else ``attention()`` (K1); temporal attention K5r
        over groups of T on the packed and unpacked routes (under ``plan``
        on the rank's heads), else ``tiny_temporal_attention`` in the
        route's mode (K4 or K9); cross-attention ``cross_q`` ->
        ``attention()`` -> ``cross_o``; the MLP ``ff1`` -> gelu -> ``ff2``.
        Under ``pab`` each site replays its slot where the step's reuse bit
        says so, else computes; outputs are cached before their gates and
        the MLP slot is written only on save steps. Under ``plan`` (the
        unpacked route on a tokens shard) the rank's heads: spatial and
        cross attention through ``attention(plan=)``, the row-parallel
        projections through ``tp_out``."""
        cfg = self.cfg
        rows, n, d = h.shape
        t, s = grid[0], grid[1] * grid[2]
        nh = cfg.heads // (plan.tp if plan is not None else 1)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = e.unbind(1)
        attn_kw = dict(scale=1.0 / math.sqrt(cfg.head_dim), true_d=cfg.head_dim)

        def heads(x):
            return x.unflatten(-1, (nh, cfg.head_dim))

        def attn(x):
            xn = layer_norm_mod(x, scale=sc_a, shift=sh_a, eps=cfg.eps)
            if self.cross:
                qkv = self.qkv(xn.reshape(rows * t, s, d))
                if route == "packed" and s <= MAX_GROUP_TOKENS:
                    o = grouped_attention_fused_qkv(qkv, cfg.heads, group=s, **attn_kw)
                else:
                    o = attention(*(heads(p) for p in qkv.chunk(3, -1)), plan=plan,
                                  kv_len=frame_tokens, kv_replicated=False).flatten(-2)
                return tp_out(self.proj, o, plan).reshape(rows, n, d)
            qkv = self.qkv(xn.reshape(rows, t, s, d).transpose(1, 2).reshape(rows * s, t, d))
            if route in PLAN_ROUTES:
                o = sharded_grouped_attention_fused_qkv(qkv.reshape(1, rows * s * t, -1),
                                                        cfg.heads, plan, group=t, **attn_kw)
                o = o.reshape(rows * s, t, -1)
            else:
                o = tiny_temporal_attention(qkv, None, None, None, None, nh, mode=route)
            return tp_out(self.proj, o, plan).reshape(rows, s, t, d).transpose(1, 2).reshape(
                rows, n, d)

        def cross(x):
            k, v = (heads(p) for p in self.cross_kv(y).chunk(2, -1))
            o = attention(heads(self.cross_q(x)), k, v, plan=plan, kv_replicated=True)
            return tp_out(self.cross_o, o.flatten(-2), plan).reshape(rows, n, d)

        def mlp(x):
            xm = layer_norm_mod(x, scale=sc_m, shift=sh_m, eps=cfg.eps)
            return tp_out(self.ff2, F.gelu(self.ff1(xm), approximate="tanh"), plan)

        def site(kind, compute, save=True):
            return compute() if pab is None else _pab_site(pab[0], pab[1], kind, compute, save)

        a = site("attn", lambda: attn(h))
        h = h + (g_a[:, None] * a.float()).to(h.dtype)
        if self.cross:
            h = h + site("cross", lambda: cross(h))
        mo = site("mlp", lambda: mlp(h), save=pab is not None and pab[2])
        return h + (g_m[:, None] * mo.float()).to(h.dtype)


class LatteModel(nn.Module):
    """Latte T2V. Build on ``device``, then ``init(generator)`` for random
    weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: LatteConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, p2 = cfg.hidden, cfg.patch * cfg.patch
        self.patch_embed = nn.Linear(cfg.in_channels * p2, d, device=device,
                                     dtype=cfg.torch_dtype)
        self.caption = embedder_linears(cfg.caption_dim, d, device)
        self.time = embedder_linears(cfg.time_embed_dim, d, device)
        self.adaln_single = nn.Linear(d, 6 * d, device=device)
        self.spatial = nn.ModuleList(LatteBlock(cfg, True, device)
                                     for _ in range(cfg.depth))
        self.temporal = nn.ModuleList(LatteBlock(cfg, False, device)
                                      for _ in range(cfg.depth))
        self.final_mod = nn.Parameter(torch.zeros((2, d), device=device))
        self.final_out = nn.Linear(d, cfg.c_out * p2, device=device)

    def init(self, generator: torch.Generator) -> "LatteModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.latte.init_latte_params`` draws them (the draws
        themselves differ): LeCun-normal linears with zero bias, modulation
        tables ``N(0, 1/hidden)``."""
        std = self.cfg.hidden ** -0.5

        def randn(shape):
            return torch.randn(shape, generator=generator, device=generator.device) * std

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for m in (*self.spatial, *self.temporal):
                m.scale_shift.copy_(randn(m.scale_shift.shape))
            self.final_mod.copy_(randn(self.final_mod.shape))
        return self


# PAB state slots and the mask that reads each (temporal blocks have no
# cross-attention)
PAB_SLOTS = (("sp_attn", "spatial"), ("tp_attn", "temporal"), ("sp_cross", "cross"),
             ("sp_mlp", "mlp_sp_reuse"), ("tp_mlp", "mlp_tp_reuse"))


def latte_pab_masks(pab, timesteps, depth: int) -> dict:
    """Latte's PAB masks: ``broadcast_masks`` (``bool[steps]`` per kind) and
    the block-granular MLP masks of each branch, ``mlp_{sp,tp}_{reuse,save}``
    (``bool[steps, depth]``)."""
    masks = broadcast_masks(pab, timesteps)
    for br, temporal in (("sp", False), ("tp", True)):
        mm = mlp_skip_masks(pab, timesteps, depth, temporal=temporal)
        masks[f"mlp_{br}_reuse"], masks[f"mlp_{br}_save"] = mm["reuse"], mm["save"]
    return masks


def make_latte_core(model: LatteModel, grid: Tuple[int, int, int],
                    caption_len: int, *, route: str = "packed", pab=None,
                    timesteps=None, plan=None) -> DiTCore:
    """(prepare, trunk, head) for a static patch grid (T, H, W).

    cond = {"y": f[rows, caption_len, caption_dim]}; x = latent video
    f[rows, T, H*p, W*p, C] (rows holds the joint CFG batch); the output has
    C channels (the variance half of an 8-channel head is dropped).
    ``route``: "packed", "grouped" or "vpu" (module docstring).

    ``pab`` (``core.pab.PABConfig``, any route) with the sampler's
    ``timesteps`` makes a stateful core: ``trunk(hidden, ctx, state,
    step_idx)`` reuses by ``broadcast_masks`` and, for the MLPs,
    ``mlp_skip_masks`` per block at ``step_idx`` (-1: full compute);
    ``init_state`` allocates the slots some mask can read.

    ``route="unpacked"`` and ``plan`` as ``make_stdit3_core`` takes them
    (module docstring).
    """
    cfg = model.cfg
    t_len, gh, gw = grid
    s = gh * gw
    d = cfg.hidden
    if route not in ROUTES + ("unpacked",):
        raise ValueError(f"route must be one of {ROUTES + ('unpacked',)}, got {route!r}")
    packed = False
    if plan is not None:
        model, packed = plan_setup(model, plan, route, s, pab is not None)
        if not packed:
            check_ulysses(model, plan)
    masks = None
    if pab is not None:
        if timesteps is None:
            raise ValueError("PAB needs the sampling timesteps")
        masks = latte_pab_masks(pab, timesteps, cfg.depth)
    device = model.patch_embed.weight.device
    dt = cfg.torch_dtype
    pos2d = torch.from_numpy(pos_embed_2d(d, gh, gw)).to(device)
    # [sin | cos] channel order (diffusers get_1d_sincos_pos_embed_from_grid),
    # added to the residual stream before the first temporal block only
    tcos, tsin = rope_freqs_1d(np.arange(t_len), d, 10000.0)
    temp_pos = torch.from_numpy(np.concatenate([tsin, tcos], axis=-1)[:, :d]).to(device)
    tp_tok = temp_pos[:, None].expand(t_len, s, d).reshape(t_len * s, d)
    p = cfg.patch

    def embed(mlp: nn.ModuleDict, v: torch.Tensor, act) -> torch.Tensor:
        return mlp["out"](act(mlp["in"](v)))

    @torch.inference_mode()
    def prepare(x, t, cond):
        rows = x.shape[0]
        xp = x.to(dt).reshape(rows, t_len, gh, p, gw, p, cfg.in_channels)
        xp = xp.permute(0, 1, 2, 4, 6, 3, 5).reshape(rows, t_len * s, -1)
        h = model.patch_embed(xp)
        # the f32 sincos add, kept in the compute dtype after it
        h = (h.reshape(rows, t_len, s, d) + pos2d).reshape(rows, t_len * s, d).to(dt)
        te = embed(model.time, timestep_embedding(t, cfg.time_embed_dim), F.silu)
        t6 = model.adaln_single(F.silu(te)).reshape(rows, 6, d)
        y = embed(model.caption, cond["y"].float(),
                  lambda v: F.gelu(v, approximate="tanh")).to(dt)
        return h, {"t6": t6, "te": te, "y": y}

    def sharded(ctx, hidden):
        """Under a plan: the shards' layout, the ctx cut to the rank's rows,
        the blocks' keywords of the unpacked composition on the tokens
        layout, and the temporal table's add on that layout."""
        lay = VideoShards(plan, hidden.shape[0], t_len, s)
        rows = {k: lay.rows_of(v) for k, v in ctx.items()}
        kw = dict(grid=(t_len, 1, lay.sl), route="unpacked", plan=plan,
                  frame_tokens=s if lay.sl * plan.sp != s else None)

        def add_temp(h):
            h4 = h.reshape(lay.rl, t_len, lay.sl, d)
            return (h4.float() + temp_pos[:, None]).to(h.dtype).reshape(h.shape)

        return lay, rows, kw, add_temp

    @torch.inference_mode()
    def trunk(hidden, ctx):
        h = hidden
        kw = dict(grid=grid, route=route)

        def add_temp(h):
            return (h.float() + tp_tok).to(h.dtype)

        if plan is not None:
            lay, ctx, kw, add_temp = sharded(ctx, hidden)
            if packed:
                return trunk_frames(lay, hidden, ctx, add_temp)
            h = lay.tokens(hidden).reshape(lay.rl, -1, d)
        for i, (sp, tp) in enumerate(zip(model.spatial, model.temporal)):
            h = sp(h, ctx["t6"], ctx["y"], **kw)
            if i == 0:
                h = add_temp(h)
            h = tp(h, ctx["t6"], ctx["y"], **kw)
        if plan is not None:
            return lay.gather_tokens(h.reshape(lay.rl, t_len, lay.sl, d))
        return h

    def trunk_frames(lay, hidden, ctx, add_temp):
        """The packed plan path: spatial blocks on the frames layout,
        temporal ones on the tokens layout, one all-to-all between."""
        rl = lay.rl
        h = lay.frames(hidden)
        for i, (sp, tp) in enumerate(zip(model.spatial, model.temporal)):
            h = sp(h.reshape(rl, -1, d), ctx["t6"], ctx["y"], grid=(lay.tl, 1, s),
                   route=route, plan=plan)
            h = lay.frames_to_tokens(h.reshape(rl, lay.tl, s, d)).reshape(rl, -1, d)
            if i == 0:
                h = add_temp(h)
            h = tp(h, ctx["t6"], ctx["y"], grid=(t_len, 1, lay.sl), route=route, plan=plan)
            h = lay.tokens_to_frames(h.reshape(rl, t_len, lay.sl, d))
        return lay.gather_frames(h)

    def init_state(hidden, ctx):
        """One zeroed ``[depth, rows, T*S, d]`` slot per site kind and branch
        that some mask can read (temporal blocks have no cross slot; under a
        plan the rank's tokens shard)."""
        shape = tuple(hidden.shape)
        if plan is not None:
            lay = VideoShards(plan, shape[0], t_len, s)
            shape = (lay.rl, t_len * lay.sl, shape[-1])
        return {slot: torch.zeros((cfg.depth,) + shape, dtype=hidden.dtype,
                                  device=hidden.device)
                for slot in pab_slots(masks, PAB_SLOTS)}

    @torch.inference_mode()
    def trunk_pab(hidden, ctx, state, step_idx):
        full = not 0 <= step_idx < len(masks["spatial"])
        bit = {k: np.zeros_like(m[0]) if full else m[step_idx] for k, m in masks.items()}
        h = hidden
        kw = dict(grid=grid, route=route)

        def add_temp(h):
            return (h.float() + tp_tok).to(h.dtype)

        if plan is not None:
            lay, ctx, kw, add_temp = sharded(ctx, hidden)
            h = lay.tokens(hidden).reshape(lay.rl, -1, d)
        for i, (sp, tp) in enumerate(zip(model.spatial, model.temporal)):
            for blk, br, kind in ((sp, "sp", "spatial"), (tp, "tp", "temporal")):
                slots = {site: state[f"{br}_{site}"][i] for site in ("attn", "cross", "mlp")
                         if f"{br}_{site}" in state}
                reuse = {"attn": bool(bit[kind]), "cross": bool(bit["cross"]),
                         "mlp": bool(bit[f"mlp_{br}_reuse"][i])}
                h = blk(h, ctx["t6"], ctx["y"], pab=(slots, reuse,
                                                     bool(bit[f"mlp_{br}_save"][i])), **kw)
                if i == 0 and br == "sp":
                    h = add_temp(h)
        if plan is not None:
            h = lay.gather_tokens(h.reshape(lay.rl, t_len, lay.sl, d))
        return h, state

    @torch.inference_mode()
    def head(hidden, ctx):
        mod = model.final_mod[None] + ctx["te"][:, None]
        # bf16 LayerNorm output times the f32 modulation is f32, as in JAX
        out = layer_norm(hidden, eps=cfg.eps).float() * (1 + mod[:, 1:2]) + mod[:, 0:1]
        out = model.final_out(out.to(hidden.dtype).float())
        rows = out.shape[0]
        # features ordered [p, q, c] ("nhwpqc")
        out = out.reshape(rows, t_len, gh, gw, p, p, cfg.c_out).permute(0, 1, 2, 4, 3, 5, 6)
        out = out.reshape(rows, t_len, gh * p, gw * p, cfg.c_out)
        return out[..., :cfg.in_channels]

    if masks is not None:
        return DiTCore(prepare, trunk_pab, head, init_state=init_state)
    return DiTCore(prepare, trunk, head)
