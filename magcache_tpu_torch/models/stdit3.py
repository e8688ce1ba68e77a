"""STDiT3, the Open-Sora 1.2 spatial-temporal DiT, as PyTorch modules.

Same model as ``magcache_tpu.models.stdit3`` (behavioral source
``videosys/models/transformers/open_sora_transformer_3d.py``): ``depth``
paired (spatial, temporal) blocks; each block is AdaLN-modulated
self-attention (spatial over the S patches of a frame, temporal over the T
frames at a location, with RoPE), cross-attention to the caption and an MLP,
gated 6-way by ``scale_shift_table + t6``; a T2I final layer with 2-way
modulation; a 2-D sincos position embedding with the multi-resolution scale.

``make_stdit3_core(..., route=)`` picks the block composition explicitly
(the JAX package switches on ``MAGCACHE_STDIT3_PACKED`` and
``MAGCACHE_TINY_ATTN`` and the backend; the route here depends on neither
the environment nor the device):

- ``"packed"``, the JAX package's TPU composition, through the kernels (the
  TPU's 128-lane head padding is not carried over: heads stay 72 wide):
  spatial K7 ``lnmod_matmul`` (LayerNorm + modulate + qkv projection) ->
  K5 ``grouped_attention_fused_qkv`` (one group per frame, qk-norm fused)
  for frames of at most 2,048 tokens, or K1q ``flash_attention_bshd`` with
  ``qk_gains`` on q/k/v views of the projection above that (720p) -> K8
  ``matmul_gated_residual`` (out-projection + gate + residual); temporal
  K3 ``layer_norm_mod`` -> qkv ``nn.Linear`` on the [S, T] view -> K5
  (groups of T, qk-norm and RoPE fused) -> K8 (gate, no residual) ->
  transpose back and add; cross K6 ``fused_cross_attention`` with the
  residual fused; MLP K7 with the gelu epilogue -> K8 with the residual.
- ``"grouped"`` and ``"vpu"``, the JAX package's unpacked composition (its
  default off the TPU): each attention branch starts with K3; ``nn.Linear``
  projections; temporal attention through ``tiny_temporal_attention`` with
  the q/k gains and the frame RoPE in that mode (K4 or K9); spatial
  attention as a per-head RMS norm (plain ops) and ``attention()`` (K1 at
  head dim 72 zero-padded to 128, the fixed max with qk-norm), at any frame
  size; cross-attention through ``attention()`` (K1, running max); the MLP
  K7 with gelu, then ``nn.Linear``; f32 gates.

Masked-frame conditioning (``cond["x_mask"]``, bool ``[rows, T]``: True
frames take the step's modulation, False ones the t = 0 modulation) runs the
composed block of its route instead: plain LayerNorm, both modulations and
a per-frame select; the qkv projection as ``nn.Linear``; the route's
attention (packed: K5 or K1q, and K6 with the residual; unpacked as above);
the projection; per-frame gates; an unfused MLP (linear, tanh-gelu,
linear); and the head's per-frame select between the two final modulations.

``qk_norm=False`` runs every route with the row-max softmax (the JAX packed
composition passes its fixed shift without gains, which can underflow every
p to 0; the port does not carry that over): packed K5r ("tma" route) for
frames of at most 2,048 tokens, K1 through ``attention()`` above that, K5r's
"stream" route with RoPE and no norm in the temporal blocks.

PAB (``make_stdit3_core(pab=, timesteps=)``, the JAX ``_block(cached=...)``,
on every route and with masked frames): every step runs the composed block,
whose three sites each either compute or replay the block's slot of the
trunk state by the step's host mask. On the packed route: spatial attention
K7 -> K5 (K1q above 2,048 tokens) -> ``proj``, temporal K3 -> qkv -> K5 ->
``proj``, cross-attention K6 without the residual, the MLP K7 with gelu ->
``mlp2``; on "grouped" and "vpu" the sites of their composition (K3 ->
``attention()`` or ``tiny_temporal_attention`` -> ``proj``; ``cross_q`` ->
``attention()`` -> ``cross_o``; K7 -> ``mlp2``); with masked frames the
masked modulations, K6 without the residual on the packed route and the
unfused MLP. Each site's output is cached before its gate, and the gates
and residuals run in f32 (no K8: its fused epilogue rounds elsewhere). The
state holds one ``[depth, rows, N, d]`` tensor per slot that some mask can
read.

Under a plan (``make_stdit3_core(plan=)``; the JAX package's gates at
``models/stdit3.py:216-238, 376-392, 436-452, 573-610``): the trunk takes
and returns the whole hidden, and between the two it keeps the activations
sharded (``parallel.collectives.VideoShards``): rows over dp, the spatial
blocks over frames and the temporal blocks over each frame's tokens on sp,
with one ``all_to_all`` over sp (the reference's DSP switch) between them.
On the packed route each block runs the ``sharded_*`` wrappers: K7, K5 on
the rank's ``heads / tp`` heads, K8, K6 and the MLP's K7 / K8 token-parallel
on whole weights at tp 1; at ``tp > 1`` the Megatron slices of the JAX
patterns (``parallel.shard.slice_videosys``: q, k, v and the cross
projections by heads; ``mlp1`` / ``mlp2`` match no pattern and stay whole),
each row-parallel projection ending in the f32 all-reduce over tp. Where JAX
takes its composed block under a plan (frames above 2,048 tokens, masked
frames, PAB, and ``route="unpacked"``) every block runs the unpacked
composition on the tokens layout: spatial attention through
``attention(plan=)`` (Ulysses, K1b over ``heads / (sp * tp)`` heads of each
frame), temporal attention through K5 over groups of T on the rank's
heads (the JAX ``tiny_temporal_attention`` runs its unfused composition
under a mesh; a tokens shard holds whole groups of T, so the packed
path's kernel takes the same work), cross-attention through
``attention(plan=)`` on the rank's heads (K1b). The "grouped" (K4) and "vpu"
(K9) routes take no plan: they raise, naming ``route="unpacked"`` (JAX
quietly runs its composition there).

Dtypes: in a bf16 config the block linears are bf16; the embedders, the
modulation tables, the qk-norm gains and the final layer stay f32, as the
JAX parameters are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.pab import broadcast_masks
from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import (DTYPES, embedder_linears, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.models.wan import patchify, unpatchify
from magcache_tpu_torch.ops.attention import (QKNORM_FIXED_MAX, attention,
                                              flash_attention_bshd, fused_cross_attention,
                                              split_qkv)
from magcache_tpu_torch.ops.fused_prologue import (layer_norm_mod, lnmod_matmul,
                                                   matmul_gated_residual)
from magcache_tpu_torch.ops.norms import layer_norm, rms_norm
from magcache_tpu_torch.ops.rope import rope_freqs_1d
from magcache_tpu_torch.ops.tiny_attention import tiny_temporal_attention
from magcache_tpu_torch.parallel.collectives import (VideoShards, sharded_fused_cross_attention,
                                                     sharded_grouped_attention_fused_qkv,
                                                     sharded_lnmod_matmul,
                                                     sharded_matmul_gated_residual, tp_out)
from magcache_tpu_torch.parallel.shard import slice_videosys

__all__ = ["STDiT3Config", "STDiT3Model", "STDIT3_XL_2", "ROUTES", "PLAN_ROUTES",
           "make_stdit3_core", "pos_embed_2d", "plan_setup"]

ROUTES = ("packed", "grouped", "vpu")
# under a plan: the packed route, or the JAX package's composition there
PLAN_ROUTES = ("packed", "unpacked")

# frames up to this many tokens run K5 with one group per frame; larger ones
# run K1q (the JAX package's route, chosen by shape only)
MAX_GROUP_TOKENS = 2048


@dataclasses.dataclass(frozen=True)
class STDiT3Config:
    hidden: int = 1152
    heads: int = 16
    depth: int = 28                     # paired spatial + temporal blocks
    mlp_ratio: int = 4
    in_channels: int = 4
    caption_dim: int = 4096
    patch: Tuple[int, int, int] = (1, 2, 2)
    freq_dim: int = 256
    caption_max_len: int = 300
    qk_norm: bool = True
    input_sq_size: int = 512            # multi-resolution pos-embed base
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2     # mean + variance; RFLOW takes chunk 0

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
    def tiny(**kw) -> "STDiT3Config":
        d = dict(hidden=64, heads=4, depth=2, caption_dim=24, freq_dim=32,
                 caption_max_len=4)
        d.update(kw)
        return STDiT3Config(**d)


# Open-Sora 1.2: STDiT3-XL/2
STDIT3_XL_2 = STDiT3Config()


def pos_embed_2d(dim: int, gh: int, gw: int, scale: float = 1.0,
                 base_size: Optional[int] = None) -> np.ndarray:
    """2-D sincos position embedding ``f32[gh*gw, dim]`` over the spatial
    patch grid, with the multi-resolution coordinates
    ``arange(g) / scale * base_size / g``."""
    def emb_1d(pos, d):
        omega = 1.0 / 10000.0 ** (np.arange(d // 2) / (d / 2))
        out = pos[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    hh = np.arange(gh) / scale
    ww = np.arange(gw) / scale
    if base_size is not None:
        hh = hh * (base_size / gh)
        ww = ww * (base_size / gw)
    ys, xs = np.meshgrid(hh, ww, indexing="ij")
    e = np.concatenate([emb_1d(ys.reshape(-1), dim // 2),
                        emb_1d(xs.reshape(-1), dim // 2)], axis=1)
    return e.astype(np.float32)


def _param(shape, device, fill: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=torch.float32, device=device))


class STDiT3Block(nn.Module):
    """One spatial or temporal block; parameter names follow the JAX keys."""

    def __init__(self, cfg: STDiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.scale_shift = _param((6, d), device, 0.0)
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        self.cross_q, self.cross_kv, self.cross_o = lin(d, d), lin(d, 2 * d), lin(d, d)
        self.mlp1, self.mlp2 = lin(d, cfg.mlp_ratio * d), lin(cfg.mlp_ratio * d, d)
        if cfg.qk_norm:
            self.q_norm = _param((cfg.head_dim,), device, 1.0)
            self.k_norm = _param((cfg.head_dim,), device, 1.0)

    def forward(self, h: torch.Tensor, t6: torch.Tensor, y: torch.Tensor, *,
                grid: Tuple[int, int, int], temporal: bool, route: str = "packed",
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                x_mask: Optional[torch.Tensor] = None,
                t6_zero: Optional[torch.Tensor] = None,
                pab: Optional[Tuple[dict, dict]] = None, plan=None,
                frame_tokens: Optional[int] = None) -> torch.Tensor:
        """One block on ``h`` ``[rows, T*S, d]`` on ``route``; with ``x_mask``
        (bool ``[rows, T]``) and ``t6_zero`` the masked-frame composition.
        ``rope``: the frame tables ``[T, D/2]`` (temporal blocks). ``pab``:
        ``(slots, reuse)``, the block's PAB slots (``"attn"``, ``"cross"``,
        ``"mlp"`` -> ``[rows, T*S, d]`` or absent) and this step's reuse
        bits per site. ``plan``: h is a rank's shard (module docstring) of
        ``grid``'s local counts and the block holds the rank's tp slices;
        ``frame_tokens``: a frame's real tokens where the tokens layout pads
        them (the Ulysses keys past it are masked)."""
        e = (self.scale_shift[None] + t6).float()          # [rows, 6, d]
        if pab is None and x_mask is None and route == "packed":
            return self._packed(h, e, y, grid, temporal, rope, plan)
        e0 = None if x_mask is None else (self.scale_shift[None] + t6_zero).float()
        return self._composed(h, e, e0, y, x_mask, grid, temporal, rope, route, pab,
                              plan, frame_tokens)

    def _packed(self, h, e, y, grid, temporal, rope, plan=None) -> torch.Tensor:
        """The fused packed block: K7/K3, K5 (K1q), K8, K6 with the residual,
        K7 with gelu, K8, through the ``sharded_*`` wrappers: under ``plan``
        on a rank's shard (a spatial block's frames, a temporal block's
        tokens), K5 on the rank's heads and, at ``tp > 1``, the row-parallel
        all-reduces in place of K8's GEMM and K6."""
        cfg = self.cfg
        rows, n, d = h.shape
        t, s = grid[0], grid[1] * grid[2]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = e.unbind(1)
        if temporal:
            xn = layer_norm_mod(h, scale=sc_a, shift=sh_a, eps=cfg.eps)
            a = self._temporal_attn(xn, grid, rope, plan)
            a = sharded_matmul_gated_residual(a, self.proj, g_a, None, plan, rows_out=t,
                                              batch_repeat=s)
            h = h + a.reshape(rows, s, t, d).transpose(1, 2).reshape(rows, n, d)
        else:
            hf = h.reshape(rows * t, s, d)
            qkv = sharded_lnmod_matmul(hf, sc_a, sh_a, self.qkv, plan, eps=cfg.eps,
                                       batch_repeat=t)
            o = self._spatial_attn(qkv, plan)
            h = sharded_matmul_gated_residual(o, self.proj, g_a, hf, plan,
                                              batch_repeat=t).reshape(rows, n, d)
        h = self._cross(h, y, plan=plan)
        # the JAX patterns leave mlp1 / mlp2 whole: token-parallel K7 and K8
        y1 = lnmod_matmul(h, sc_m, sh_m, self.mlp1.weight, self.mlp1.bias,
                          act="gelu", eps=cfg.eps)
        return matmul_gated_residual(y1, self.mlp2.weight, self.mlp2.bias, g_m, h)

    def _gains(self):
        """The q/k gains, or ``(None, None)`` without qk-norm."""
        return (self.q_norm, self.k_norm) if self.cfg.qk_norm else (None, None)

    def _attn_kw(self) -> dict:
        """The packed kernels' arguments: with qk-norm the gains and the
        fixed softmax shift, without it neither (the row max)."""
        cfg = self.cfg
        kw = dict(scale=1.0 / math.sqrt(cfg.head_dim), true_d=cfg.head_dim)
        if cfg.qk_norm:
            kw.update(qk_gains=self._gains(), eps=1e-6, fixed_max=QKNORM_FIXED_MAX)
        return kw

    def _spatial_attn(self, qkv: torch.Tensor, plan=None) -> torch.Tensor:
        """Attention within each frame of ``qkv`` ``[frames, S, 3*d]``: K5
        (K5r without qk-norm) with one group per frame up to 2,048 tokens
        (under ``plan`` on the rank's heads), else K1q on q/k/v views of the
        projection (without qk-norm K1 through ``attention()``, running max).
        Returns ``[frames, S, d]``."""
        frames, s, three_d = qkv.shape
        heads = self.cfg.heads
        if s <= MAX_GROUP_TOKENS:
            return sharded_grouped_attention_fused_qkv(qkv, heads, plan, group=s,
                                                       **self._attn_kw())
        q, k, v = split_qkv(qkv, heads)
        if self.cfg.qk_norm:
            o = flash_attention_bshd(q, k, v, **self._attn_kw())
        else:
            o = attention(q, k, v, scale=1.0 / math.sqrt(self.cfg.head_dim))
        return o.reshape(frames, s, three_d // 3)

    def _temporal_attn(self, xn: torch.Tensor, grid, rope, plan=None) -> torch.Tensor:
        """qkv projection of the [S, T] view of ``xn`` and K5 over groups of
        T with RoPE (under ``plan`` on the rank's heads). Returns the
        attention ``[rows*S, T, heads*D]``."""
        t, hh, ww = grid
        rows, _, d = xn.shape
        s = hh * ww
        xr = xn.reshape(rows, t, s, d).transpose(1, 2).reshape(rows * s, t, d)
        qkv = self.qkv(xr)
        o = sharded_grouped_attention_fused_qkv(qkv.reshape(1, rows * s * t, -1),
                                                self.cfg.heads, plan, group=t,
                                                rope_tables=rope, **self._attn_kw())
        return o.reshape(rows * s, t, -1)

    def _cross(self, h: torch.Tensor, y: torch.Tensor, residual: bool = True,
               plan=None) -> torch.Tensor:
        """K6: cross-attention to the caption, with the residual or without
        it (PAB caches the branch alone); under ``plan`` at ``tp > 1`` its
        composition on the rank's heads."""
        k, v = (c.contiguous() for c in self.cross_kv(y).chunk(2, -1))
        kw = dict(scale=1.0 / math.sqrt(self.cfg.head_dim), true_d=self.cfg.head_dim,
                  residual=residual)
        if plan is None:
            return fused_cross_attention(h, self.cross_q.weight, self.cross_q.bias, k, v,
                                         self.cross_o.weight, self.cross_o.bias,
                                         self.cfg.heads, **kw)
        return sharded_fused_cross_attention(h, self.cross_q, k, v, self.cross_o,
                                             self.cfg.heads, plan, **kw)

    def _composed(self, h, e, e0, y, x_mask, grid, temporal, rope, route,
                  pab: Optional[Tuple[dict, dict]], plan=None,
                  frame_tokens: Optional[int] = None) -> torch.Tensor:
        """The block as three sites and two f32 gates (JAX ``_block`` off
        its fused packed path): the unpacked routes, masked frames and PAB,
        on every route. Under ``pab`` each site replays its slot where the
        step's ``reuse`` bit says so, else computes (and refreshes the
        slot); outputs are cached before their gates.

        - attention: the unpacked routes K3 (or the masked modulation) and
          ``_unpacked_attn``; packed temporal the same into K5 over groups
          of T; packed spatial K7 (masked: the modulation and ``qkv``) into
          K5 (K1q above 2,048 tokens); then ``proj``;
        - cross-attention: packed K6 (without the residual under PAB), the
          unpacked routes ``_unpacked_cross``;
        - the MLP: K7 with gelu, then ``mlp2``; with masked frames the
          modulation, ``mlp1``, tanh-gelu, ``mlp2``.

        With ``x_mask`` each modulation and gate takes the step's values
        (``e``) on frames where it is True and the t = 0 values (``e0``)
        elsewhere. Under ``plan`` (the unpacked route on a tokens shard) the
        attention and cross sites run on the rank's heads through
        ``attention(plan=)`` and their projections end in ``tp_out``."""
        cfg = self.cfg
        rows, n, d = h.shape
        t, s = grid[0], grid[1] * grid[2]
        packed = route == "packed"
        mods = e.unbind(1)                          # sh_a, sc_a, g_a, sh_m, sc_m, g_m
        zero = None if x_mask is None else e0.unbind(1)

        def modulate(x, i):
            """The modulation at ``(shift, scale) = mods[i], mods[i + 1]``."""
            sh, sc = mods[i], mods[i + 1]
            if x_mask is None:
                return layer_norm_mod(x, scale=sc, shift=sh, eps=cfg.eps)
            # bf16 LayerNorm times f32 modulations is f32, as in JAX
            nx = layer_norm(x, eps=cfg.eps)
            z_sh, z_sc = zero[i][:, None], zero[i + 1][:, None]
            return _tmask_select(x_mask, nx * (1 + sc[:, None]) + sh[:, None],
                                 nx * (1 + z_sc) + z_sh, t).to(x.dtype)

        def gated(x, res, i):
            """``x`` plus ``res`` under the gate ``mods[i]``, in f32."""
            r = res.float()
            g = mods[i][:, None] * r
            if x_mask is not None:
                g = _tmask_select(x_mask, g, zero[i][:, None] * r, t)
            return x + g.to(x.dtype)

        def attn(x):
            if not packed:
                return self._unpacked_attn(modulate(x, 0), grid, temporal, rope, route,
                                           plan, frame_tokens)
            if temporal:
                a = self.proj(self._temporal_attn(modulate(x, 0), grid, rope))
                return a.reshape(rows, s, t, d).transpose(1, 2).reshape(rows, n, d)
            if x_mask is None:
                qkv = lnmod_matmul(x.reshape(rows * t, s, d), mods[1], mods[0],
                                   self.qkv.weight, self.qkv.bias, eps=cfg.eps,
                                   batch_repeat=t)
            else:
                qkv = self.qkv(modulate(x, 0).reshape(rows * t, s, d))
            return self.proj(self._spatial_attn(qkv)).reshape(rows, n, d)

        def cross(x, residual):
            if packed:
                return self._cross(x, y, residual=residual)
            c = self._unpacked_cross(x, y, plan)
            return x + c if residual else c

        def mlp(x):
            if x_mask is None:
                return self.mlp2(lnmod_matmul(x, mods[4], mods[3], self.mlp1.weight,
                                              self.mlp1.bias, act="gelu", eps=cfg.eps))
            return self.mlp2(F.gelu(self.mlp1(modulate(x, 3)), approximate="tanh"))

        def site(kind, compute):
            return compute() if pab is None else _pab_site(*pab, kind, compute)

        h = gated(h, site("attn", lambda: attn(h)), 2)
        if pab is None:
            h = cross(h, True)
        else:
            h = h + site("cross", lambda: cross(h, False))
        return gated(h, site("mlp", lambda: mlp(h)), 5)

    def _unpacked_attn(self, xn, grid, temporal, rope, route, plan=None,
                       frame_tokens=None) -> torch.Tensor:
        """The unpacked self-attention branch on the modulated ``xn``
        ``[rows, T*S, d]``, projections included: temporal through
        ``tiny_temporal_attention`` in mode ``route`` (the gains and the
        frame RoPE inside), on the "unpacked" route through K5 over groups
        of T on the rank's heads (``_temporal_attn``, the packed plan
        path's kernel: a tokens shard holds whole groups); spatial as the
        per-head RMS norm and ``attention()`` (JAX ``_attn``; under ``plan``
        Ulysses over the frame's tokens). Returns ``[rows, T*S, d]``."""
        cfg = self.cfg
        rows, n, d = xn.shape
        t, s = grid[0], grid[1] * grid[2]
        heads = cfg.heads // (plan.tp if plan is not None else 1)
        if temporal:
            if route == "unpacked":
                o = self._temporal_attn(xn, grid, rope, plan)
            else:
                xr = xn.reshape(rows, t, s, d).transpose(1, 2).reshape(rows * s, t, d)
                o = tiny_temporal_attention(self.qkv(xr), *self._gains(), *rope, heads,
                                            eps=1e-6, mode=route)
            return tp_out(self.proj, o, plan).reshape(rows, s, t, d).transpose(1, 2).reshape(
                rows, n, d)
        q, k, v = split_qkv(self.qkv(xn.reshape(rows * t, s, d)), heads)
        if cfg.qk_norm:
            # per-head RMS qk-norm bounds the scores: the fixed shift is exact
            q, k = rms_norm(q, self.q_norm, eps=1e-6), rms_norm(k, self.k_norm, eps=1e-6)
        o = attention(q, k, v, fixed_max=QKNORM_FIXED_MAX if cfg.qk_norm else None,
                      plan=plan, kv_len=frame_tokens, kv_replicated=False)
        return tp_out(self.proj, o.flatten(-2), plan).reshape(rows, n, d)

    def _unpacked_cross(self, h: torch.Tensor, y: torch.Tensor, plan=None) -> torch.Tensor:
        """The cross-attention branch to the caption through ``attention()``
        (running max; under ``plan`` the rank's heads), without the
        residual."""
        cfg = self.cfg
        rows, n, d = h.shape

        def heads(x):
            return x.unflatten(-1, (-1, cfg.head_dim))

        k, v = (heads(p) for p in self.cross_kv(y).chunk(2, -1))
        o = attention(heads(self.cross_q(h)), k, v, plan=plan, kv_replicated=True)
        return tp_out(self.cross_o, o.flatten(-2), plan).reshape(rows, n, d)


def _pab_site(slots: dict, reuse: dict, kind: str, compute,
              save: bool = True) -> torch.Tensor:
    """One PAB site: the slot's cached output when this step reuses it, else
    ``compute()``, written into the slot when there is one and ``save``."""
    slot = slots.get(kind)
    if reuse[kind]:
        return slot
    out = compute()
    if slot is not None and save:
        slot.copy_(out)
    return out


# PAB state slots (branch and site) and the mask that reads each
PAB_SLOTS = (("sp_attn", "spatial"), ("tp_attn", "temporal"), ("sp_cross", "cross"),
             ("tp_cross", "cross"), ("sp_mlp", "mlp"), ("tp_mlp", "mlp"))


def pab_slots(masks: dict, kinds) -> list:
    """The PAB state's slot names that some mask can read: ``(slot, mask
    key)`` pairs in ``kinds`` whose ``bool[steps]`` mask has a True."""
    return [slot for slot, key in kinds if np.asarray(masks[key]).any()]


def _tmask_select(x_mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  t: int) -> torch.Tensor:
    """Per-frame select over ``[rows, T*S, d]`` (JAX ``_tmask_select``): True
    frames of ``x_mask`` ``[rows, T]`` take ``a``, the others ``b``."""
    rows = a.shape[0]
    keep = x_mask.reshape(rows, t, 1, 1)
    return torch.where(keep, a.reshape(rows, t, -1, a.shape[-1]),
                       b.reshape(rows, t, -1, b.shape[-1])).reshape(a.shape)


class STDiT3Final(nn.Module):
    def __init__(self, cfg: STDiT3Config, device=None):
        super().__init__()
        self.scale_shift = _param((2, cfg.hidden), device, 0.0)
        self.out = nn.Linear(cfg.hidden, cfg.patch_out, device=device)


class STDiT3Model(nn.Module):
    """STDiT3. Build on ``device``, then ``init(generator)`` for random
    weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: STDiT3Config, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden
        self.y_null = _param((cfg.caption_max_len, cfg.caption_dim), device, 0.0)
        self.patch_embed = nn.Linear(cfg.patch_in, d, device=device)
        self.t_embed = embedder_linears(cfg.freq_dim, d, device)
        self.fps_embed = embedder_linears(cfg.freq_dim, d, device)
        self.t_block = nn.Linear(d, 6 * d, device=device)
        self.y_embed = embedder_linears(cfg.caption_dim, d, device)
        self.spatial = nn.ModuleList(STDiT3Block(cfg, device) for _ in range(cfg.depth))
        self.temporal = nn.ModuleList(STDiT3Block(cfg, device) for _ in range(cfg.depth))
        self.final = STDiT3Final(cfg, device)

    def init(self, generator: torch.Generator) -> "STDiT3Model":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.stdit3.init_stdit3_params`` draws them (the
        draws themselves differ): LeCun-normal linears with zero bias,
        modulation tables ``N(0, 1/hidden)``, unit qk-norm gains, and the
        null caption ``N(0, 1/caption_dim)``."""
        cfg = self.cfg

        def randn(shape, std):
            return torch.randn(shape, generator=generator,
                               device=generator.device) * std

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for m in (*self.spatial, *self.temporal, self.final):
                m.scale_shift.copy_(randn(m.scale_shift.shape, cfg.hidden ** -0.5))
            self.y_null.copy_(randn(self.y_null.shape, cfg.caption_dim ** -0.5))
        return self


def plan_setup(model: nn.Module, plan, route: str, s: int, composed: bool):
    """``(model, packed)`` of a spatial-temporal trunk under ``plan``: the
    model as the rank's tp slice (views, ``slice_videosys``) and whether
    the blocks run the packed plan path (the packed route, frames of at most
    2,048 tokens and not ``composed``: PAB) or the unpacked composition.
    Raises for the "grouped" and "vpu" routes and for heads that do not
    divide by tp."""
    kind = type(model).__name__
    if route not in PLAN_ROUTES:
        raise ValueError(f"{kind} route {route!r} under a plan: its kernel ("
                         f"{'K4' if route == 'grouped' else 'K9'}) takes no plan; take "
                         f"route=\"unpacked\", the composition the JAX package runs there")
    heads, tp = model.cfg.heads, plan.tp
    if heads % tp:
        raise ValueError(f"tp = {tp}: {kind}'s {heads} heads do not divide by tp")
    sliced = getattr(model, "tp_slice", None)
    if tp > 1 and sliced is None:       # local ranks: views of the one whole model
        model = slice_videosys(model, plan.tp_rank, tp)
    elif (sliced or (0, 1)) != (plan.tp_rank, tp):
        raise ValueError(f"{kind}: the model holds tp slice {sliced}, the plan is tp rank "
                         f"{plan.tp_rank} of {tp}")
    return model, route == "packed" and s <= MAX_GROUP_TOKENS and not composed


def check_ulysses(model: nn.Module, plan) -> None:
    """Raises unless the unpacked composition's Ulysses attention can split
    the heads: ``heads / (sp * tp)`` a rank."""
    heads, sp, tp = model.cfg.heads, plan.sp, plan.tp
    if (heads // tp) % sp:
        raise ValueError(f"sp {sp} x tp {tp}: {type(model).__name__}'s {heads} heads over "
                         f"{sp * tp} ranks leave {heads / (sp * tp):g} a rank; the unpacked "
                         f"composition's Ulysses attention needs heads / (sp * tp) whole")


def make_stdit3_core(model: STDiT3Model, grid: Tuple[int, int, int], *,
                     route: str = "packed", pab=None,
                     timesteps: Optional[np.ndarray] = None,
                     pixel_size: Optional[Tuple[int, int]] = None, plan=None) -> DiTCore:
    """(prepare, trunk, head) for a static latent patch grid (T, H, W).

    cond = {"y": f[rows, caption_len, caption_dim], "fps": f[rows]
            [, "x_mask": bool[rows, T], masked-frame conditioning]}
    x    = latent video f[rows, T*pt, H*ph, W*pw, C] (rows holds the joint
           CFG batch); the output has 2*C channels (RFLOW takes the first C).

    ``pixel_size`` (H_px, W_px) switches on the multi-resolution position
    embedding: scale = sqrt(H_px*W_px) / input_sq_size, base_size =
    round(sqrt(S)). ``route``: "packed", "grouped" or "vpu" (module
    docstring).

    ``pab`` (``core.pab.PABConfig``, any route) with the sampler's
    ``timesteps`` makes a stateful core: ``trunk(hidden, ctx, state,
    step_idx)`` reuses each site by ``broadcast_masks(pab, timesteps)`` at
    ``step_idx`` (-1: full compute) and ``init_state`` allocates the slots
    some mask can read.

    ``route="unpacked"`` is the JAX package's composition under a mesh,
    with the temporal attention through K5 over groups of T. With ``plan``
    the core is one rank's (module docstring): prepare and head run whole
    on every rank, the trunk takes and returns the whole hidden and keeps
    its shards between them, and a PAB state holds the rank's shard. Raises ``ValueError`` for the
    "grouped" and "vpu" routes, for heads that do not divide by tp, and
    (where the unpacked composition runs) for ``heads / tp`` that does not
    divide by sp, naming the counts.
    """
    cfg = model.cfg
    t_len, gh, gw = grid
    s = gh * gw
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
        masks = broadcast_masks(pab, timesteps)
    device = model.patch_embed.weight.device
    d = cfg.hidden
    if pixel_size is not None:
        scale = float(np.sqrt(pixel_size[0] * pixel_size[1]) / cfg.input_sq_size)
        pos = pos_embed_2d(d, gh, gw, scale=scale, base_size=round(np.sqrt(s)))
    else:
        pos = pos_embed_2d(d, gh, gw)
    pos2d = torch.from_numpy(pos).to(device)
    # frame RoPE [T, D/2] (JAX ``rope_freqs_1d(arange(T))``; K5's in-group
    # tables, since its groups are exactly T)
    rope = tuple(torch.from_numpy(a).to(device)
                 for a in rope_freqs_1d(np.arange(t_len), cfg.head_dim))

    def embed(mlp: nn.ModuleDict, v: torch.Tensor) -> torch.Tensor:
        return mlp["out"](F.silu(mlp["in"](timestep_embedding(v, cfg.freq_dim))))

    @torch.inference_mode()
    def prepare(x, t, cond):
        dt = cfg.torch_dtype
        rows = x.shape[0]
        # bf16 tokens times the f32 patch weight promote to f32 (as in JAX)
        h = model.patch_embed(patchify(cfg, x.to(dt)).float())
        h = (h.reshape(rows, t_len, s, d) + pos2d).reshape(rows, t_len * s, d).to(dt)
        fps = cond.get("fps")
        if fps is None:
            fps = torch.full((rows,), 24.0, dtype=torch.float32, device=x.device)
        fps_e = embed(model.fps_embed, fps)
        te = embed(model.t_embed, t) + fps_e
        t6 = model.t_block(F.silu(te)).reshape(rows, 6, d)
        y = F.gelu(model.y_embed["in"](cond["y"].float()), approximate="tanh")
        y = model.y_embed["out"](y).to(dt)
        ctx = {"t6": t6, "te": te, "y": y}
        if "x_mask" in cond:
            # masked-frame conditioning: frames outside x_mask ride the t = 0
            # modulation (t_mask_select of the reference)
            te0 = embed(model.t_embed, torch.zeros_like(t)) + fps_e
            ctx.update(t6_zero=model.t_block(F.silu(te0)).reshape(rows, 6, d),
                       te_zero=te0, x_mask=cond["x_mask"])
        return h, ctx

    def sharded(ctx, hidden):
        """Under a plan: the shards' layout, the ctx's per-row tensors cut to
        the rank's rows, and the blocks' keywords of the unpacked
        composition on the tokens layout."""
        lay = VideoShards(plan, hidden.shape[0], t_len, s)
        rows = {k: lay.rows_of(v) if torch.is_tensor(v) else v for k, v in ctx.items()}
        kw = dict(grid=(t_len, 1, lay.sl), route="unpacked", x_mask=rows.get("x_mask"),
                  t6_zero=rows.get("t6_zero"), plan=plan,
                  frame_tokens=s if lay.sl * plan.sp != s else None)
        return lay, rows, kw

    @torch.inference_mode()
    def trunk(hidden, ctx):
        h = hidden
        kw = dict(grid=grid, route=route, x_mask=ctx.get("x_mask"),
                  t6_zero=ctx.get("t6_zero"))
        if plan is not None:
            lay, ctx, kw = sharded(ctx, hidden)
            if packed and "x_mask" not in ctx:
                return trunk_frames(lay, hidden, ctx)
            h = lay.tokens(hidden).reshape(lay.rl, -1, cfg.hidden)
        for sp, tp in zip(model.spatial, model.temporal):
            h = sp(h, ctx["t6"], ctx["y"], temporal=False, **kw)
            h = tp(h, ctx["t6"], ctx["y"], temporal=True, rope=rope, **kw)
        if plan is not None:
            return lay.gather_tokens(h.reshape(lay.rl, t_len, lay.sl, -1))
        return h

    def trunk_frames(lay, hidden, ctx):
        """The packed plan path: spatial blocks on the frames layout,
        temporal ones on the tokens layout, one all-to-all between."""
        d, rl = cfg.hidden, lay.rl
        h = lay.frames(hidden)
        for sp, tp in zip(model.spatial, model.temporal):
            h = sp(h.reshape(rl, -1, d), ctx["t6"], ctx["y"], grid=(lay.tl, 1, s),
                   temporal=False, plan=plan)
            h = lay.frames_to_tokens(h.reshape(rl, lay.tl, s, d))
            h = tp(h.reshape(rl, -1, d), ctx["t6"], ctx["y"], grid=(t_len, 1, lay.sl),
                   temporal=True, rope=rope, plan=plan)
            h = lay.tokens_to_frames(h.reshape(rl, t_len, lay.sl, d))
        return lay.gather_frames(h)

    def init_state(hidden, ctx):
        """One zeroed ``[depth, rows, T*S, d]`` slot per site kind and branch
        that some mask can read (under a plan the rank's tokens shard)."""
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
        bit = {k: (not full) and bool(m[step_idx]) for k, m in masks.items()}
        kw = dict(grid=grid, route=route, x_mask=ctx.get("x_mask"),
                  t6_zero=ctx.get("t6_zero"))
        h = hidden
        if plan is not None:
            lay, ctx, kw = sharded(ctx, hidden)
            h = lay.tokens(hidden).reshape(lay.rl, -1, cfg.hidden)
        for i, (sp, tp) in enumerate(zip(model.spatial, model.temporal)):
            for blk, br, kind in ((sp, "sp", "spatial"), (tp, "tp", "temporal")):
                slots = {site: state[f"{br}_{site}"][i] for site in ("attn", "cross", "mlp")
                         if f"{br}_{site}" in state}
                reuse = {"attn": bit[kind], "cross": bit["cross"], "mlp": bit["mlp"]}
                h = blk(h, ctx["t6"], ctx["y"], temporal=br == "tp",
                        rope=rope if br == "tp" else None, pab=(slots, reuse), **kw)
        if plan is not None:
            h = lay.gather_tokens(h.reshape(lay.rl, t_len, lay.sl, -1))
        return h, state

    @torch.inference_mode()
    def head(hidden, ctx):
        fin = model.final
        # bf16 LayerNorm output times f32 modulation promotes to f32 in JAX
        n = layer_norm(hidden, eps=cfg.eps).float()

        def modulate(te):
            mod = fin.scale_shift[None] + te[:, None]
            return n * (1 + mod[:, 1:2]) + mod[:, 0:1]

        out = modulate(ctx["te"])
        if "x_mask" in ctx:
            out = _tmask_select(ctx["x_mask"], out, modulate(ctx["te_zero"]), t_len)
        out = fin.out(out.to(hidden.dtype).float())
        return unpatchify(cfg, out, grid)

    if masks is not None:
        return DiTCore(prepare, trunk_pab, head, init_state=init_state)
    return DiTCore(prepare, trunk, head)
