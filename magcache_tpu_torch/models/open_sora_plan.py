"""Open-Sora-Plan v1.2's T2V DiT (full 3-D attention) as PyTorch modules.

Same model as ``magcache_tpu.models.open_sora_plan`` (behavioral source
``videosys/models/transformers/open_sora_plan_v120_transformer_3d.py``,
``OpenSoraT2V``): ``depth`` single-stream PixArt-style blocks with
AdaLN-single modulation (one 6-way modulation from the timestep, plus each
block's ``scale_shift`` table); self-attention over all T*H*W tokens at once
with RoPE3D (the head dim split into three equal (t, y, x) parts, each
rotated half-split: ``x * cos + rotate_half(x) * sin``); cross-attention to
the caption on the un-normed stream; a tanh-gelu MLP; a 2-way final
modulation. The head's features are ordered [pt, ph, pw, c] and it returns
the first ``in_channels`` of ``out_channels`` (published: 8, eps and
variance). v1.0 and v1.1 are Latte-style factorised stacks and run on
``models.latte`` (``pipelines/open_sora_plan.py``).

``make_osp_core(..., route=)`` picks the block composition explicitly (the
JAX package switches on ``MAGCACHE_STDIT3_PACKED`` and the backend; the
route here depends on neither the environment nor the device):

- ``"packed"``, the JAX package's TPU composition through the kernels: K7
  ``lnmod_matmul`` (LayerNorm + modulate + qkv) -> RoPE3D as f32 ops on the
  q and k views -> K1 through ``attention()`` (head dim 72 zero-padded to
  128, running max: OSP has no qk-norm) -> K8 ``matmul_gated_residual``
  (out-projection + gate + residual) -> ``cross_kv`` as ``nn.Linear``, then
  K6 ``fused_cross_attention`` with the residual -> K7 with gelu (ff1) ->
  K8 (ff2 + gate + residual). The TPU's 128-lane head layout and its
  permutation-matmul rotation are not carried over.
- ``"unpacked"``, the JAX package's composition off the TPU: K3
  ``layer_norm_mod``, ``nn.Linear`` projections, ``attention()`` for self-
  and cross-attention (K1 padded), the MLP as K3 -> ``ff1`` -> gelu ->
  ``ff2``, gates in f32.

PAB (``make_osp_core(pab=, timesteps=)``, the JAX ``trunk_pab``) runs the
unpacked block, whose three sites (self-attention "spatial", cross "cross",
MLP "mlp") each replay the block's slot of the trunk state or compute and
refresh it by the step's host mask; ``init_state`` allocates only the slots
that some mask can read (v1.2's spatial and cross windows: 2 of 3).

Under a plan (``make_osp_core(plan=)``) the trunk runs the unpacked
blocks, as the JAX package turns its packed path off under a mesh
(``models/open_sora_plan.py:326``), on the rank's shard: rows over dp, the
T*H*W tokens over sp (``parallel.collectives.VideoShards`` of one "frame";
zero tokens pad an uneven count and are masked as keys), the heads and the
MLP over tp (``parallel.shard.slice_videosys``). The full 3-D attention
goes through ``attention(plan=)`` (Ulysses: K1b over ``heads / (sp * tp)``
heads of every token), cross-attention through it on the rank's heads
(K1b), and every row-parallel projection ends in the f32 all-reduce over
tp. PAB runs on the same shards.

Dtypes: in a bf16 config the patch embedding and the block linears are
bf16; the embedders, the modulation tables and the final layer stay f32, as
the JAX parameters are.
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
from magcache_tpu_torch.models.stdit3 import _pab_site, check_ulysses, pab_slots, plan_setup
from magcache_tpu_torch.models.wan import patchify
from magcache_tpu_torch.ops.attention import attention, fused_cross_attention
from magcache_tpu_torch.ops.fused_prologue import (layer_norm_mod, lnmod_matmul,
                                                   matmul_gated_residual)
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.parallel.collectives import VideoShards, tp_out

__all__ = ["OpenSoraPlanConfig", "OSPModel", "OSP_V120", "ROUTES", "make_osp_core",
           "osp_rope_tables", "rope_half"]

ROUTES = ("packed", "unpacked")


@dataclasses.dataclass(frozen=True)
class OpenSoraPlanConfig:
    hidden: int = 1152
    heads: int = 16
    depth: int = 28
    mlp_ratio: int = 4
    in_channels: int = 4
    out_channels: int = 0            # 0 -> in_channels
    caption_dim: int = 4096
    patch: Tuple[int, int, int] = (1, 2, 2)
    time_embed_dim: int = 256
    interpolation_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rope_theta: float = 10000.0
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

    @property
    def patch_in(self) -> int:
        return self.in_channels * math.prod(self.patch)

    @staticmethod
    def tiny(**kw) -> "OpenSoraPlanConfig":
        d = dict(hidden=96, heads=4, depth=2, caption_dim=24, time_embed_dim=32)
        d.update(kw)
        return OpenSoraPlanConfig(**d)


# Open-Sora-Plan v1.2 as the JAX package's pipeline builds it: eps + variance
OSP_V120 = OpenSoraPlanConfig(out_channels=8)

# PAB state slots and the mask that reads each
PAB_SLOTS = (("attn", "spatial"), ("cross", "cross"), ("mlp", "mlp"))


def osp_rope_tables(cfg: OpenSoraPlanConfig, grid: Tuple[int, int, int]):
    """RoPE3D (cos, sin) f32 tables ``[T*H*W, head_dim]``: the head dim in
    three equal (t, y, x) parts, each ``cat(freqs, freqs)`` (half-split
    layout), positions divided by the per-axis interpolation scale;
    computed in f64."""
    hd = cfg.head_dim
    if hd % 3 or (hd // 3) % 2:
        raise ValueError(f"head_dim {hd} is not RoPE3D-able (three even parts)")
    d3 = hd // 3
    coords = np.stack(np.meshgrid(*[np.arange(g) for g in grid], indexing="ij"),
                      -1).reshape(-1, 3)
    inv_freq = 1.0 / cfg.rope_theta ** (np.arange(0, d3, 2, dtype=np.float64) / d3)
    cos_p, sin_p = [], []
    for ax in range(3):
        f = (coords[:, ax] / cfg.interpolation_scale[ax])[:, None] * inv_freq[None]
        f = np.concatenate([f, f], axis=-1)
        cos_p.append(np.cos(f))
        sin_p.append(np.sin(f))
    return (np.concatenate(cos_p, -1).astype(np.float32),
            np.concatenate(sin_p, -1).astype(np.float32))


def rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE3D on ``x`` ``[rows, N, H, D]`` with ``[N, D]`` tables: in f32,
    each third of the head dim rotated half-split (``rotate_half``: the
    third's halves swapped, the first negated); returns x's dtype."""
    x32 = x.float()
    parts = x32.unflatten(-1, (3, 2, -1))
    rot = torch.stack((-parts[..., 1, :], parts[..., 0, :]), dim=-2).flatten(-3)
    return (x32 * cos[:, None] + rot * sin[:, None]).to(x.dtype)


class OSPBlock(nn.Module):
    """One block; parameter names follow the JAX keys."""

    def __init__(self, cfg: OpenSoraPlanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.hidden, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.scale_shift = nn.Parameter(torch.zeros((6, d), device=device))
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        self.cross_q, self.cross_kv, self.cross_o = lin(d, d), lin(d, 2 * d), lin(d, d)
        self.ff1, self.ff2 = lin(d, cfg.mlp_ratio * d), lin(cfg.mlp_ratio * d, d)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.unflatten(-1, (-1, self.cfg.head_dim))

    def forward(self, h: torch.Tensor, t6: torch.Tensor, y: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], *, route: str,
                pab: Optional[Tuple[dict, dict]] = None, plan=None,
                kv_len: Optional[int] = None) -> torch.Tensor:
        """One block on ``h`` ``[rows, N, d]`` on ``route``. ``pab``:
        ``(slots, reuse)``, the block's PAB slots (``"attn"``, ``"cross"``,
        ``"mlp"`` -> ``[rows, N, d]`` or absent) and this step's reuse bits
        per site; PAB runs the unpacked sites. ``plan``: h is a rank's
        token shard and the block holds the rank's tp slices (the unpacked
        sites, module docstring); ``kv_len``: the real tokens where the
        shards pad them."""
        e = (self.scale_shift[None] + t6).float()          # [rows, 6, d]
        if pab is None and route == "packed" and plan is None:
            return self._packed(h, e, y, rope)
        slots, reuse = pab if pab is not None else ({}, dict.fromkeys(
            ("attn", "cross", "mlp"), False))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = e.unbind(1)    # [rows, d]
        a = _pab_site(slots, reuse, "attn",
                      lambda: self._attn(h, sc_a, sh_a, rope, plan, kv_len))
        h = h + (g_a[:, None] * a.float()).to(h.dtype)
        h = h + _pab_site(slots, reuse, "cross", lambda: self._cross(h, y, plan))
        mo = _pab_site(slots, reuse, "mlp", lambda: self._mlp(h, sc_m, sh_m, plan))
        return h + (g_m[:, None] * mo.float()).to(h.dtype)

    def _packed(self, h, e, y, rope):
        cfg = self.cfg
        rows, n, d = h.shape
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = e.unbind(1)
        qkv = lnmod_matmul(h, sc_a, sh_a, self.qkv.weight, self.qkv.bias, eps=cfg.eps)
        q, k, v = (self._heads(t) for t in qkv.chunk(3, -1))
        o = attention(rope_half(q, *rope), rope_half(k, *rope), v,
                      scale=1.0 / math.sqrt(cfg.head_dim))
        h = matmul_gated_residual(o.reshape(rows, n, d), self.proj.weight,
                                  self.proj.bias, g_a, h)
        kv = self.cross_kv(y)
        h = fused_cross_attention(
            h, self.cross_q.weight, self.cross_q.bias, kv[..., :d].contiguous(),
            kv[..., d:].contiguous(), self.cross_o.weight, self.cross_o.bias, cfg.heads,
            scale=1.0 / math.sqrt(cfg.head_dim), true_d=cfg.head_dim, residual=True)
        y1 = lnmod_matmul(h, sc_m, sh_m, self.ff1.weight, self.ff1.bias, act="gelu",
                          eps=cfg.eps)
        return matmul_gated_residual(y1, self.ff2.weight, self.ff2.bias, g_m, h)

    def _attn(self, h, sc, sh, rope, plan=None, kv_len=None) -> torch.Tensor:
        """Full 3-D self-attention with RoPE3D, projections included (under
        ``plan`` Ulysses over every rank's tokens)."""
        rows, n, d = h.shape
        xn = layer_norm_mod(h, scale=sc, shift=sh, eps=self.cfg.eps)
        q, k, v = (self._heads(t) for t in self.qkv(xn).chunk(3, -1))
        o = attention(rope_half(q, *rope), rope_half(k, *rope), v, plan=plan,
                      kv_len=kv_len, kv_replicated=False)
        return tp_out(self.proj, o.flatten(-2), plan)

    def _cross(self, h, y, plan=None) -> torch.Tensor:
        """Cross-attention to the caption on the un-normed stream."""
        rows, n, d = h.shape
        k, v = (self._heads(t) for t in self.cross_kv(y).chunk(2, -1))
        o = attention(self._heads(self.cross_q(h)), k, v, plan=plan, kv_replicated=True)
        return tp_out(self.cross_o, o.flatten(-2), plan)

    def _mlp(self, h, sc, sh, plan=None) -> torch.Tensor:
        xm = layer_norm_mod(h, scale=sc, shift=sh, eps=self.cfg.eps)
        return tp_out(self.ff2, F.gelu(self.ff1(xm), approximate="tanh"), plan)


class OSPModel(nn.Module):
    """Open-Sora-Plan v1.2's transformer. Build on ``device``, then
    ``init(generator)`` for random weights or ``load_state_dict``
    (``models/convert.py``)."""

    def __init__(self, cfg: OpenSoraPlanConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden
        self.patch_embed = nn.Linear(cfg.patch_in, d, device=device, dtype=cfg.torch_dtype)
        self.caption = embedder_linears(cfg.caption_dim, d, device)
        self.time = embedder_linears(cfg.time_embed_dim, d, device)
        self.adaln_single = nn.Linear(d, 6 * d, device=device)
        self.blocks = nn.ModuleList(OSPBlock(cfg, device) for _ in range(cfg.depth))
        self.final_mod = nn.Parameter(torch.zeros((2, d), device=device))
        self.final_out = nn.Linear(d, cfg.c_out * math.prod(cfg.patch), device=device)

    def init(self, generator: torch.Generator) -> "OSPModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.open_sora_plan.init_osp_params`` draws them (the
        draws themselves differ): LeCun-normal linears with zero bias,
        modulation tables ``N(0, 1/hidden)``."""
        std = self.cfg.hidden ** -0.5

        def randn(shape):
            return torch.randn(shape, generator=generator, device=generator.device) * std

        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for blk in self.blocks:
                blk.scale_shift.copy_(randn(blk.scale_shift.shape))
            self.final_mod.copy_(randn(self.final_mod.shape))
        return self


def make_osp_core(model: OSPModel, grid: Tuple[int, int, int], caption_len: int, *,
                  route: str = "packed", pab=None, timesteps=None,
                  plan=None) -> DiTCore:
    """(prepare, trunk, head) for a static patch grid (T, H, W).

    cond = {"y": f[rows, caption_len, caption_dim]}; x = latent video
    f[rows, T*pt, H*ph, W*pw, C] (rows holds the CFG lanes); the output has
    C channels. ``route``: "packed" or "unpacked" (module docstring).

    ``pab`` (``core.pab.PABConfig``) with the sampler's ``timesteps`` makes
    a stateful core: ``trunk(hidden, ctx, state, step_idx)`` reuses each
    site by ``broadcast_masks`` at ``step_idx`` (-1: full compute) and
    ``init_state`` allocates the slots some mask can read. With ``plan``
    the core is one rank's (module docstring): prepare and head run whole
    on every rank, the trunk takes and returns the whole hidden, a PAB
    state holds the rank's shard; the unpacked blocks run on either route.
    Raises ``ValueError`` naming the counts when the heads do not split
    over tp, or over ``sp * tp`` for Ulysses.
    """
    cfg = model.cfg
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if plan is not None:
        model, _ = plan_setup(model, plan, "unpacked", 0, True)
        check_ulysses(model, plan)
    masks = None
    if pab is not None:
        if timesteps is None:
            raise ValueError("PAB needs the sampling timesteps")
        masks = broadcast_masks(pab, timesteps)
    t_len, gh, gw = grid
    d = cfg.hidden
    device = model.patch_embed.weight.device
    dt = cfg.torch_dtype
    rope = tuple(torch.from_numpy(a).to(device) for a in osp_rope_tables(cfg, grid))

    def embed(mlp: nn.ModuleDict, v: torch.Tensor, act) -> torch.Tensor:
        return mlp["out"](act(mlp["in"](v)))

    @torch.inference_mode()
    def prepare(x, t, cond):
        rows = x.shape[0]
        h = model.patch_embed(patchify(cfg, x.to(dt)))
        te = embed(model.time, timestep_embedding(t, cfg.time_embed_dim), F.silu)
        t6 = model.adaln_single(F.silu(te)).reshape(rows, 6, d)
        y = embed(model.caption, cond["y"].float(),
                  lambda v: F.gelu(v, approximate="tanh")).to(dt)
        return h, {"t6": t6, "te": te, "y": y}

    n_tok = t_len * gh * gw

    def shards(hidden):
        """Under a plan: the tokens' layout (all of them one "frame"), the
        rank's rope rows and the blocks' keywords."""
        lay = VideoShards(plan, hidden.shape[0], 1, n_tok)
        mine = tuple(lay.mine(a[None, None], 2, lay.sl)[0, 0] for a in rope)
        kv_len = n_tok if lay.sl * plan.sp != n_tok else None
        return lay, dict(rope=mine, plan=plan, kv_len=kv_len)

    def local(lay, hidden, ctx):
        return (lay.tokens(hidden)[:, 0].contiguous(),
                {k: lay.rows_of(v) for k, v in ctx.items()})

    @torch.inference_mode()
    def trunk(hidden, ctx):
        h, kw = hidden, dict(rope=rope, route=route)
        if plan is not None:
            lay, kw = shards(hidden)
            h, ctx = local(lay, hidden, ctx)
            kw["route"] = "unpacked"
        for blk in model.blocks:
            h = blk(h, ctx["t6"], ctx["y"], **kw)
        return h if plan is None else lay.gather_tokens(h[:, None])

    def init_state(hidden, ctx):
        """One zeroed ``[depth, rows, N, d]`` slot per site that some mask
        can read (under a plan the rank's shard)."""
        shape = tuple(hidden.shape)
        if plan is not None:
            lay = VideoShards(plan, shape[0], 1, n_tok)
            shape = (lay.rl, lay.sl, shape[-1])
        return {slot: torch.zeros((cfg.depth,) + shape, dtype=hidden.dtype,
                                  device=hidden.device)
                for slot in pab_slots(masks, PAB_SLOTS)}

    @torch.inference_mode()
    def trunk_pab(hidden, ctx, state, step_idx):
        full = not 0 <= step_idx < len(masks["spatial"])
        reuse = {slot: (not full) and bool(masks[key][step_idx]) for slot, key in PAB_SLOTS}
        h, kw = hidden, dict(rope=rope)
        if plan is not None:
            lay, kw = shards(hidden)
            h, ctx = local(lay, hidden, ctx)
        for i, blk in enumerate(model.blocks):
            slots = {slot: state[slot][i] for slot in state}
            h = blk(h, ctx["t6"], ctx["y"], route="unpacked", pab=(slots, reuse), **kw)
        return (h if plan is None else lay.gather_tokens(h[:, None])), state

    @torch.inference_mode()
    def head(hidden, ctx):
        mod = model.final_mod[None] + ctx["te"][:, None]
        # bf16 LayerNorm output times the f32 modulation is f32, as in JAX
        out = layer_norm(hidden, eps=cfg.eps).float() * (1 + mod[:, 1:2]) + mod[:, 0:1]
        out = model.final_out(out.to(hidden.dtype).float())
        rows = out.shape[0]
        pt, ph, pw = cfg.patch
        # features ordered [pt, ph, pw, c] ("nthwopqc->nctohpwq")
        out = out.reshape(rows, t_len, gh, gw, pt, ph, pw, cfg.c_out)
        out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        out = out.reshape(rows, t_len * pt, gh * ph, gw * pw, cfg.c_out)
        return out[..., :cfg.in_channels]

    if masks is not None:
        return DiTCore(prepare, trunk_pab, head, init_state=init_state)
    return DiTCore(prepare, trunk, head)
