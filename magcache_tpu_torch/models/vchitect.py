"""Vchitect-XL's video DiT as PyTorch modules.

Same model as ``magcache_tpu.models.vchitect`` (behavioral source
``videosys/models/transformers/vchitect_transformer_3d.py``). Each joint
block carries a video stream ``[rows, T*S, d]`` and a per-frame context
stream ``[rows, T, L, d]`` (broadcast over the frames from block 0, then
evolving per frame) under AdaLN-Zero modulation of both (``_mod``: (shift,
scale, gate) for the attention, then for the FFN), and three attention paths
share their context projections:

1. temporal: per spatial position, attention over the frames of the
   [frame ; context] tokens with interleaved-pair RoPE (theta 1e6) on q and
   k. ``attention()`` takes its einsum path at T <= 128 (40 frames here),
   as the JAX package does;
2. cross: every one of the T*(S+L) tokens queries frame 0's context keys
   and values, per sample (K1: one partial key tile of 77 keys);
3. spatial: per-frame joint attention over S+L tokens, kept raw (K1).

They combine as the reference does: ``joint = spatial * 1.1 + cross``; the
video stream adds ``o(joint)`` and the temporal output's ``ot``
projection, the context stream ``add_out(joint)`` and ``add_out_t`` of the
temporal output's context part; gated residuals in f32, gelu-tanh FFNs per
stream. The last block is context-pre-only: its context norm is
AdaLN-Continuous ((scale, shift) chunks) and its context output is dropped.
The head is AdaLN-Continuous ((scale, shift)), ``proj_out`` and the nhwpqc
unpatchify.

Dtypes: in a bf16 config the patch and context embeddings and the block
linears are bf16; the modulation linears run in f32 from them (JAX promotes
the f32 conditioning vector against bf16 weights); the time and pooled
embedders, ``norm_out_mod`` and ``proj_out`` are f32. PAB
(``make_vchitect_core(pab=, timesteps=)``, the JAX ``trunk_pab``) replays
each block's temporal, cross and spatial outputs by the step's host masks;
``init_state`` allocates the slots some mask can read, one ``[depth, rows,
T, S+L, d]`` tensor each (the temporal slot holds the video part after
``ot`` and the raw context part, as the JAX pair does).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.core.pab import broadcast_masks
from magcache_tpu_torch.core.sampler import DiTCore
from magcache_tpu_torch.models.common import (DTYPES, MLPEmbedder, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.models.stdit3 import _pab_site, pab_slots
from magcache_tpu_torch.ops.attention import attention
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import apply_rope, rope_freqs_1d

__all__ = ["VchitectConfig", "VchitectModel", "VCHITECT_XL", "make_vchitect_core",
           "pos_embed_sd3"]


@dataclasses.dataclass(frozen=True)
class VchitectConfig:
    hidden: int = 1536
    heads: int = 24
    depth: int = 24
    mlp_ratio: int = 4
    in_channels: int = 16
    text_dim: int = 4096             # joint_attention_dim
    vec_dim: int = 2048              # pooled_projection_dim
    patch: int = 2
    time_embed_dim: int = 256
    pos_embed_max_size: int = 96     # SD3 cropped sincos table
    pos_embed_base_size: int = 64    # sample_size // patch_size
    rope_theta: float = 1e6
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "VchitectConfig":
        d = dict(hidden=64, heads=4, depth=2, text_dim=24, vec_dim=16, time_embed_dim=32,
                 pos_embed_max_size=8, pos_embed_base_size=8)
        d.update(kw)
        return VchitectConfig(**d)


# Vchitect-XL-2B with the JAX package's defaults
VCHITECT_XL = VchitectConfig()

# PAB state slots and the mask that reads each, in the block's call order
PAB_SLOTS = (("temporal", "temporal"), ("cross", "cross"), ("spatial", "spatial"))


def pos_embed_sd3(d: int, H: int, W: int, max_size: int, base_size: int) -> np.ndarray:
    """Center-cropped 2-D sincos table (diffusers PatchEmbed with
    ``pos_embed_max_size``: grid scaled by base/max, half channels per axis,
    [sin | cos] within each half; crop top=(max-H)//2, left=(max-W)//2),
    f32 ``[H*W, d]``."""
    if H > max_size or W > max_size:
        raise ValueError(f"grid {H}x{W} exceeds the position table's {max_size}")

    def sincos_1d(dim, pos):
        omega = 1.0 / 10000.0 ** (np.arange(dim // 4, dtype=np.float64) / (dim // 4))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(max_size, dtype=np.float64) / (max_size / base_size)
    gw, gh = np.meshgrid(coords, coords)   # xy indexing: gw varies along W
    emb = np.concatenate([sincos_1d(d, gw), sincos_1d(d, gh)], axis=1)
    emb = emb.reshape(max_size, max_size, d)
    top, left = (max_size - H) // 2, (max_size - W) // 2
    return emb[top:top + H, left:left + W].reshape(H * W, d).astype(np.float32)


def _mod(vec: torch.Tensor, lin: nn.Linear, n: int):
    """``silu(vec)`` through a modulation linear in f32: ``n`` chunks
    ``[rows, 1, 1, d]``."""
    out = F.linear(F.silu(vec.float()), lin.weight.float(), lin.bias.float())
    return out[:, None, None].chunk(n, -1)


def _modulate(x: torch.Tensor, scale, shift, eps: float) -> torch.Tensor:
    return (layer_norm(x, eps=eps).float() * (1 + scale) + shift).to(x.dtype)


def _ffn(x: torch.Tensor, up: nn.Linear, down: nn.Linear) -> torch.Tensor:
    return down(F.gelu(up(x), approximate="tanh"))


class VchitectBlock(nn.Module):
    """One joint block (``pre_only``: the last, context-pre-only one);
    parameter names follow the JAX keys."""

    def __init__(self, cfg: VchitectConfig, pre_only: bool, device=None):
        super().__init__()
        self.cfg, self.pre_only = cfg, pre_only
        d, f = cfg.hidden, cfg.mlp_ratio * cfg.hidden

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=cfg.torch_dtype)

        self.mod_x = lin(d, 6 * d)
        for name in ("q", "k", "v", "o", "qt", "kt", "vt", "ot", "qc", "oc",
                     "add_q", "add_k", "add_v"):
            setattr(self, name, lin(d, d))
        self.ff1, self.ff2 = lin(d, f), lin(f, d)
        if pre_only:
            self.mod_c2 = lin(d, 2 * d)          # AdaLN-Continuous
        else:
            self.mod_c = lin(d, 6 * d)
            self.add_out, self.add_out_t = lin(d, d), lin(d, d)
            self.ffc1, self.ffc2 = lin(d, f), lin(f, d)

    def forward(self, vid: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], slots: dict, reuse: dict):
        """The block on ``vid [rows, T*S, d]`` and ``txt [rows, T, L, d]``
        under ``vec [rows, d]`` (f32); ``slots`` (``"temporal"``,
        ``"cross"``, ``"spatial"`` -> ``[rows, T, S+L, d]`` or absent) and
        ``reuse`` are the block's PAB slots and this step's reuse bits.
        Returns ``(vid, txt)`` (``txt`` unchanged in the last block)."""
        cfg = self.cfg
        rows, tn, d = vid.shape
        t = txt.shape[1]
        s, j = tn // t, tn // t + txt.shape[2]
        eps = cfg.eps
        sx, scx, gx, sxm, scxm, gxm = _mod(vec, self.mod_x, 6)
        if self.pre_only:
            cs, csh = _mod(vec, self.mod_c2, 2)      # (scale, shift)
            txt_n = _modulate(txt, cs, csh, eps)
        else:
            sc_, scc, gc, scm_, sccm, gcm = _mod(vec, self.mod_c, 6)
            txt_n = _modulate(txt, scc, sc_, eps)
        vid_n = _modulate(vid.reshape(rows, t, s, d), scx, sx, eps)
        eq, ek, ev = self.add_q(txt_n), self.add_k(txt_n), self.add_v(txt_n)

        def heads(x):
            return x.unflatten(-1, (cfg.heads, cfg.head_dim))

        def temporal():
            def over_frames(lin, e):      # [rows, T, S+L, d] -> [rows*(S+L), T, nh, hd]
                x = torch.cat([lin(vid_n), e], dim=2)
                return heads(x.transpose(1, 2).reshape(rows * j, t, d))

            q = apply_rope(over_frames(self.qt, eq), *rope)
            k = apply_rope(over_frames(self.kt, ek), *rope)
            o = attention(q, k, over_frames(self.vt, ev)).reshape(rows, j, t, d).transpose(1, 2)
            return torch.cat([self.ot(o[:, :, :s]), o[:, :, s:]], dim=2)

        def cross():
            q = torch.cat([self.qc(vid_n), eq], dim=2).reshape(rows, t * j, d)
            o = attention(heads(q), heads(ek[:, 0]), heads(ev[:, 0]))
            return self.oc(o.reshape(rows, t, j, d))

        def spatial():
            def per_frame(lin, e):
                return heads(torch.cat([lin(vid_n), e], dim=2).reshape(rows * t, j, d))

            o = attention(per_frame(self.q, eq), per_frame(self.k, ek), per_frame(self.v, ev))
            return o.reshape(rows, t, j, d)

        tmp = _pab_site(slots, reuse, "temporal", temporal)
        crx = _pab_site(slots, reuse, "cross", cross)
        spt = _pab_site(slots, reuse, "spatial", spatial)
        joint = spt * 1.1 + crx
        vid_a = (self.o(joint[:, :, :s]) + tmp[:, :, :s]).reshape(rows, tn, d)
        vid = vid + (gx[:, 0] * vid_a.float()).to(vid.dtype)
        vm = _ffn(_modulate(vid.reshape(rows, t, s, d), scxm, sxm, eps), self.ff1, self.ff2)
        vid = vid + (gxm[:, 0] * vm.reshape(rows, tn, d).float()).to(vid.dtype)
        if self.pre_only:
            return vid, txt
        ctx_a = self.add_out(joint[:, :, s:]) + self.add_out_t(tmp[:, :, s:])
        txt = txt + (gc * ctx_a.float()).to(txt.dtype)
        tm = _ffn(_modulate(txt, sccm, scm_, eps), self.ffc1, self.ffc2)
        return vid, txt + (gcm * tm.float()).to(txt.dtype)


class VchitectModel(nn.Module):
    """Vchitect-XL's transformer. Build on ``device``, then
    ``init(generator)`` for random weights or ``load_state_dict``
    (``models/convert.py``)."""

    def __init__(self, cfg: VchitectConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, p2 = cfg.hidden, cfg.torch_dtype, cfg.patch ** 2
        self.patch_embed = nn.Linear(cfg.in_channels * p2, d, device=device, dtype=dt)
        self.context_in = nn.Linear(cfg.text_dim, d, device=device, dtype=dt)
        self.time_in = MLPEmbedder(cfg.time_embed_dim, d, device)
        self.pooled_in = MLPEmbedder(cfg.vec_dim, d, device)
        self.blocks = nn.ModuleList(VchitectBlock(cfg, False, device)
                                    for _ in range(cfg.depth - 1))
        self.last = VchitectBlock(cfg, True, device)
        self.norm_out_mod = nn.Linear(d, 2 * d, device=device)
        self.proj_out = nn.Linear(d, cfg.in_channels * p2, device=device)

    def init(self, generator: torch.Generator) -> "VchitectModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``init_vchitect_params`` draws them (the draws themselves differ):
        LeCun-normal linears with zero bias, and ``ot``, ``oc`` and
        ``add_out_t`` zero, as the reference initialises them."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
            for blk in (*self.blocks, self.last):
                for name in ("ot", "oc") + (() if blk.pre_only else ("add_out_t",)):
                    getattr(blk, name).weight.zero_()
        return self


def make_vchitect_core(model: VchitectModel, grid: Tuple[int, int, int], txt_len: int,
                       *, pab=None, timesteps=None) -> DiTCore:
    """(prepare, trunk, head) for a static patch grid (T, H, W).

    cond = {"txt": f[rows, txt_len, text_dim], "vec": f[rows, vec_dim]};
    x = latent video f[rows, T, H*p, W*p, C]. ``pab`` (``core.pab.PABConfig``)
    with the sampler's ``timesteps`` makes a stateful core: ``trunk(hidden,
    ctx, state, step_idx)`` reuses each block's temporal, cross and spatial
    outputs by ``broadcast_masks`` at ``step_idx`` (-1: full compute).
    """
    cfg = model.cfg
    t_len, gh, gw = grid
    s_len, d, p, c = gh * gw, cfg.hidden, cfg.patch, cfg.in_channels
    device = model.patch_embed.weight.device
    dt = cfg.torch_dtype
    masks = None
    if pab is not None:
        if timesteps is None:
            raise ValueError("PAB needs the sampling timesteps")
        masks = broadcast_masks(pab, timesteps)
    pos2d = torch.from_numpy(pos_embed_sd3(d, gh, gw, cfg.pos_embed_max_size,
                                           cfg.pos_embed_base_size)).to(device)
    rope = tuple(torch.from_numpy(a).to(device)
                 for a in rope_freqs_1d(np.arange(t_len), cfg.head_dim, cfg.rope_theta))
    blocks = (*model.blocks, model.last)

    @torch.inference_mode()
    def prepare(x, t, cond):
        rows = x.shape[0]
        xp = x.to(dt).reshape(rows, t_len, gh, p, gw, p, c).permute(0, 1, 2, 4, 6, 3, 5)
        vid = model.patch_embed(xp.reshape(rows, t_len * s_len, c * p * p))
        # the f32 sincos add, then the cast (the trunk's GEMMs stay in dt)
        vid = (vid.reshape(rows, t_len, s_len, d).float() + pos2d).reshape(
            rows, t_len * s_len, d).to(dt)
        txt = model.context_in(cond["txt"].to(dt))
        txt = txt[:, None].expand(rows, t_len, *txt.shape[1:])
        vec = model.time_in(timestep_embedding(t, cfg.time_embed_dim)) \
            + model.pooled_in(cond["vec"].float())
        return vid, {"txt": txt, "vec": vec}

    def run(vid, ctx, state=None, reuse=None):
        txt = ctx["txt"]
        reuse = reuse or dict.fromkeys((k for k, _ in PAB_SLOTS), False)
        for i, blk in enumerate(blocks):
            slots = {} if state is None else {k: state[k][i] for k in state}
            vid, txt = blk(vid, txt, ctx["vec"], rope, slots, reuse)
        return vid

    @torch.inference_mode()
    def trunk(hidden, ctx):
        return run(hidden, ctx)

    def init_state(hidden, ctx):
        """One zeroed ``[depth, rows, T, S + txt_len, d]`` slot per site that
        some mask can read."""
        return {slot: torch.zeros((cfg.depth, hidden.shape[0], t_len, s_len + txt_len, d),
                                  dtype=hidden.dtype, device=hidden.device)
                for slot in pab_slots(masks, PAB_SLOTS)}

    @torch.inference_mode()
    def trunk_pab(hidden, ctx, state, step_idx):
        full = not 0 <= step_idx < len(masks["spatial"])
        reuse = {slot: (not full) and bool(masks[key][step_idx]) for slot, key in PAB_SLOTS}
        return run(hidden, ctx, state, reuse), state

    @torch.inference_mode()
    def head(hidden, ctx):
        mod = model.norm_out_mod(F.silu(ctx["vec"].float()))
        scale, shift = mod[:, None, :d], mod[:, None, d:]     # (scale, shift)
        h = layer_norm(hidden, eps=cfg.eps).float() * (1 + scale) + shift
        out = model.proj_out(h.to(hidden.dtype).float())
        rows = out.shape[0]
        out = out.reshape(rows, t_len, gh, gw, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        return out.reshape(rows, t_len, gh * p, gw * p, c)

    if masks is not None:
        return DiTCore(prepare, trunk_pab, head, init_state=init_state)
    return DiTCore(prepare, trunk, head)
