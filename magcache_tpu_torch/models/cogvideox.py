"""CogVideoX's video DiT as PyTorch modules.

Same model as ``magcache_tpu.models.cogvideox`` (behavioral source
``videosys/models/transformers/cogvideox_transformer_3d.py``): text and
video tokens share every block (joint attention, joint FFN) under
LayerNormZero modulation: the timestep embedding gives separate (shift,
scale, gate) triplets for the video and the text segment at each of the two
sub-layers (``_mod3``). Per-frame 2-D patch embedding; 3-D RoPE
(interleaved pairs) on the video tokens, identity rows for the text; q/k
LayerNorm with an affine over the head dim; the 5B head: ``norm_final``
(affine LayerNorm), then an AdaLayerNorm (``norm_out``, (shift, scale)
chunk order) and the projection, over the video tokens only.

The hidden stream is the video tokens; the text rides in ctx and is rejoined
in each block (its final state is dropped by the head), so the MagCache
residual is the video stream's. Joint attention runs through
``attention()``: K1 with the running max at head dim 64 zero-padded to 128
on the card; every other op is plain PyTorch (the JAX model has no other
Pallas kernel). PAB (``make_cogvideox_core(pab=, timesteps=)``, the JAX
``trunk_pab``) replays each block's joint attention ("spatial") and FFN
("mlp") output over [text; video] by the step's host mask; ``init_state``
allocates only the slots that some mask can read.

Dtypes: in a bf16 config the patch and text embeddings and the block
linears (the LayerNormZero ones too) are bf16; the LayerNormZero product
runs in f32 from them (JAX promotes the f32 timestep embedding against bf16
weights), the time embedder, the norms' affines and the final layer are
f32. JAX's ``remat`` (a memory knob with no effect on results) is not
carried over.
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
from magcache_tpu_torch.models.common import (DTYPES, embedder_linears, init_linear_,
                                              timestep_embedding)
from magcache_tpu_torch.models.stdit3 import _pab_site, pab_slots
from magcache_tpu_torch.ops.attention import attention
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.ops.rope import apply_rope, rope_freqs_1d

__all__ = ["CogVideoXConfig", "CogVideoXModel", "COGVIDEOX_5B", "cogvideo_rope_tables",
           "make_cogvideox_core"]


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    hidden: int = 3072             # 5B (2B: 1920)
    heads: int = 48                # 5B (2B: 30)
    layers: int = 42               # 5B (2B: 30)
    mlp_ratio: int = 4
    in_channels: int = 16
    text_dim: int = 4096
    patch: int = 2                 # spatial patch per frame
    axes_dims: Tuple[int, int, int] = (16, 24, 24)  # t/h/w RoPE split of head_dim
    time_embed_dim: int = 256      # sinusoid width
    temb_dim: int = 0              # conditioning width; 0 = hidden
    eps: float = 1e-5
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def cond_dim(self) -> int:
        """The timestep conditioning's width, which the LayerNormZero and
        AdaLN linears read."""
        return self.temb_dim or self.hidden

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "CogVideoXConfig":
        d = dict(hidden=96, heads=4, layers=2, text_dim=24, axes_dims=(8, 8, 8),
                 time_embed_dim=32)
        d.update(kw)
        return CogVideoXConfig(**d)


# CogVideoX-5B with the JAX package's defaults
COGVIDEOX_5B = CogVideoXConfig()

# PAB state slots and the mask that reads each
PAB_SLOTS = (("attn", "spatial"), ("mlp", "mlp"))


def cogvideo_rope_tables(cfg: CogVideoXConfig, grid: Tuple[int, int, int]):
    """(cos, sin) f32 ``[T*H*W, head_dim/2]`` over the video patch grid: the
    (t, h, w) axes take ``axes_dims`` of the head dim (interleaved pairs)."""
    coords = np.stack(np.meshgrid(*[np.arange(g) for g in grid], indexing="ij"),
                      -1).reshape(-1, 3)
    tabs = [rope_freqs_1d(coords[:, ax], dim_a, 10000.0)
            for ax, dim_a in enumerate(cfg.axes_dims)]
    return (np.concatenate([c for c, _ in tabs], -1),
            np.concatenate([s for _, s in tabs], -1))


def _mod3(vec: torch.Tensor, lin: nn.Linear):
    """``silu(temb)`` through a LayerNormZero linear in f32: six ``[rows, 1,
    d]`` chunks (v_shift, v_scale, v_gate, t_shift, t_scale, t_gate)."""
    out = F.linear(F.silu(vec.float()), lin.weight.float(), lin.bias.float())
    return out[:, None].chunk(6, -1)


class CogVideoXBlock(nn.Module):
    """One joint block; parameter names follow the JAX keys."""

    def __init__(self, cfg: CogVideoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ct, dt = cfg.hidden, cfg.cond_dim, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        def vec(n, fill):
            return nn.Parameter(torch.full((n,), fill, dtype=torch.float32, device=device))

        self.mod1, self.mod2 = lin(ct, 6 * d), lin(ct, 6 * d)
        self.ln1_w, self.ln1_b, self.ln2_w, self.ln2_b = vec(d, 1.0), vec(d, 0.0), \
            vec(d, 1.0), vec(d, 0.0)
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        hd = cfg.head_dim
        self.q_norm_w, self.q_norm_b = vec(hd, 1.0), vec(hd, 0.0)
        self.k_norm_w, self.k_norm_b = vec(hd, 1.0), vec(hd, 0.0)
        self.ff1, self.ff2 = lin(d, cfg.mlp_ratio * d), lin(cfg.mlp_ratio * d, d)

    def _joint(self, vid, txt, w, b, v_shift, v_scale, t_shift, t_scale):
        """The modulated [text; video] sequence in the stream's dtype."""
        eps = self.cfg.eps
        vid_n = layer_norm(vid, w, b, eps=eps).float() * (1 + v_scale) + v_shift
        txt_n = layer_norm(txt, w, b, eps=eps).float() * (1 + t_scale) + t_shift
        return torch.cat([txt_n, vid_n], dim=1).to(vid.dtype)

    def forward(self, vid: torch.Tensor, txt: torch.Tensor, temb: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor], slots: dict, reuse: dict):
        """One block on the video ``[rows, S, d]`` and text ``[rows, L, d]``
        streams; ``slots`` (``"attn"``, ``"mlp"`` -> ``[rows, L+S, d]`` or
        absent) and ``reuse`` are the block's PAB slots and this step's
        reuse bits. Returns ``(vid, txt)``."""
        cfg = self.cfg
        rows, n_txt = txt.shape[:2]
        vs1, vsc1, vg1, ts1, tsc1, tg1 = _mod3(temb, self.mod1)

        def attn():
            h = self._joint(vid, txt, self.ln1_w, self.ln1_b, vs1, vsc1, ts1, tsc1)
            q, k, v = (t.unflatten(-1, (cfg.heads, cfg.head_dim))
                       for t in self.qkv(h).chunk(3, -1))
            q = apply_rope(layer_norm(q, self.q_norm_w, self.q_norm_b, eps=cfg.eps), *rope)
            k = apply_rope(layer_norm(k, self.k_norm_w, self.k_norm_b, eps=cfg.eps), *rope)
            return self.proj(attention(q, k, v).reshape(rows, -1, cfg.hidden))

        o = _pab_site(slots, reuse, "attn", attn)
        vid = vid + (vg1 * o[:, n_txt:].float()).to(vid.dtype)
        txt = txt + (tg1 * o[:, :n_txt].float()).to(txt.dtype)
        vs2, vsc2, vg2, ts2, tsc2, tg2 = _mod3(temb, self.mod2)

        def ff():
            h = self._joint(vid, txt, self.ln2_w, self.ln2_b, vs2, vsc2, ts2, tsc2)
            return self.ff2(F.gelu(self.ff1(h), approximate="tanh"))

        f = _pab_site(slots, reuse, "mlp", ff)
        vid = vid + (vg2 * f[:, n_txt:].float()).to(vid.dtype)
        txt = txt + (tg2 * f[:, :n_txt].float()).to(txt.dtype)
        return vid, txt


class CogVideoXModel(nn.Module):
    """CogVideoX's transformer. Build on ``device``, then
    ``init(generator)`` for random weights or ``load_state_dict``
    (``models/convert.py``)."""

    def __init__(self, cfg: CogVideoXConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, ct, dt, p2 = cfg.hidden, cfg.cond_dim, cfg.torch_dtype, cfg.patch ** 2
        self.patch_embed = nn.Linear(cfg.in_channels * p2, d, device=device, dtype=dt)
        self.text_proj = nn.Linear(cfg.text_dim, d, device=device, dtype=dt)
        self.time = embedder_linears(cfg.time_embed_dim, ct, device)
        self.blocks = nn.ModuleList(CogVideoXBlock(cfg, device) for _ in range(cfg.layers))

        def vec(fill):
            return nn.Parameter(torch.full((d,), fill, dtype=torch.float32, device=device))

        self.norm_final_w, self.norm_final_b = vec(1.0), vec(0.0)
        self.norm_out_w, self.norm_out_b = vec(1.0), vec(0.0)
        self.final_mod = nn.Linear(ct, 2 * d, device=device)
        self.final_out = nn.Linear(d, cfg.in_channels * p2, device=device)

    def init(self, generator: torch.Generator) -> "CogVideoXModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.cogvideox.init_cogvideox_params`` draws them
        (the draws themselves differ): LeCun-normal linears with zero bias;
        the norms stay unit and zero."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def make_cogvideox_core(model: CogVideoXModel, txt_len: int, grid: Tuple[int, int, int],
                        *, pab=None, timesteps=None) -> DiTCore:
    """(prepare, trunk, head) for a static patch grid (T, H, W).

    cond = {"txt": f[rows, txt_len, text_dim]}; x = latent video
    f[rows, T, H*p, W*p, C]. ``pab`` (``core.pab.PABConfig``) with the
    sampler's ``timesteps`` makes a stateful core: ``trunk(hidden, ctx,
    state, step_idx)`` reuses the joint attention ("spatial") and the FFN
    ("mlp") by ``broadcast_masks`` at ``step_idx`` (-1: full compute).
    """
    cfg = model.cfg
    t_len, gh, gw = grid
    p, c, d = cfg.patch, cfg.in_channels, cfg.hidden
    device = model.patch_embed.weight.device
    dt = cfg.torch_dtype
    masks = None
    if pab is not None:
        if timesteps is None:
            raise ValueError("PAB needs the sampling timesteps")
        masks = broadcast_masks(pab, timesteps)
    cos, sin = cogvideo_rope_tables(cfg, grid)
    half = cfg.head_dim // 2
    # identity rotation rows for the text
    rope = (torch.from_numpy(np.concatenate([np.ones((txt_len, half), np.float32), cos])),
            torch.from_numpy(np.concatenate([np.zeros((txt_len, half), np.float32), sin])))
    rope = tuple(t.to(device) for t in rope)

    @torch.inference_mode()
    def prepare(x, t, cond):
        rows = x.shape[0]
        xp = x.to(dt).reshape(rows, t_len, gh, p, gw, p, c).permute(0, 1, 2, 4, 6, 3, 5)
        vid = model.patch_embed(xp.reshape(rows, t_len * gh * gw, c * p * p))
        txt = model.text_proj(cond["txt"].to(dt))
        temb = model.time["out"](F.silu(model.time["in"](
            timestep_embedding(t, cfg.time_embed_dim))))
        return vid, {"txt": txt, "temb": temb}

    def run(vid, ctx, state=None, reuse=None):
        txt = ctx["txt"]
        reuse = reuse or dict.fromkeys(("attn", "mlp"), False)
        for i, blk in enumerate(model.blocks):
            slots = {} if state is None else {s: state[s][i] for s in state}
            vid, txt = blk(vid, txt, ctx["temb"], rope, slots, reuse)
        return vid

    @torch.inference_mode()
    def trunk(hidden, ctx):
        return run(hidden, ctx)

    def init_state(hidden, ctx):
        """One zeroed ``[layers, rows, txt_len + S, d]`` slot per site that
        some mask can read."""
        rows, s_vid, _ = hidden.shape
        return {slot: torch.zeros((cfg.layers, rows, txt_len + s_vid, d),
                                  dtype=hidden.dtype, device=hidden.device)
                for slot in pab_slots(masks, PAB_SLOTS)}

    @torch.inference_mode()
    def trunk_pab(hidden, ctx, state, step_idx):
        full = not 0 <= step_idx < len(masks["spatial"])
        reuse = {slot: (not full) and bool(masks[key][step_idx]) for slot, key in PAB_SLOTS}
        return run(hidden, ctx, state, reuse), state

    @torch.inference_mode()
    def head(hidden, ctx):
        h = layer_norm(hidden, model.norm_final_w, model.norm_final_b, eps=cfg.eps)
        mod = model.final_mod(F.silu(ctx["temb"].float()))
        shift, scale = mod[:, None, :d], mod[:, None, d:]
        h = layer_norm(h, model.norm_out_w, model.norm_out_b,
                       eps=cfg.eps).float() * (1 + scale) + shift
        out = model.final_out(h.to(hidden.dtype).float())
        rows = out.shape[0]
        out = out.reshape(rows, t_len, gh, gw, c, p, p).permute(0, 1, 2, 5, 3, 6, 4)
        return out.reshape(rows, t_len, gh * p, gw * p, c)

    if masks is not None:
        return DiTCore(prepare, trunk_pab, head, init_state=init_state)
    return DiTCore(prepare, trunk, head)
