"""The Qwen2.5-VL vision tower, the image half of Qwen-Image-Edit's
conditioning stack, as a PyTorch module.

Same model as ``magcache_tpu.models.qwen_vl`` (the diffusers
``QwenImageEditPipeline`` encoder, transformers'
``Qwen2_5_VisionTransformerPretrainedModel``): the reference image is cut
into 2 x 14 x 14 patches in the processor's merge-block-major order; a
bias-free patch linear (the strided Conv3d), then the window reorder; 32
blocks of RMSNorm, fused qkv, half-split 2-D RoPE over the (h, w) patch ids,
attention within the 112-pixel windows (full attention, within each image, at
``fullatt_indexes``) and a SwiGLU MLP; the merger (RMSNorm, then a 2-layer
GELU-erf MLP over each 2 x 2 unit of tokens); the window reorder undone.

The window partition, the rotary ids, the image preprocessing and the
M-RoPE position ids of the LM are host numpy, this package's own copy of the
JAX module's geometry. The JAX tower computes its attention with plain
einsum and softmax in f32 under an additive window mask, outside any Pallas
kernel, so this one does too (f32 matmuls and softmax).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["QwenVLVisionConfig", "QwenVLVisionTower", "QWEN25_VL_VISION",
           "vision_rot_pos_ids", "window_partition", "smart_resize",
           "preprocess_qwen_vl_image", "patchify_qwen_vl", "mrope_position_ids"]

# CLIP normalization constants used by the Qwen2VL image processor
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class QwenVLVisionConfig:
    """Geometry of ``Qwen2_5_VLVisionConfig`` (transformers defaults)."""

    depth: int = 32
    hidden: int = 1280
    heads: int = 16
    intermediate: int = 3420
    out_hidden: int = 3584
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    merge_size: int = 2
    window_size: int = 112
    fullatt_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def merge_unit(self) -> int:
        return self.merge_size * self.merge_size

    @property
    def patch_dim(self) -> int:
        return (self.in_channels * self.temporal_patch_size
                * self.patch_size * self.patch_size)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "QwenVLVisionConfig":
        """A test-size config (the JAX package's ``QwenVLVisionConfig.tiny``)."""
        d = dict(depth=4, hidden=32, heads=4, intermediate=48, out_hidden=24,
                 patch_size=2, temporal_patch_size=2, merge_size=2,
                 window_size=8, fullatt_indexes=(1, 3))
        d.update(kw)
        return QwenVLVisionConfig(**d)


# Qwen2.5-VL-7B-Instruct's vision tower (its config.json ``vision_config``):
# 0.67 B parameters, 2.7 GB in f32
QWEN25_VL_VISION = QwenVLVisionConfig()


# ---------------------------------------------------------------------------
# Host geometry (numpy; the image grid is static per call)
# ---------------------------------------------------------------------------


def vision_rot_pos_ids(grid_thw: Sequence[Tuple[int, int, int]],
                       merge_size: int) -> np.ndarray:
    """Per-token (h, w) position ids ``[S, 2]`` in the merge-block-major
    patch order (``rot_pos_emb``)."""
    out = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None].repeat(w, 1)
        hp = hp.reshape(h // merge_size, merge_size, w // merge_size,
                        merge_size).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.arange(w)[None, :].repeat(h, 0)
        wp = wp.reshape(h // merge_size, merge_size, w // merge_size,
                        merge_size).transpose(0, 2, 1, 3).reshape(-1)
        out.append(np.tile(np.stack([hp, wp], -1), (t, 1)))
    return np.concatenate(out, 0)


def window_partition(grid_thw: Sequence[Tuple[int, int, int]],
                     cfg: QwenVLVisionConfig):
    """``(window_index, seg_window, seg_full)`` (``get_window_index``):
    ``window_index`` is the merge-unit permutation applied to the tokens
    before the blocks (grids that are no multiple of the window pad with
    -100, dropped); ``seg_*`` are per-token segment ids after that reorder,
    same-id pairs may attend: ``seg_window`` the ``window_size``² pixel
    windows, ``seg_full`` each image (images never attend across)."""
    vw = cfg.window_size // cfg.merge_size // cfg.patch_size
    index_all: List[np.ndarray] = []
    seqlens_units: List[np.ndarray] = []
    unit_off = 0
    img_of_unit: List[np.ndarray] = []
    for n, (t, h, w) in enumerate(grid_thw):
        lh, lw = h // cfg.merge_size, w // cfg.merge_size
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % vw, (-lw) % vw
        idxp = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
        nh, nw = (lh + pad_h) // vw, (lw + pad_w) // vw
        idxp = idxp.reshape(t, nh, vw, nw, vw).transpose(0, 1, 3, 2, 4)
        idxp = idxp.reshape(t, nh * nw, vw, vw)
        seqlens_units.append((idxp != -100).sum((2, 3)).reshape(-1))
        flat = idxp.reshape(-1)
        keep = flat[flat != -100]
        index_all.append(keep + unit_off)
        img_of_unit.append(np.full(keep.shape, n, np.int32))
        unit_off += t * lh * lw
    window_index = np.concatenate(index_all)
    seqlens = np.concatenate(seqlens_units) * cfg.merge_unit   # token counts
    seqlens = seqlens[seqlens > 0]
    seg_window = np.repeat(np.arange(len(seqlens)), seqlens).astype(np.int32)
    seg_full = np.repeat(np.concatenate(img_of_unit), cfg.merge_unit)
    return window_index, seg_window, seg_full.astype(np.int32)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """The processor's resize target: multiples of ``factor`` within the
    pixel budget; an aspect ratio above 200 raises ``ValueError``."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio above 200")
    h = round(height / factor) * factor
    w = round(width / factor) * factor
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


def preprocess_qwen_vl_image(image: np.ndarray, cfg: QwenVLVisionConfig,
                             min_pixels: int = 56 * 56,
                             max_pixels: int = 14 * 14 * 4 * 1280):
    """uint8 or float HWC RGB -> ``(patches f32[S, patch_dim], grid_thw)``:
    ``smart_resize`` (bilinear, on the host), CLIP normalization, the frame
    repeated over the temporal patch, ``patchify_qwen_vl``."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    hh, ww = smart_resize(img.shape[0], img.shape[1],
                          factor=cfg.patch_size * cfg.merge_size,
                          min_pixels=min_pixels, max_pixels=max_pixels)
    yi = np.clip(np.linspace(0, img.shape[0] - 1, hh), 0, img.shape[0] - 1)
    xi = np.clip(np.linspace(0, img.shape[1] - 1, ww), 0, img.shape[1] - 1)
    y0, x0 = np.floor(yi).astype(int), np.floor(xi).astype(int)
    y1, x1 = np.minimum(y0 + 1, img.shape[0] - 1), np.minimum(x0 + 1, img.shape[1] - 1)
    fy, fx = (yi - y0)[:, None, None], (xi - x0)[None, :, None]
    img = ((img[y0][:, x0] * (1 - fy) + img[y1][:, x0] * fy) * (1 - fx)
           + (img[y0][:, x1] * (1 - fy) + img[y1][:, x1] * fy) * fx)
    img = (img - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
    chw = img.transpose(2, 0, 1).astype(np.float32)
    frames = np.repeat(chw[None], cfg.temporal_patch_size, axis=0)
    return patchify_qwen_vl(frames, cfg)


def patchify_qwen_vl(frames: np.ndarray, cfg: QwenVLVisionConfig):
    """``f32[T, C, H, W]`` (T divisible by the temporal patch) -> flattened
    patches in the processor's merge-block-major order, and ``grid_thw``."""
    tp, ps, ms = cfg.temporal_patch_size, cfg.patch_size, cfg.merge_size
    t, c, hh, ww = frames.shape
    gt, gh, gw = t // tp, hh // ps, ww // ps
    p = frames.reshape(gt, tp, c, gh // ms, ms, ps, gw // ms, ms, ps)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return (p.reshape(gt * gh * gw, c * tp * ps * ps).astype(np.float32),
            (gt, gh, gw))


def mrope_position_ids(input_ids: np.ndarray,
                       grid_thw: Sequence[Tuple[int, int, int]],
                       merge_size: int, image_token_id: int,
                       attention_mask: np.ndarray = None) -> np.ndarray:
    """3-axis position ids ``int64[3, B, S]`` (``get_rope_index``, images
    only): text runs sequentially on all axes; each image block takes (t, h,
    w) grid positions offset past the running maximum. The images of
    ``grid_thw`` are consumed in order across the batch rows; padding
    positions get 1."""
    b, s = input_ids.shape
    pos = np.ones((3, b, s), np.int64)
    img_i = 0
    for bi in range(b):
        ids = input_ids[bi]
        keep = (attention_mask[bi].astype(bool) if attention_mask is not None
                else np.ones(s, bool))
        ids_k = ids[keep]
        chunks = []
        st = 0
        tokens = ids_k.tolist()
        while img_i < len(grid_thw) and image_token_id in tokens[st:]:
            ed = tokens.index(image_token_id, st)
            t, h, w = grid_thw[img_i]
            lh, lw = h // merge_size, w // merge_size
            st_idx = chunks[-1].max() + 1 if chunks else 0
            if ed > st:
                chunks.append(np.arange(ed - st)[None].repeat(3, 0) + st_idx)
                st_idx = chunks[-1].max() + 1
            ti = np.arange(t)[:, None].repeat(lh * lw, 1).reshape(-1)
            hi = np.arange(lh)[None, :, None].repeat(t, 0).repeat(lw, 2).reshape(-1)
            wi = np.arange(lw)[None, None, :].repeat(t, 0).repeat(lh, 1).reshape(-1)
            chunks.append(np.stack([ti, hi, wi]) + st_idx)
            st = ed + t * lh * lw
            img_i += 1
        if st < len(tokens):
            st_idx = chunks[-1].max() + 1 if chunks else 0
            chunks.append(np.arange(len(tokens) - st)[None].repeat(3, 0) + st_idx)
        full = np.concatenate(chunks, 1) if chunks else np.zeros((3, 0), np.int64)
        pos[:, bi, keep] = full
    return pos


# ---------------------------------------------------------------------------
# The tower
# ---------------------------------------------------------------------------


class QwenVLVisionBlock(nn.Module):
    """One tower block; names follow the JAX pytree."""

    def __init__(self, cfg: QwenVLVisionConfig, device=None):
        super().__init__()
        d, it, dt = cfg.hidden, cfg.intermediate, cfg.torch_dtype
        self.norm1 = nn.Parameter(torch.ones(d, device=device))
        self.norm2 = nn.Parameter(torch.ones(d, device=device))
        self.qkv = nn.Linear(d, 3 * d, device=device, dtype=dt)
        self.proj = nn.Linear(d, d, device=device, dtype=dt)
        self.gate = nn.Linear(d, it, device=device, dtype=dt)
        self.up = nn.Linear(d, it, device=device, dtype=dt)
        self.down = nn.Linear(it, d, device=device, dtype=dt)


class QwenVLVisionTower(nn.Module):
    """Build on ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict`` (``models/convert.py::qwen_vl_vision_params_from_numpy``);
    ``forward(patches, grid_thw)`` gives the merged vision tokens."""

    def __init__(self, cfg: QwenVLVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hu, dt = cfg.hidden, cfg.hidden * cfg.merge_unit, cfg.torch_dtype
        self.patch = nn.Linear(cfg.patch_dim, d, bias=False, device=device, dtype=dt)
        self.blocks = nn.ModuleList(QwenVLVisionBlock(cfg, device) for _ in range(cfg.depth))
        self.merger_ln = nn.Parameter(torch.ones(d, device=device))
        self.merger_fc1 = nn.Linear(hu, hu, device=device, dtype=dt)
        self.merger_fc2 = nn.Linear(hu, cfg.out_hidden, device=device, dtype=dt)

    def init(self, generator: torch.Generator) -> "QwenVLVisionTower":
        """Random weights from ``generator``: LeCun-normal linears with zero
        bias and unit gains, as ``init_qwen_vl_vision_params`` draws them
        (the draws themselves differ)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self

    @torch.inference_mode()
    def forward(self, patches, grid_thw: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
        """``f32[S, patch_dim]`` (numpy or tensor) -> ``f32[S / merge_unit,
        out_hidden]`` merged vision tokens in the processor's order (the
        window reorder undone)."""
        cfg = self.cfg
        dev = self.patch.weight.device
        grid_thw = tuple(tuple(int(v) for v in g) for g in grid_thw)
        x = torch.as_tensor(patches, device=dev)
        s = x.shape[0]
        if s != sum(t * h * w for t, h, w in grid_thw):
            raise ValueError(f"{s} patches for the grids {grid_thw}")

        pos = vision_rot_pos_ids(grid_thw, cfg.merge_size)              # [S, 2]
        window_index, seg_win, seg_full = window_partition(grid_thw, cfg)
        inv = 10000.0 ** (-np.arange(0, cfg.head_dim // 2, 2, dtype=np.float64)
                          / (cfg.head_dim // 2))
        ang = (pos[:, :, None] * inv[None, None, :]).reshape(s, -1)     # [S, hd/2]
        # tokens (and their angles) in window-major order
        reorder = np.arange(s).reshape(-1, cfg.merge_unit)[window_index].reshape(-1)
        ang = ang[reorder]
        cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev)[:, None, :]
        sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev)[:, None, :]
        biases = [torch.from_numpy(np.where(seg[:, None] == seg[None, :], 0.0, -np.inf)
                                   .astype(np.float32)).to(dev)
                  for seg in (seg_win, seg_full)]

        nh, hd = cfg.heads, cfg.head_dim
        scale = 1.0 / math.sqrt(hd)

        def rope(t):
            t1, t2 = t[..., :hd // 2], t[..., hd // 2:]
            return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1)

        h = self.patch(x.to(cfg.torch_dtype))[torch.from_numpy(reorder).to(dev)]
        for i, blk in enumerate(self.blocks):
            n = rms_norm(h, blk.norm1, eps=cfg.eps)
            qkv = blk.qkv(n).reshape(s, 3, nh, hd)
            q, k = rope(qkv[:, 0].float()), rope(qkv[:, 1].float())
            v = qkv[:, 2].float()
            bias = biases[1 if i in cfg.fullatt_indexes else 0]
            sc = torch.einsum("qhd,khd->hqk", q, k) * scale + bias[None]
            a = torch.einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1), v)
            h = h + blk.proj(a.reshape(s, nh * hd).to(h.dtype))
            n = rms_norm(h, blk.norm2, eps=cfg.eps)
            h = h + blk.down(F.silu(blk.gate(n)) * blk.up(n))

        m = rms_norm(h, self.merger_ln, eps=cfg.eps).reshape(-1, cfg.hidden * cfg.merge_unit)
        m = self.merger_fc2(F.gelu(self.merger_fc1(m), approximate="none"))
        undo = torch.from_numpy(np.argsort(window_index)).to(dev)
        return m[undo].float()


# ---- published checkpoints ------------------------------------------------------

def convert_qwen_vl_vision_state_dict(sd: dict, cfg: QwenVLVisionConfig) -> dict:
    """A ``Qwen2_5_VisionTransformerPretrainedModel`` state dict (``visual.``
    or bare) as the JAX tree: the Conv3d patch kernel ``[E, C, T, P, P]``
    flattened in the processor's ``(C, T, P, P)`` order; f32 as in JAX,
    absent biases zero."""
    from magcache_tpu_torch.models.checkpoint import lin, stack, vec

    if any(k.startswith("visual.") for k in sd):
        sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    f32 = torch.float32

    def linear(prefix):
        p = lin(sd, prefix, f32)
        p.setdefault("b", torch.zeros(p["w"].shape[1]))
        return p

    def block(i):
        p = f"blocks.{i}"
        return {"norm1": vec(sd, f"{p}.norm1.weight"), "norm2": vec(sd, f"{p}.norm2.weight"),
                "qkv": linear(f"{p}.attn.qkv"), "proj": linear(f"{p}.attn.proj"),
                "gate": linear(f"{p}.mlp.gate_proj"), "up": linear(f"{p}.mlp.up_proj"),
                "down": linear(f"{p}.mlp.down_proj")}

    pe = vec(sd, "patch_embed.proj.weight")
    return {"patch": pe.reshape(pe.shape[0], -1).T,
            "blocks": stack([block(i) for i in range(cfg.depth)]),
            "merger": {"ln": vec(sd, "merger.ln_q.weight"), "fc1": linear("merger.mlp.0"),
                       "fc2": linear("merger.mlp.2")}}
