"""The CLIP text tower as PyTorch modules: FLUX's pooled encoder (CLIP-L) and
the two CLIP towers of the SD3 stack (CLIP-L and CLIP-bigG with
projection, Vchitect's); and the CLIP vision tower that conditions Wan's
i2v and flf2v DiT (ViT-H/14, ``CLIP_VIT_H``).

The counterpart of ``magcache_tpu.models.clip``'s text tower
(``clip_text_forward``): token and position embeddings, pre-LayerNorm
blocks with a fused qkv projection and attention in f32 under a causal mask
ANDed with the padding mask (masked scores at ``-inf``; a padded query still
sees key 0), a quick-gelu or exact-gelu MLP, a final LayerNorm, the pooled
row at the EOS position (the first ``eos_token_id``, or ``argmax(ids)`` for a
legacy config whose ``eos_token_id`` is 2), and an optional projection of it.
Plain PyTorch ops: the JAX function reaches no Pallas kernel.

``CLIPTextModel(cfg, device).init(generator)`` draws random weights;
``models.convert.clip_text_params_from_numpy`` carries the JAX tree over.
``models.text.ClipTextEncoder`` tokenizes prompts and encodes them.

The vision tower (``clip_vision_forward``, JAX ``clip_vision_forward``): a
patchify as reshape + linear, the class token, learned positions, a
pre-LayerNorm, then the residual blocks, returning the un-normed states of
the penultimate block (Wan's ``use_31_block``: 31 of 32 blocks, no
post-norm) in f32. ``preprocess_clip_image`` resizes (bicubic, as JAX) and
normalizes an image for it. Its self-attention over 257 tokens at head dim
80 goes through ``ops.attention.attention``: on the card that is K1 at head
dim 128 (zero-padded), which takes bf16, so the f32 tower rounds q, k and v
to bf16 there and takes the output back to f32 (the JAX tower's Pallas K1
runs on f32 operands; the rounding is the port's); on the CPU the plain
version stays f32. Checkpoint loading and the BPE tokenizer are not
ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.attention import attention
from magcache_tpu_torch.ops.norms import layer_norm
from magcache_tpu_torch.utils.misc import resize_bicubic

__all__ = ["CLIPTextConfig", "CLIPTextModel", "clip_text_forward", "CLIP_L", "CLIP_L_SD3",
           "CLIP_BIGG", "LEGACY_EOS", "CLIPVisionConfig", "CLIPVisionModel",
           "clip_vision_forward", "preprocess_clip_image", "CLIP_VIT_H", "CLIP_IMAGE_MEAN",
           "CLIP_IMAGE_STD"]

# openai/clip-vit-large-patch14 declares eos_token_id 2, an id that never
# appears in CLIP token streams; such configs pool at the largest id (the
# true EOS, vocab_size - 1), as transformers does
LEGACY_EOS = 2


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """A CLIP text tower; the defaults are CLIP-L/14's (the JAX package's
    ``CLIPTextConfig``). ``projection_dim``: the width of ``text_proj``
    (``CLIPTextModelWithProjection``), None without one."""

    vocab_size: int = 49408
    dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 77
    eos_token_id: int = 49407
    quick_gelu: bool = True
    eps: float = 1e-5
    dtype: str = "float32"
    projection_dim: Optional[int] = None

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def legacy_eos(self) -> bool:
        return self.eos_token_id == LEGACY_EOS

    @staticmethod
    def tiny(**kw) -> "CLIPTextConfig":
        d = dict(vocab_size=96, dim=32, layers=2, heads=4, max_len=16, eos_token_id=95)
        d.update(kw)
        return CLIPTextConfig(**d)


# The published models' values; no config.json is in the repository, so
# they are unverified here.
# openai/clip-vit-large-patch14: FLUX's pooled encoder, legacy EOS
CLIP_L = CLIPTextConfig(eos_token_id=LEGACY_EOS)
# SD3's text_encoder: CLIP-L with a 768 projection
CLIP_L_SD3 = dataclasses.replace(CLIP_L, projection_dim=768)
# laion/CLIP-ViT-bigG-14-laion2B-39B-b160k, SD3's text_encoder_2
CLIP_BIGG = CLIPTextConfig(dim=1280, layers=32, heads=20, quick_gelu=False,
                           projection_dim=1280)


class CLIPBlock(nn.Module):
    """A pre-LayerNorm block's weights: norms in ``norm_dtype``, the fused
    qkv, the projection and the MLP in ``dtype``."""

    def __init__(self, d: int, mlp_ratio: int, eps: float, dtype: torch.dtype,
                 norm_dtype: torch.dtype, device=None):
        super().__init__()

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dtype)

        self.norm1 = nn.LayerNorm(d, eps=eps, device=device, dtype=norm_dtype)
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        self.norm2 = nn.LayerNorm(d, eps=eps, device=device, dtype=norm_dtype)
        self.mlp1, self.mlp2 = lin(d, mlp_ratio * d), lin(mlp_ratio * d, d)


def _clip_act(quick_gelu: bool):
    return (lambda x: x * torch.sigmoid(1.702 * x)) if quick_gelu else F.gelu


class CLIPTextModel(nn.Module):
    """The tower's weights. Build on ``device``, then ``init(generator)`` for
    random weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.tok = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.dim), device=device, dtype=dt))
        self.pos = nn.Parameter(torch.zeros((cfg.max_len, cfg.dim), device=device, dtype=dt))
        self.blocks = nn.ModuleList(
            CLIPBlock(cfg.dim, cfg.mlp_ratio, cfg.eps, dt, dt, device) for _ in range(cfg.layers))
        self.final_norm = nn.LayerNorm(cfg.dim, eps=cfg.eps, device=device, dtype=dt)
        self.text_proj = (None if cfg.projection_dim is None else nn.Parameter(torch.zeros(
            (cfg.dim, cfg.projection_dim), device=device, dtype=dt)))

    def init(self, generator: torch.Generator) -> "CLIPTextModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.clip.init_clip_text_params`` draws them (the
        draws themselves differ): embeddings of std 0.02, LeCun-normal
        linears with zero biases, unit norm gains. That init draws no
        projection; ``text_proj`` here is normal with std ``dim^-1/2``."""
        def randn(shape, std):
            return torch.randn(shape, generator=generator, device=generator.device) * std

        with torch.no_grad():
            self.tok.copy_(randn(self.tok.shape, 0.02))
            self.pos.copy_(randn(self.pos.shape, 0.02))
            for blk in self.blocks:
                for m in (blk.qkv, blk.proj, blk.mlp1, blk.mlp2):
                    init_linear_(m, generator)
            if self.text_proj is not None:
                self.text_proj.copy_(randn(self.text_proj.shape, 1.0 / math.sqrt(self.cfg.dim)))
        return self


@torch.inference_mode()
def clip_text_forward(model: CLIPTextModel, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None, hidden_skip: int = 0,
                      project: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ids ``[B, S]`` -> ``(hidden f32[B, S, d], pooled f32[B, d or
    projection_dim])``.

    ``hidden_skip=0``: hidden is the final-normed last state. ``hidden_skip=k
    > 0``: the un-normed output of block ``layers - 1 - k`` (diffusers'
    ``hidden_states[-(k + 1)]``; the SD3 recipe takes k = 1), while pooled
    still comes from the full normed pass. ``project=True`` multiplies
    pooled by ``text_proj`` and raises ``ValueError`` on a model without
    one."""
    cfg = model.cfg
    if not 0 <= hidden_skip < cfg.layers:
        raise ValueError(f"hidden_skip {hidden_skip} outside [0, {cfg.layers})")
    if project and model.text_proj is None:
        raise ValueError("project=True needs text_proj (a CLIPTextModelWithProjection); "
                         "this model has none")
    dev = model.tok.device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    h = model.tok[input_ids] + model.pos[:s]
    keep = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[None, None]
    if attention_mask is not None:
        keep = keep & attention_mask.to(dev)[:, None, None, :].bool()
    bias = torch.zeros(keep.shape, dtype=torch.float32, device=dev).masked_fill(
        ~keep, float("-inf"))
    hd = cfg.dim // cfg.heads
    scale = 1.0 / math.sqrt(hd)

    def ln(m, x):
        return layer_norm(x, m.weight, m.bias, eps=cfg.eps)

    act = _clip_act(cfg.quick_gelu)
    hidden = None
    for i, blk in enumerate(model.blocks):
        q, k, v = (t.unflatten(-1, (cfg.heads, hd)).transpose(1, 2).float()
                   for t in blk.qkv(ln(blk.norm1, h)).chunk(3, dim=-1))
        p = torch.softmax((q @ k.transpose(-1, -2)) * scale + bias, dim=-1)
        a = (p @ v).transpose(1, 2).reshape(b, s, cfg.dim)
        h = h + blk.proj(a.to(h.dtype))
        h = h + blk.mlp2(act(blk.mlp1(ln(blk.norm2, h))))
        if hidden_skip and i == cfg.layers - 1 - hidden_skip:
            hidden = h.float()
    h = ln(model.final_norm, h).float()
    if cfg.legacy_eos:
        eos = input_ids.argmax(-1)
    else:
        eos = (input_ids == cfg.eos_token_id).int().argmax(-1)
    pooled = h[torch.arange(b, device=dev), eos]
    if project:
        pooled = pooled @ model.text_proj.float()
    return (h if hidden is None else hidden), pooled


# the CLIP image normalization (per RGB channel)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The CLIP vision tower (the JAX package's ``CLIPVisionConfig``; the
    defaults are ViT-H/14's, Wan i2v's tower). ``use_penultimate``: return
    the states after ``layers - 1`` blocks without the post-norm. ``eps``:
    the LayerNorms' epsilon, the JAX package's ``layer_norm`` default."""

    dim: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: int = 4
    patch: int = 14
    image_size: int = 224
    use_penultimate: bool = True
    quick_gelu: bool = False
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "CLIPVisionConfig":
        d = dict(dim=32, layers=2, heads=4, patch=8, image_size=32)
        d.update(kw)
        return CLIPVisionConfig(**d)


# Wan2.1 i2v's image encoder: the XLM-Roberta-CLIP ViT-H/14 tower at 224 px,
# 257 tokens of 1,280 (the published model's values; unverified here)
CLIP_VIT_H = CLIPVisionConfig()


class CLIPVisionModel(nn.Module):
    """The vision tower's weights, named as the JAX tree's keys: the patch
    embedding and the blocks' linears in ``cfg.dtype``, the class token,
    positions and norms f32. Build on ``device``, then ``init(generator)``
    or ``load_state_dict`` (``models.convert.clip_vision_params_from_numpy``)."""

    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt, f32 = cfg.dim, cfg.torch_dtype, torch.float32
        self.patch_embed = nn.Linear(3 * cfg.patch * cfg.patch, d, device=device, dtype=dt)
        self.cls = nn.Parameter(torch.zeros(d, device=device))
        self.pos = nn.Parameter(torch.zeros((cfg.tokens, d), device=device))
        self.pre_norm = nn.LayerNorm(d, eps=cfg.eps, device=device, dtype=f32)
        self.blocks = nn.ModuleList(CLIPBlock(d, cfg.mlp_ratio, cfg.eps, dt, f32, device)
                                    for _ in range(cfg.layers))
        self.post_norm = nn.LayerNorm(d, eps=cfg.eps, device=device, dtype=f32)

    def init(self, generator: torch.Generator) -> "CLIPVisionModel":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.clip.init_clip_vision_params`` draws them (the
        draws themselves differ): class token and positions of std 0.02,
        LeCun-normal linears with zero biases, unit norm gains."""
        with torch.no_grad():
            for p in (self.cls, self.pos):
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device)
                        * 0.02)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def _tower_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over ``[B, S, H, D]``: ``attention()`` (K1 above 128
    tokens), which on the card takes bf16, so there q, k and v are rounded
    to bf16 and the output is taken back to q's dtype; the CPU's plain
    version keeps q's dtype throughout."""
    if q.is_cuda and q.dtype != torch.bfloat16:
        return attention(*(t.to(torch.bfloat16) for t in (q, k, v))).to(q.dtype)
    return attention(q, k, v)


@torch.inference_mode()
def clip_vision_forward(model: CLIPVisionModel, images: torch.Tensor) -> torch.Tensor:
    """CLIP-normalized images ``[B, H, W, 3]`` -> token states ``f32[B,
    tokens, dim]``: the penultimate block's when ``cfg.use_penultimate``,
    else the post-normed last block's."""
    cfg = model.cfg
    dev = model.cls.device
    b, hh, ww, _ = images.shape
    p = cfg.patch
    x = images.to(dev).reshape(b, hh // p, p, ww // p, p, 3).permute(0, 1, 3, 5, 2, 4)
    h = model.patch_embed(x.reshape(b, (hh // p) * (ww // p), 3 * p * p).to(cfg.torch_dtype))
    cls = model.cls.to(h.dtype).expand(b, 1, cfg.dim)
    h = torch.cat([cls, h], dim=1) + model.pos.to(h.dtype)

    def ln(m, x):
        return layer_norm(x, m.weight, m.bias, eps=cfg.eps)

    h = ln(model.pre_norm, h)
    act = _clip_act(cfg.quick_gelu)
    n_run = cfg.layers - 1 if cfg.use_penultimate else cfg.layers
    for blk in model.blocks[:n_run]:
        q, k, v = (t.unflatten(-1, (cfg.heads, -1))
                   for t in blk.qkv(ln(blk.norm1, h)).chunk(3, dim=-1))
        h = h + blk.proj(_tower_attention(q, k, v).flatten(2))
        h = h + blk.mlp2(act(blk.mlp1(ln(blk.norm2, h))))
    if not cfg.use_penultimate:
        h = ln(model.post_norm, h)
    return h.float()


def preprocess_clip_image(image, cfg: CLIPVisionConfig) -> torch.Tensor:
    """An image ``[H, W, 3]`` (or a batch ``[B, H, W, 3]``), uint8 or float in
    [0, 1] -> CLIP-normalized ``f32[B, S, S, 3]`` on the CPU: resized
    bicubically to the tower's input size (``utils.misc.resize_bicubic``),
    clipped to [0, 1], then the CLIP mean and std."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = torch.from_numpy(np.asarray(img, np.float32))
    if img.dim() == 3:
        img = img[None]
    s = cfg.image_size
    img = resize_bicubic(img, (s, s)).clamp(0.0, 1.0)
    return (img - torch.tensor(CLIP_IMAGE_MEAN)) / torch.tensor(CLIP_IMAGE_STD)


# ---- published checkpoints ------------------------------------------------------

def _strip_prefix(sd: dict, prefix: str) -> dict:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def convert_clip_vision_state_dict(sd: dict, cfg: CLIPVisionConfig) -> dict:
    """The official Wan CLIP visual tower (``wan/modules/clip.py``, under
    ``visual.``: ``patch_embedding``, ``cls_embedding``, ``pos_embedding``,
    ``pre_norm``, ``transformer.N.{norm1, attn.to_qkv, attn.proj, norm2,
    mlp.0, mlp.2}``, ``post_norm``) as the JAX CLIP vision tree."""
    from magcache_tpu_torch.models.checkpoint import conv_as_linear, lin, stack, vec

    sd = _strip_prefix(sd, "visual.")
    dt, d = cfg.torch_dtype, cfg.dim
    pe = conv_as_linear({**sd, "patch_embedding.bias": sd.get(
        "patch_embedding.bias", torch.zeros(d))}, "patch_embedding", dt)
    t = "transformer.{}."

    def ln(name, part):
        return [vec(sd, (t + name).format(i) + f".{part}") for i in range(cfg.layers)]

    def group(name):
        return stack([lin(sd, (t + name).format(i), dt) for i in range(cfg.layers)])

    return {"patch_embed": pe, "cls": vec(sd, "cls_embedding").reshape(d),
            "pos": vec(sd, "pos_embedding").reshape(-1, d),
            "pre_norm_w": vec(sd, "pre_norm.weight"), "pre_norm_b": vec(sd, "pre_norm.bias"),
            "blocks": {"norm1_w": ln("norm1", "weight"), "norm1_b": ln("norm1", "bias"),
                       "qkv": group("attn.to_qkv"), "proj": group("attn.proj"),
                       "norm2_w": ln("norm2", "weight"), "norm2_b": ln("norm2", "bias"),
                       "mlp1": group("mlp.0"), "mlp2": group("mlp.2")},
            "post_norm_w": vec(sd, "post_norm.weight"), "post_norm_b": vec(sd, "post_norm.bias")}


def _hf_blocks(sd: dict, layers: int, dt) -> dict:
    """An HF CLIP encoder's blocks (separate q/k/v fused) as JAX's tree."""
    from magcache_tpu_torch.models.checkpoint import cat_lin, lin, stack, vec

    e = "encoder.layers.{}."

    def ln(name, part):
        return [vec(sd, (e + name).format(i) + f".{part}") for i in range(layers)]

    def group(name):
        return stack([lin(sd, (e + name).format(i), dt) for i in range(layers)])

    qkv = stack([cat_lin(sd, [f"encoder.layers.{i}.self_attn.{n}_proj" for n in "qkv"], dt)
                 for i in range(layers)])
    return {"norm1_w": ln("layer_norm1", "weight"), "norm1_b": ln("layer_norm1", "bias"),
            "qkv": qkv, "proj": group("self_attn.out_proj"),
            "norm2_w": ln("layer_norm2", "weight"), "norm2_b": ln("layer_norm2", "bias"),
            "mlp1": group("mlp.fc1"), "mlp2": group("mlp.fc2")}


def convert_hf_clip_vision_state_dict(sd: dict, cfg: CLIPVisionConfig) -> dict:
    """A ``transformers.CLIPVisionModel`` state dict (``vision_model.``) as
    the JAX CLIP vision tree, q/k/v fused."""
    from magcache_tpu_torch.models.checkpoint import conv_as_linear, vec

    sd = _strip_prefix(sd, "vision_model.")
    dt, d = cfg.torch_dtype, cfg.dim
    pe = conv_as_linear({**sd, "embeddings.patch_embedding.bias": sd.get(
        "embeddings.patch_embedding.bias", torch.zeros(d))}, "embeddings.patch_embedding", dt)
    return {"patch_embed": pe, "cls": vec(sd, "embeddings.class_embedding").reshape(d),
            "pos": vec(sd, "embeddings.position_embedding.weight"),
            "pre_norm_w": vec(sd, "pre_layrnorm.weight"),
            "pre_norm_b": vec(sd, "pre_layrnorm.bias"),
            "blocks": _hf_blocks(sd, cfg.layers, dt),
            "post_norm_w": vec(sd, "post_layernorm.weight"),
            "post_norm_b": vec(sd, "post_layernorm.bias")}


def convert_clip_text_state_dict(sd: dict, cfg: CLIPTextConfig) -> dict:
    """A ``transformers.CLIPTextModel`` / ``CLIPTextModelWithProjection``
    state dict (``text_model.``) as the JAX CLIP text tree, q/k/v fused;
    ``text_projection.weight`` becomes ``text_proj`` (SD3, Vchitect)."""
    from magcache_tpu_torch.models.checkpoint import vec

    proj = sd.get("text_projection.weight")
    sd = _strip_prefix(sd, "text_model.")
    dt = cfg.torch_dtype
    tree = {"tok": vec(sd, "embeddings.token_embedding.weight", dt),
            "pos": vec(sd, "embeddings.position_embedding.weight", dt),
            "blocks": _hf_blocks(sd, cfg.layers, dt),
            "final_norm_w": vec(sd, "final_layer_norm.weight"),
            "final_norm_b": vec(sd, "final_layer_norm.bias")}
    if proj is not None:
        tree["text_proj"] = proj.T
    return tree


def load_clip_text(path: str, device="cuda") -> Tuple[CLIPTextConfig, "CLIPTextModel"]:
    """``(config, model)`` of an HF CLIP text directory: the config from its
    ``config.json`` (``text_config`` when nested) as the JAX encoder reads
    it, ``projection_dim`` from ``text_projection.weight``."""
    import json
    import os

    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir
    from magcache_tpu_torch.models.convert import clip_text_params_from_numpy

    sd = load_safetensors_dir(path)
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    hf = hf.get("text_config", hf)
    proj = sd.get("text_projection.weight")
    cfg = CLIPTextConfig(
        vocab_size=hf["vocab_size"], dim=hf["hidden_size"], layers=hf["num_hidden_layers"],
        heads=hf["num_attention_heads"], mlp_ratio=hf["intermediate_size"] // hf["hidden_size"],
        max_len=hf["max_position_embeddings"], eos_token_id=hf.get("eos_token_id", 49407),
        quick_gelu=hf.get("hidden_act", "quick_gelu") == "quick_gelu",
        projection_dim=None if proj is None else int(proj.shape[0]))
    model = CLIPTextModel(cfg, torch.device(device))
    model.load_state_dict(clip_text_params_from_numpy(convert_clip_text_state_dict(sd, cfg),
                                                      cfg, device))
    return cfg, model


def load_clip_vision(path: str, cfg: CLIPVisionConfig, device="cuda") -> "CLIPVisionModel":
    """A ``CLIPVisionModel(cfg)`` from the Wan CLIP ``.pth`` (``visual.``
    keys) or an HF ``CLIPVisionModel`` checkpoint (``vision_model.``)."""
    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir, torch_load_flat
    from magcache_tpu_torch.models.convert import clip_vision_params_from_numpy

    sd = (torch_load_flat(path) if path.endswith((".pth", ".pt", ".bin"))
          else load_safetensors_dir(path))
    hf = any(k.startswith(("vision_model.", "embeddings.")) for k in sd)
    tree = (convert_hf_clip_vision_state_dict if hf else convert_clip_vision_state_dict)(sd, cfg)
    model = CLIPVisionModel(cfg, torch.device(device))
    model.load_state_dict(clip_vision_params_from_numpy(tree, cfg, device))
    return model
