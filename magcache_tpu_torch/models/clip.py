"""The CLIP text tower as PyTorch modules: FLUX's pooled encoder (CLIP-L) and
the two CLIP towers of the SD3 stack (CLIP-L and CLIP-bigG with
projection, Vchitect's).

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
``models.text.ClipTextEncoder`` tokenizes prompts and encodes them. The
vision tower, checkpoint loading and the BPE tokenizer are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import layer_norm

__all__ = ["CLIPTextConfig", "CLIPTextModel", "clip_text_forward", "CLIP_L", "CLIP_L_SD3",
           "CLIP_BIGG", "LEGACY_EOS"]

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


class CLIPTextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        d, dt = cfg.dim, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, device=device, dtype=dt)

        self.norm1 = nn.LayerNorm(d, eps=cfg.eps, device=device, dtype=dt)
        self.qkv, self.proj = lin(d, 3 * d), lin(d, d)
        self.norm2 = nn.LayerNorm(d, eps=cfg.eps, device=device, dtype=dt)
        self.mlp1, self.mlp2 = lin(d, cfg.mlp_ratio * d), lin(cfg.mlp_ratio * d, d)


class CLIPTextModel(nn.Module):
    """The tower's weights. Build on ``device``, then ``init(generator)`` for
    random weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: CLIPTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        self.tok = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.dim), device=device, dtype=dt))
        self.pos = nn.Parameter(torch.zeros((cfg.max_len, cfg.dim), device=device, dtype=dt))
        self.blocks = nn.ModuleList(CLIPTextBlock(cfg, device) for _ in range(cfg.layers))
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

    def act(x):
        return x * torch.sigmoid(1.702 * x) if cfg.quick_gelu else F.gelu(x)

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
