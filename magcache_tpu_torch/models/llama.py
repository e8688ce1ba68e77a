"""Llama-architecture text encoder (HunyuanVideo's and FramePack's
llava-llama-3-8b conditioning stack, and the Qwen2.5-VL-7B text tower of
Qwen-Image), as PyTorch modules.

Same architecture as ``magcache_tpu.models.llama``: token embedding, pre-norm
blocks (RMSNorm -> grouped-query attention with the half-split rotary
embedding -> RMSNorm -> SwiGLU MLP), final RMSNorm. The encoder takes an
intermediate hidden state, ``hidden_states[-(skip + 1)]``: only the first
``layers - skip`` blocks run. The JAX attention here is an einsum with a
causal and key-padding mask, not a Pallas kernel, so it is plain PyTorch
here as well (f32 scores and softmax). The Qwen2.5-VL extensions: vision
tokens spliced over chosen embeddings (``embeds_override``,
``override_mask``) and 3-axis M-RoPE (``position_ids``, ``mrope_section``).
Checkpoint conversion (``convert_llama_state_dict``) is not ported;
``models/convert.py::llama_params_from_numpy`` carries the JAX package's
tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["LlamaConfig", "LlamaModel", "LLAVA_LLAMA3_8B", "QWEN25_VL_7B",
           "QWEN25_VL_MROPE_SECTION", "llama_hidden_states", "rope_llama"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320           # llava-llama-3-8b
    hidden: int = 4096
    layers: int = 32
    heads: int = 32
    kv_heads: int = 8
    intermediate: int = 14336
    rope_theta: float = 500000.0
    eps: float = 1e-5
    qkv_bias: bool = False             # Qwen2 lineage
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """A test-size config (the JAX package's ``LlamaConfig.tiny``)."""
        d = dict(vocab_size=128, hidden=32, layers=2, heads=4, kv_heads=2,
                 intermediate=64, rope_theta=10000.0)
        d.update(kw)
        return LlamaConfig(**d)


# hyvideo's text encoder, llava-llama-3-8b without its output head (7.5 B
# parameters, 30.0 GB in f32)
LLAVA_LLAMA3_8B = LlamaConfig()

# Qwen2.5-VL-7B-Instruct's text tower (its config.json ``text_config``),
# Qwen-Image's conditioning LM: 7.07 B parameters without the output head,
# 28.3 GB in f32; its M-RoPE splits the 64 frequency bands 16 / 24 / 24
# over the (t, h, w) axes (``rope_scaling.mrope_section``)
QWEN25_VL_7B = LlamaConfig(vocab_size=152064, hidden=3584, layers=28, heads=28, kv_heads=4,
                           intermediate=18944, rope_theta=1e6, eps=1e-6, qkv_bias=True)
QWEN25_VL_MROPE_SECTION = (16, 24, 24)


class LlamaBlock(nn.Module):
    """One decoder block; names follow the JAX pytree."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        d, hd, dt = cfg.hidden, cfg.head_dim, cfg.torch_dtype

        def lin(d_in, d_out, bias=False):
            return nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dt)

        self.in_norm = nn.Parameter(torch.ones(d, device=device))
        self.q = lin(d, cfg.heads * hd, cfg.qkv_bias)
        self.k = lin(d, cfg.kv_heads * hd, cfg.qkv_bias)
        self.v = lin(d, cfg.kv_heads * hd, cfg.qkv_bias)
        self.o = lin(cfg.heads * hd, d)
        self.post_norm = nn.Parameter(torch.ones(d, device=device))
        self.gate = lin(d, cfg.intermediate)
        self.up = lin(d, cfg.intermediate)
        self.down = lin(cfg.intermediate, d)


class LlamaModel(nn.Module):
    """Build on ``device``, then ``init(generator)`` for random weights or
    ``load_state_dict``."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.hidden, device=device,
                                              dtype=cfg.torch_dtype))
        self.blocks = nn.ModuleList(LlamaBlock(cfg, device) for _ in range(cfg.layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.hidden, device=device))

    def init(self, generator: torch.Generator) -> "LlamaModel":
        """Random weights from ``generator``: the embedding N(0, 0.02^2),
        LeCun-normal linears with zero bias, unit norm gains, as
        ``init_llama_params`` draws them (the draws themselves differ)."""
        with torch.no_grad():
            e = torch.randn(self.embed.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            self.embed.copy_(e * 0.02)
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    init_linear_(m, generator)
        return self


def rope_llama(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """transformers-convention rotary on ``[B, S, H, D]``: rotate_half over
    the half split (not pair-interleaved), ``[S, D/2]`` tables (or per-row
    ``[B, S, D/2]`` ones, M-RoPE's) broadcast to both halves."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _rope_tables(cfg: LlamaConfig, s: int, position_ids, mrope_section, dev):
    """``(cos, sin)``: ``[S, D/2]`` over positions 0..S-1 (host f64 angles),
    or with ``position_ids`` ``[3, B, S]`` M-RoPE's ``[B, S, D/2]``, band i
    of the half dim at axis ``i % 3``'s position (f32 angles on the device,
    as the JAX function computes them)."""
    inv = cfg.rope_theta ** (-np.arange(0, cfg.head_dim, 2, dtype=np.float64) / cfg.head_dim)
    if position_ids is None:
        ang = np.arange(s)[:, None] * inv[None, :]
        return tuple(torch.from_numpy(f(ang).astype(np.float32)).to(dev)
                     for f in (np.cos, np.sin))
    sec = list(mrope_section or (cfg.head_dim // 2,))
    if sum(sec) != cfg.head_dim // 2:
        raise ValueError(f"mrope_section {tuple(sec)} must cover head_dim / 2 = "
                         f"{cfg.head_dim // 2}")
    take = torch.from_numpy(np.repeat(np.arange(len(sec)) % 3, sec)).to(dev)
    pos = torch.as_tensor(position_ids, device=dev).float()        # [3, B, S]
    inv32 = torch.from_numpy(inv.astype(np.float32)).to(dev)
    ang = pos[take].permute(1, 2, 0) * inv32                        # [B, S, D/2]
    return torch.cos(ang), torch.sin(ang)


@torch.inference_mode()
def llama_hidden_states(model: LlamaModel, input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None,
                        skip_layers: int = 0, final_norm: bool = False,
                        embeds_override: Optional[torch.Tensor] = None,
                        override_mask: Optional[torch.Tensor] = None,
                        position_ids=None, mrope_section=None) -> torch.Tensor:
    """Causal forward returning the hidden state after block ``layers -
    skip_layers``, f32 ``[B, S, d]`` (hyvideo's ``hidden_states[-(skip+1)]``);
    ``final_norm`` applies the final RMSNorm (meant for ``skip_layers == 0``).
    ``attention_mask`` (1 keep, 0 padding) masks keys.

    Qwen2.5-VL: ``embeds_override`` ``[B, S, d]`` replaces the embeddings
    where ``override_mask`` ``bool[B, S]`` is set (the vision tokens at the
    ``<|image_pad|>`` positions); ``position_ids`` ``int[3, B, S]`` with
    ``mrope_section`` applies 3-axis M-RoPE."""
    cfg = model.cfg
    dev = model.embed.device
    ids = torch.as_tensor(input_ids, device=dev).long()
    b, s = ids.shape
    h = model.embed[ids]
    if embeds_override is not None:
        ov_mask = torch.as_tensor(override_mask, device=dev).bool()[..., None]
        h = torch.where(ov_mask, torch.as_tensor(embeds_override, device=dev).to(h.dtype), h)
    cos, sin = _rope_tables(cfg, s, position_ids, mrope_section, dev)
    keep = torch.ones((s, s), dtype=torch.bool, device=dev).tril()[None, None]
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=dev).bool()
        keep = keep & mask[:, None, None, :]
    bias = torch.zeros(keep.shape, dtype=torch.float32, device=dev).masked_fill(
        ~keep, float("-inf"))
    hq, hk, hd = cfg.heads, cfg.kv_heads, cfg.head_dim
    scale = 1.0 / float(np.sqrt(hd))
    for blk in model.blocks[:cfg.layers - skip_layers]:
        n = rms_norm(h, blk.in_norm, eps=cfg.eps)
        q = rope_llama(blk.q(n).reshape(b, s, hq, hd).float(), cos, sin)
        k = rope_llama(blk.k(n).reshape(b, s, hk, hd).float(), cos, sin)
        v = blk.v(n).reshape(b, s, hk, hd).float()
        k, v = (t.repeat_interleave(hq // hk, dim=2) for t in (k, v))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
        a = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)
        h = h + blk.o(a.reshape(b, s, hq * hd).to(h.dtype))
        n = rms_norm(h, blk.post_norm, eps=cfg.eps)
        h = h + blk.down(F.silu(blk.gate(n)) * blk.up(n))
    if final_norm:
        h = rms_norm(h, model.final_norm, eps=cfg.eps)
    return h.float()


# ---- published checkpoints ------------------------------------------------------

def convert_llama_state_dict(sd: dict, cfg: LlamaConfig) -> dict:
    """A ``transformers.LlamaModel`` state dict (``model.`` tolerated) as the
    JAX Llama tree; Qwen2-lineage q/k/v biases where present."""
    from magcache_tpu_torch.models.checkpoint import vec

    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    dt, L = cfg.torch_dtype, cfg.layers

    def group(name):
        p = {"w": [vec(sd, f"layers.{i}.{name}.weight", dt).T for i in range(L)]}
        if f"layers.0.{name}.bias" in sd:
            p["b"] = [vec(sd, f"layers.{i}.{name}.bias", dt) for i in range(L)]
        return p

    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    blocks = {ours: group(theirs) for ours, theirs in names.items()}
    blocks["in_norm"] = [vec(sd, f"layers.{i}.input_layernorm.weight") for i in range(L)]
    blocks["post_norm"] = [vec(sd, f"layers.{i}.post_attention_layernorm.weight")
                           for i in range(L)]
    return {"embed": vec(sd, "embed_tokens.weight", dt), "blocks": blocks,
            "final_norm": vec(sd, "norm.weight")}


def llama_config_from_json(hf: dict, qkv_bias: Optional[bool] = None,
                           rope_theta: float = 10000.0, eps: float = 1e-5) -> LlamaConfig:
    """A ``LlamaConfig`` from an HF ``config.json``'s text part, as the JAX
    encoders read it; Qwen2-lineage model types carry q/k/v biases."""
    if qkv_bias is None:
        qkv_bias = bool(hf.get("attention_bias", False) or hf.get("model_type", "") in (
            "qwen2", "qwen2_vl", "qwen2_5_vl", "qwen2_5_vl_text"))
    return LlamaConfig(vocab_size=hf["vocab_size"], hidden=hf["hidden_size"],
                       layers=hf["num_hidden_layers"], heads=hf["num_attention_heads"],
                       kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
                       intermediate=hf["intermediate_size"],
                       rope_theta=hf.get("rope_theta", rope_theta),
                       eps=hf.get("rms_norm_eps", eps), qkv_bias=qkv_bias)


def load_llama(sd: dict, cfg: LlamaConfig, device="cuda") -> "LlamaModel":
    """A ``LlamaModel(cfg)`` on ``device`` from a published state dict."""
    from magcache_tpu_torch.models.convert import llama_params_from_numpy

    model = LlamaModel(cfg, torch.device(device))
    model.load_state_dict(llama_params_from_numpy(convert_llama_state_dict(sd, cfg), cfg,
                                                  device))
    return model
