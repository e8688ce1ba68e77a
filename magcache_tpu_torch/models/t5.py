"""The T5-family text encoders (classic T5, T5 v1.1, mT5 and UMT5) as one
PyTorch encoder.

The counterpart of the JAX package's two T5 encoders:
``magcache_tpu.models.text.JaxT5Encoder`` (HF Flax T5 / mT5, where block 0
computes the relative-position bias and every layer reuses it) and
``magcache_tpu.models.umt5`` (every layer owns its bias table). Both run
pre-norm blocks whose self-attention adds the bias, with no ``1/sqrt(d_kv)``
score scale, a large negative bias on padded keys and an f32 softmax; then
a relu (``wi``) or gated tanh-gelu (``wi0``/``wi1``) feed-forward, a final
RMS norm, and padded positions zeroed in the output. GEMMs, the bias gather
and the softmax are plain PyTorch ops: neither JAX function reaches a Pallas
kernel.

``T5Model(cfg, device).init(generator)`` draws random weights;
``models.convert.t5_params_from_flax`` and ``umt5_params_from_numpy`` carry
the JAX package's trees over. ``models.text.T5Encoder`` tokenizes prompts
and encodes them. ``load_t5_encoder`` reads a checkpoint: a UMT5 one (by
``config.json``'s ``model_type``, a ``*umt5*.pth`` name, or the wan
package's key names) through ``models.umt5.load_umt5_encoder``, any other
T5 / mT5 one (HF torch names) through ``convert_t5_encoder_state_dict`` and
``t5_params_from_flax``. Real tokenizers are not ported (no tokenizer file
in the repository).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["T5Config", "UMT5Config", "T5Model", "t5_encode", "relative_position_buckets",
           "T5_V1_1_XXL", "MT5_XXL", "UMT5_XXL", "convert_t5_encoder_state_dict",
           "t5_config_from_checkpoint", "is_umt5_checkpoint", "load_t5_encoder"]

FEED_FORWARDS = ("relu", "gated-gelu")


@dataclasses.dataclass(frozen=True)
class T5Config:
    """A T5-family encoder. The defaults are T5 v1.1 XXL's."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6
    dtype: str = "float32"
    # True: every layer owns a relative-bias table (UMT5); False: block 0's
    # serves every layer (T5, mT5)
    per_layer_bias: bool = False
    # "relu": one ``wi`` (the ``transformers.T5Config`` default); "gated-gelu":
    # ``wi0``/``wi1`` with tanh-gelu (T5 v1.1, mT5, UMT5)
    feed_forward: str = "gated-gelu"

    def __post_init__(self):
        if self.feed_forward not in FEED_FORWARDS:
            raise ValueError(f"feed_forward {self.feed_forward!r} is not one of "
                             f"{FEED_FORWARDS}")

    @property
    def inner(self) -> int:
        return self.heads * self.d_kv

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        d = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, layers=3, heads=4,
                 rel_buckets=8, rel_max_distance=16)
        d.update(kw)
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class UMT5Config(T5Config):
    """UMT5 (umt5-xxl by default, Wan's text encoder): a bias table in every
    layer."""

    vocab_size: int = 256384
    per_layer_bias: bool = True


# The published models' values; no config.json is in the repository, so
# they are unverified here.
# google/t5-v1_1-xxl: the T5-XXL of Open-Sora, Latte, CogVideoX, FLUX and SD3
T5_V1_1_XXL = T5Config()
# google/mt5-xxl: Open-Sora-Plan v1.2's encoder
MT5_XXL = T5Config(vocab_size=250112)
# google/umt5-xxl: Wan2.1's encoder
UMT5_XXL = UMT5Config()


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """T5's bidirectional relative-position buckets ``int64 [q_len, k_len]``
    on the host (static for a sequence length)."""
    ctx = np.arange(q_len, dtype=np.int64)[:, None]
    mem = np.arange(k_len, dtype=np.int64)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / np.log(max_distance / max_exact)
                         * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel < max_exact, rel, large)


class T5Block(nn.Module):
    """One encoder layer; ``rel`` is None where the layer reuses block 0's
    bias."""

    def __init__(self, cfg: T5Config, has_bias: bool, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dt)

        self.ln1 = nn.Parameter(torch.ones(d, device=device, dtype=dt))
        self.q, self.k, self.v = (lin(d, cfg.inner) for _ in range(3))
        self.o = lin(cfg.inner, d)
        self.rel = (nn.Parameter(torch.zeros((cfg.rel_buckets, cfg.heads), device=device,
                                             dtype=dt)) if has_bias else None)
        self.ln2 = nn.Parameter(torch.ones(d, device=device, dtype=dt))
        self.relu = cfg.feed_forward == "relu"
        if self.relu:
            self.wi = lin(d, cfg.d_ff)
        else:
            self.wi0, self.wi1 = lin(d, cfg.d_ff), lin(d, cfg.d_ff)
        self.wo = lin(cfg.d_ff, d)

    def ff_in(self) -> list:
        """The feed-forward's input projections: ``[wi]`` or ``[wi0, wi1]``."""
        return [self.wi] if self.relu else [self.wi0, self.wi1]

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.relu:
            return self.wo(F.relu(self.wi(x)))
        return self.wo(F.gelu(self.wi0(x), approximate="tanh") * self.wi1(x))


class T5Model(nn.Module):
    """The encoder's weights. Build on ``device``, then ``init(generator)``
    for random weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.d_model),
                                              device=device, dtype=cfg.torch_dtype))
        self.blocks = nn.ModuleList(T5Block(cfg, cfg.per_layer_bias or i == 0, device)
                                    for i in range(cfg.layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model, device=device,
                                                dtype=cfg.torch_dtype))

    def init(self, generator: torch.Generator) -> "T5Model":
        """Random weights from ``generator`` (on its device), with each JAX
        counterpart's distributions (the draws themselves differ).

        Shared bias (T5, mT5): the Flax T5 initialisers of the JAX T5
        encoder, all normal: the embedding std 1, q ``(inner * d_kv)^-1/2``,
        k, v, o and block 0's bias ``inner^-1/2``, ``wi*`` ``d_model^-1/2``,
        ``wo`` ``d_ff^-1/2``. Per-layer bias (UMT5): as
        ``magcache_tpu.models.umt5.init_umt5_params`` draws them, a
        unit-normal embedding, LeCun-normal linears and biases of std 0.1.
        Norm gains are ones."""
        cfg = self.cfg

        def randn(shape, std):
            return torch.randn(shape, generator=generator, device=generator.device) * std

        def normal_(p: torch.Tensor, std: float):
            p.copy_(randn(p.shape, std))

        with torch.no_grad():
            normal_(self.embed, 1.0)
            for blk in self.blocks:
                if cfg.per_layer_bias:
                    for m in [blk.q, blk.k, blk.v, blk.o, *blk.ff_in(), blk.wo]:
                        init_linear_(m, generator)
                    normal_(blk.rel, 0.1)
                    continue
                inner_std = 1.0 / math.sqrt(cfg.inner)
                normal_(blk.q.weight, 1.0 / math.sqrt(cfg.inner * cfg.d_kv))
                for m in (blk.k, blk.v, blk.o):
                    normal_(m.weight, inner_std)
                for m in blk.ff_in():
                    normal_(m.weight, 1.0 / math.sqrt(cfg.d_model))
                normal_(blk.wo.weight, 1.0 / math.sqrt(cfg.d_ff))
                if blk.rel is not None:
                    normal_(blk.rel, inner_std)
        return self


@torch.inference_mode()
def t5_encode(model: T5Model, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder forward: ids ``[B, L]`` -> final hidden states ``[B, L, d]``
    in the config's dtype, padded positions (``attention_mask`` 0) zeroed."""
    cfg = model.cfg
    b, s = input_ids.shape
    dev = model.embed.device
    input_ids = input_ids.to(dev)
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int64, device=dev)
    attention_mask = attention_mask.to(dev)
    h = model.embed[input_ids]
    mask_bias = (1.0 - attention_mask.float())[:, None, None, :] * -1e9
    buckets = torch.from_numpy(relative_position_buckets(
        s, s, cfg.rel_buckets, cfg.rel_max_distance)).to(dev)

    def heads(x):
        return x.unflatten(-1, (cfg.heads, cfg.d_kv)).transpose(1, 2)   # [B, H, L, dk]

    bias = None
    for blk in model.blocks:
        if blk.rel is not None:     # every block (UMT5), or block 0 for all (T5)
            bias = blk.rel[buckets].permute(2, 0, 1)[None].float() + mask_bias
        x = rms_norm(h, blk.ln1, eps=cfg.eps)
        q, k, v = heads(blk.q(x)), heads(blk.k(x)), heads(blk.v(x))
        # T5 scores carry no 1/sqrt(d_kv) (folded into its init)
        scores = (q @ k.transpose(-1, -2)).float() + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        h = h + blk.o((probs @ v).transpose(1, 2).reshape(b, s, cfg.inner))
        h = h + blk.feed_forward(rms_norm(h, blk.ln2, eps=cfg.eps))
    h = rms_norm(h, model.final_ln, eps=cfg.eps)
    return h * attention_mask[..., None].to(h.dtype)


# ---- checkpoints --------------------------------------------------------------

def convert_t5_encoder_state_dict(sd: Dict[str, torch.Tensor]) -> dict:
    """An HF torch T5 / mT5 encoder state dict as the Flax T5 encoder tree
    (``magcache_tpu.models.convert.convert_t5_encoder_state_dict``): linear
    weights as ``kernel [in, out]``, the embedding and norm gains as they
    are; the decoder, ``lm_head`` and the tied ``encoder.embed_tokens`` are
    left out."""
    params: dict = {}

    def put(path, value):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, v in sd.items():
        if key.startswith(("decoder.", "lm_head")) or key == "encoder.embed_tokens.weight":
            continue
        if key == "shared.weight":
            put(("shared", "embedding"), v)
            continue
        if key == "encoder.final_layer_norm.weight":
            put(("encoder", "final_layer_norm", "weight"), v)
            continue
        parts = key.split(".")
        if parts[0] != "encoder" or parts[1] != "block":
            continue
        base, rest = ("encoder", "block", parts[2], "layer", parts[4]), parts[5:]
        if rest[0] == "layer_norm":
            put(base + ("layer_norm", "weight"), v)
        elif rest[0] == "SelfAttention":
            if rest[1] == "relative_attention_bias":
                put(base + ("SelfAttention", "relative_attention_bias", "embedding"), v)
            else:
                put(base + ("SelfAttention", rest[1], "kernel"), v.T)
        elif rest[0] == "DenseReluDense":
            put(base + ("DenseReluDense", rest[1], "kernel"), v.T)
    return params


def t5_config_from_checkpoint(sd: Dict[str, torch.Tensor], config_json: Optional[dict] = None,
                              dtype: str = "float32") -> T5Config:
    """A shared-bias ``T5Config`` from an HF T5 / mT5 ``config.json``, its
    structural fields checked against (or, without one, read from) the
    weights' shapes."""
    cj = config_json or {}
    pre = "encoder.block.{}.layer."
    vocab, d_model = sd["shared.weight"].shape
    rel = sd[pre.format(0) + "0.SelfAttention.relative_attention_bias.weight"]
    gated = pre.format(0) + "1.DenseReluDense.wi_0.weight" in sd
    layers = 0
    while pre.format(layers) + "0.layer_norm.weight" in sd:
        layers += 1
    heads = int(rel.shape[1])
    kw = dict(vocab_size=int(vocab), d_model=int(d_model), layers=layers, heads=heads,
              d_kv=int(sd[pre.format(0) + "0.SelfAttention.q.weight"].shape[0]) // heads,
              d_ff=int(sd[pre.format(0) + "1.DenseReluDense.wo.weight"].shape[1]),
              rel_buckets=int(rel.shape[0]),
              rel_max_distance=int(cj.get("relative_attention_max_distance", 128)),
              eps=float(cj.get("layer_norm_epsilon", 1e-6)),
              feed_forward="gated-gelu" if gated else "relu", dtype=dtype)
    for src, dst in (("vocab_size", "vocab_size"), ("d_model", "d_model"),
                     ("num_layers", "layers"), ("num_heads", "heads"), ("d_kv", "d_kv"),
                     ("d_ff", "d_ff")):
        if src in cj and int(cj[src]) != kw[dst]:
            raise ValueError(f"config.json {src} = {cj[src]}, the weights say {kw[dst]}")
    return T5Config(**kw)


def _config_json(path: str) -> Optional[dict]:
    base = path if os.path.isdir(path) else os.path.dirname(path)
    cj = os.path.join(base, "config.json")
    if not os.path.exists(cj):
        return None
    with open(cj) as f:
        return json.load(f)


def is_umt5_checkpoint(path: str) -> bool:
    """``magcache_tpu.models.text.make_t5_encoder``'s routing: ``config.json``
    ``model_type`` ``umt5``; for any other type than ``t5`` / ``mt5``, a
    ``*umt5*`` ``.pth`` file name; without a type, the wan package's key
    names in the first safetensors header."""
    from magcache_tpu_torch.models.checkpoint import safetensors_keys

    model_type = (_config_json(path) or {}).get("model_type")
    if model_type == "umt5":
        return True
    if model_type in ("t5", "mt5"):
        return False
    cand = [path] if path.endswith(".pth") else glob.glob(os.path.join(path, "*.pth"))
    if any("umt5" in os.path.basename(c) for c in cand):
        return True
    if model_type is None:
        files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
        if not files and os.path.isfile(path) and path.endswith(".safetensors"):
            files = [path]
        for fname in files[:1]:
            keys = set(safetensors_keys(fname))
            return ("token_embedding.weight" in keys
                    or "blocks.0.pos_embedding.embedding.weight" in keys)
    return False


def load_t5_encoder(path: str, device="cuda", dtype: str = "float32"
                    ) -> Tuple[T5Config, "T5Model"]:
    """``(config, model)`` of a T5-family checkpoint, routed as
    ``is_umt5_checkpoint`` says; the weights in ``dtype`` on ``device``."""
    from magcache_tpu_torch.models.checkpoint import load_safetensors_dir
    from magcache_tpu_torch.models.convert import t5_params_from_flax
    from magcache_tpu_torch.models.umt5 import load_umt5_encoder

    if is_umt5_checkpoint(path):
        return load_umt5_encoder(path, device=device, dtype=dtype)
    sd = load_safetensors_dir(path)
    cfg = t5_config_from_checkpoint(sd, _config_json(path), dtype=dtype)
    model = T5Model(cfg, torch.device(device))
    model.load_state_dict(t5_params_from_flax(convert_t5_encoder_state_dict(sd), cfg, device))
    return cfg, model
