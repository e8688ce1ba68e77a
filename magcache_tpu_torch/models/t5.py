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
and encodes them. Checkpoint loading and real tokenizers are not ported (no
checkpoint or tokenizer file in the repository).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["T5Config", "UMT5Config", "T5Model", "t5_encode", "relative_position_buckets",
           "T5_V1_1_XXL", "MT5_XXL", "UMT5_XXL"]

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
