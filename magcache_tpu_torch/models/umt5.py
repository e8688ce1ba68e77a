"""UMT5 text encoder (umt5-xxl, Wan's text conditioning) as PyTorch modules.

Same model as ``magcache_tpu.models.umt5``: pre-norm T5 encoder blocks whose
self-attention adds a relative-position bias that every layer owns (UMT5's
difference from classic T5, which computes the bias once in block 0), no
``1/sqrt(d_kv)`` score scale, a ``-1e9`` bias on padded keys, an f32
softmax, a gated tanh-gelu feed-forward, a final RMS norm, and padded
positions zeroed in the output. GEMMs, the bias gather and the softmax are
plain PyTorch ops: the JAX function reaches no Pallas kernel.

``UMT5Model(cfg, device).init(generator)`` draws random weights;
``models.convert.umt5_params_from_numpy`` carries the JAX package's
parameter tree over. ``UMT5Encoder`` tokenizes prompts to a fixed length and
encodes them. Checkpoint loading and real tokenizers are not ported (no
checkpoint or tokenizer file in the repository).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from magcache_tpu_torch.models.common import DTYPES, init_linear_
from magcache_tpu_torch.ops.norms import rms_norm

__all__ = ["UMT5Config", "UMT5Model", "UMT5Encoder", "UMT5_XXL", "umt5_encode",
           "relative_position_buckets"]


@dataclasses.dataclass(frozen=True)
class UMT5Config:
    vocab_size: int = 256384           # umt5-xxl
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    layers: int = 24
    heads: int = 64
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6
    dtype: str = "float32"

    @property
    def inner(self) -> int:
        return self.heads * self.d_kv

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "UMT5Config":
        d = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, layers=3, heads=4,
                 rel_buckets=8, rel_max_distance=16)
        d.update(kw)
        return UMT5Config(**d)


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


class UMT5Block(nn.Module):
    """One encoder layer; parameter names follow the JAX keys."""

    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.torch_dtype

        def lin(d_in, d_out):
            return nn.Linear(d_in, d_out, bias=False, device=device, dtype=dt)

        self.ln1 = nn.Parameter(torch.ones(d, device=device, dtype=dt))
        self.q, self.k, self.v = (lin(d, cfg.inner) for _ in range(3))
        self.o = lin(cfg.inner, d)
        self.rel = nn.Parameter(torch.zeros((cfg.rel_buckets, cfg.heads), device=device,
                                            dtype=dt))
        self.ln2 = nn.Parameter(torch.ones(d, device=device, dtype=dt))
        self.wi0, self.wi1 = lin(d, cfg.d_ff), lin(d, cfg.d_ff)
        self.wo = lin(cfg.d_ff, d)


class UMT5Model(nn.Module):
    """The encoder's weights. Build on ``device``, then ``init(generator)``
    for random weights or ``load_state_dict`` (``models/convert.py``)."""

    def __init__(self, cfg: UMT5Config, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.zeros((cfg.vocab_size, cfg.d_model),
                                              device=device, dtype=cfg.torch_dtype))
        self.blocks = nn.ModuleList(UMT5Block(cfg, device) for _ in range(cfg.layers))
        self.final_ln = nn.Parameter(torch.ones(cfg.d_model, device=device,
                                                dtype=cfg.torch_dtype))

    def init(self, generator: torch.Generator) -> "UMT5Model":
        """Random weights from ``generator`` (on its device), drawn as
        ``magcache_tpu.models.umt5.init_umt5_params`` draws them (the draws
        themselves differ): a unit-normal embedding, LeCun-normal linears,
        relative biases of std 0.1, unit norm gains."""
        def randn(shape):
            return torch.randn(shape, generator=generator, device=generator.device)

        with torch.no_grad():
            self.embed.copy_(randn(self.embed.shape))
            for blk in self.blocks:
                for m in (blk.q, blk.k, blk.v, blk.o, blk.wi0, blk.wi1, blk.wo):
                    init_linear_(m, generator)
                blk.rel.copy_(randn(blk.rel.shape) * 0.1)
        return self


@torch.inference_mode()
def umt5_encode(model: UMT5Model, input_ids: torch.Tensor,
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

    for blk in model.blocks:
        x = rms_norm(h, blk.ln1, eps=cfg.eps)
        q, k, v = heads(blk.q(x)), heads(blk.k(x)), heads(blk.v(x))
        # T5 scores carry no 1/sqrt(d_kv) (folded into its init)
        scores = (q @ k.transpose(-1, -2)).float()
        scores = scores + blk.rel[buckets].permute(2, 0, 1)[None].float() + mask_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        h = h + blk.o((probs @ v).transpose(1, 2).reshape(b, s, cfg.inner))
        x = rms_norm(h, blk.ln2, eps=cfg.eps)
        h = h + blk.wo(F.gelu(blk.wi0(x), approximate="tanh") * blk.wi1(x))
    h = rms_norm(h, model.final_ln, eps=cfg.eps)
    return h * attention_mask[..., None].to(h.dtype)


class UMT5Encoder:
    """Prompts -> ``[B, seq_len, d_model]`` (``magcache_tpu.models.umt5.
    UMT5Encoder`` built from a config): the encoder on ``device`` with random
    weights from ``generator`` (default: seed 0 on ``device``), or the given
    ``model``. ``tokenizer`` (e.g. ``models.text.FallbackHashTokenizer``)
    turns prompts into ids for ``__call__``; ``encode_ids`` takes ids."""

    def __init__(self, cfg: UMT5Config, seq_len: int = 512, tokenizer=None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 model: Optional[UMT5Model] = None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.tokenizer = tokenizer
        if model is None:
            device = torch.device(device)
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            model = UMT5Model(cfg, device).init(generator)
        self.model = model.requires_grad_(False).eval()

    def encode_ids(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Ids ``[B, L]`` (numpy or tensor) -> ``[B, L, d_model]``."""
        ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                              else input_ids)
        mask = None if attention_mask is None else torch.as_tensor(
            np.asarray(attention_mask) if not torch.is_tensor(attention_mask)
            else attention_mask)
        return umt5_encode(self.model, ids, mask)

    def __call__(self, prompts: Sequence[str], device=None) -> torch.Tensor:
        """Tokenize ``prompts`` to ``seq_len`` and encode them; the result on
        ``device`` (default: the encoder's)."""
        if self.tokenizer is None:
            raise ValueError("UMT5Encoder: raw prompts need a tokenizer; pass ids "
                             "to encode_ids")
        tok = self.tokenizer(list(prompts), padding="max_length", truncation=True,
                             max_length=self.seq_len, return_tensors="np")
        out = self.encode_ids(tok["input_ids"], tok["attention_mask"])
        return out if device is None else out.to(device)
