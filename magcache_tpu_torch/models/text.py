"""Text encoders' checkpoint-free stand-ins: the mock encoders, and the
hash tokenizer that brings prompts to ``models.umt5.UMT5Encoder`` without a
tokenizer file."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MockTextEncoder:
    """Deterministic stand-in: ``seq_len x dim`` gaussian embeddings seeded by
    the prompt's sha256, drawn with numpy so they equal the JAX package's
    ``MockTextEncoder`` bit for bit."""

    seq_len: int
    dim: int
    scale: float = 1.0

    def __call__(self, prompts: Sequence[str],
                 device: Optional[torch.device] = None) -> torch.Tensor:
        outs = []
        for p in prompts:
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
            rng = np.random.default_rng(seed)
            outs.append(rng.normal(0, self.scale, (self.seq_len, self.dim)))
        return torch.from_numpy(np.stack(outs).astype(np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class MockPooledEncoder:
    """CLIP-pooled stand-in: one ``dim`` gaussian vector per prompt, seeded
    by bytes 4..8 of the prompt's sha256 (``MockTextEncoder`` takes bytes
    0..4), equal to the JAX package's ``MockPooledEncoder`` bit for bit."""

    dim: int

    def __call__(self, prompts: Sequence[str],
                 device: Optional[torch.device] = None) -> torch.Tensor:
        outs = []
        for p in prompts:
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[4:8], "little")
            outs.append(np.random.default_rng(seed).normal(0, 1.0, (self.dim,)))
        return torch.from_numpy(np.stack(outs).astype(np.float32)).to(device)


class FallbackHashTokenizer:
    """Stand-in for missing tokenizer files (``magcache_tpu.models.text.
    FallbackHashTokenizer``, the same ids bit for bit): each whitespace word
    hashes into ``[2, vocab_size)`` stepping over eos/pad, then eos, then pad
    up to ``max_length``. Deterministic, not a real tokenization; only for
    structural runs. Construction prints a warning for that reason."""

    def __init__(self, vocab_size: int, eos_token_id: int = 1, pad_token_id: int = 0):
        self.vocab_size, self.eos, self.pad = vocab_size, eos_token_id, pad_token_id
        print("WARNING: no tokenizer files found — falling back to a "
              "hash tokenizer (structural runs only; outputs are NOT "
              "prompt-faithful).")

    def __call__(self, texts, padding=None, truncation=None, max_length=77,
                 return_tensors=None) -> dict:
        """``{"input_ids": int64 [B, max_length], "attention_mask": int64
        [B, max_length]}`` as numpy arrays (``padding``, ``truncation`` and
        ``return_tensors`` are accepted for a tokenizer's call signature)."""
        # ids stay in the table even when eos is the last vocab id
        span = self.vocab_size - 2
        if span < 3:
            raise ValueError(f"vocab_size {self.vocab_size} too small")

        def wid(w):
            v = 2 + (int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                     % span)
            while v in (self.eos, self.pad):
                v = 2 + ((v - 1) % span)
            return v

        ids = np.full((len(texts), max_length), self.pad, np.int64)
        for i, t in enumerate(texts):
            toks = [wid(w) for w in t.split()][: max_length - 1]
            ids[i, :len(toks)] = toks
            ids[i, len(toks)] = self.eos
        return {"input_ids": ids, "attention_mask": (ids != self.pad).astype(np.int64)}
