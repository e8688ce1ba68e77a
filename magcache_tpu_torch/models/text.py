"""Text encoders. Only the checkpoint-free stand-ins are ported so far."""

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
