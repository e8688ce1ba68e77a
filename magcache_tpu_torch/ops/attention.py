"""Attention for DiT trunks: kernel K1 beside its plain version, and the
``attention()`` dispatcher.

Layout at the API boundary is ``[batch, seq, heads, head_dim]``, as the
patch-embedded activations are. ``flash_attention_bshd`` (K1) takes a CUDA
tensor to the hand-written kernel in ``csrc/flash_attention.cu`` and a CPU
tensor to ``flash_attention_bshd_plain``; a CUDA tensor the kernel does not
take (another dtype, a head dim other than 128) raises. The launch count is
``flash_attention_bshd.launches``.

Wan runs cross-attention over the full zero-padded 512-token context without
masking; ``kv_len`` masks trailing keys for callers that do mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from magcache_tpu_torch.ops.build import load_cuda_library

__all__ = ["attention", "flash_attention_bshd", "flash_attention_bshd_plain",
           "QKNORM_FIXED_MAX"]

_LOG2E = math.log2(math.e)
_NEG_INF = -1e30

# Static softmax shift for RMS-qk-normed trunks: their base-2 scores stay far
# inside exp2's +-126 headroom around it. Models with qk-norm pass it as
# ``fixed_max``.
QKNORM_FIXED_MAX = 16.0

KERNEL_HEAD_DIM = 128


def _q_scale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale * log2(e) rounded to the activation dtype, as the kernel uses it."""
    return torch.tensor(scale * _LOG2E, dtype=dtype)


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, scale: Optional[float] = None,
                               kv_len: Optional[int] = None,
                               fixed_max: Optional[float] = None,
                               chunk: int = 256) -> torch.Tensor:
    """K1's math in plain PyTorch, over query-row chunks of ``chunk`` rows
    so that ``[Sq, Skv]`` scores never exist whole.

    q is pre-scaled by ``scale*log2(e)`` in the activation dtype, scores are
    f32, the base-2 softmax uses the static shift ``fixed_max`` (or the row
    max when None), p is rounded to v's dtype before the f32 PV product, and
    the result is divided by the f32 row sum.
    """
    b, sq, h, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kv_len = k.shape[1] if kv_len is None else min(kv_len, k.shape[1])
    qs = q * _q_scale(scale, q.dtype).to(q.device)
    kt = k[:, :kv_len].permute(0, 2, 3, 1).float()       # [B, H, D, Skv]
    vt = v[:, :kv_len].permute(0, 2, 1, 3)               # [B, H, Skv, D]
    vf = vt.float()
    out = torch.empty_like(q)
    for i0 in range(0, sq, chunk):
        s = qs[:, i0:i0 + chunk].permute(0, 2, 1, 3).float() @ kt
        if fixed_max is not None:
            p = torch.exp2(torch.clamp(s, max=fixed_max + 126.0) - fixed_max)
        else:
            p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = (p.to(v.dtype).float() @ vf) / p.sum(-1, keepdim=True)
        out[:, i0:i0 + chunk] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         fixed_max: Optional[float] = None) -> torch.Tensor:
    """K1: full non-causal attention on ``[B, S, H, D]`` -> ``[B, Sq, H, D]``.

    ``fixed_max``: the static softmax shift (pass only for trunks whose scores
    are norm-bounded); None runs the online running-max softmax.
    """
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, scale=scale, kv_len=kv_len,
                                          fixed_max=fixed_max)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kv_len = skv if kv_len is None else min(kv_len, skv)
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention_bshd: the kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    for name, t, shape in (("q", q, (b, sq, h, d)), ("k", k, (b, skv, h, d)),
                           ("v", v, (b, skv, h, d))):
        if not (t.is_cuda and t.device == q.device and t.dtype == torch.bfloat16
                and t.is_contiguous() and tuple(t.shape) == shape
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"flash_attention_bshd: {name} must be a contiguous 16-byte "
                f"aligned bf16 CUDA tensor of shape {shape}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if kv_len < 1 or b * h > 65535:
        raise ValueError(f"flash_attention_bshd: kv_len {kv_len} < 1 or "
                         f"B*H {b * h} > 65535")
    lib = load_cuda_library()
    out = torch.empty_like(q)
    code = lib.mc_flash_attention_bshd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, kv_len, float(_q_scale(scale, q.dtype)),
        int(fixed_max is not None),
        float(fixed_max) if fixed_max is not None else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"flash_attention_bshd launch failed: "
                           f"{lib.mc_error_string(code).decode()} ({code})")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0


def _attention_einsum(q, k, v, *, scale, kv_len):
    """Layout-native einsum attention for tiny sequences: f32 scores and
    softmax, p rounded to v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        key_pos = torch.arange(k.shape[1], device=k.device)
        s = torch.where(key_pos < kv_len, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None, kv_len: Optional[int] = None,
              fixed_max: Optional[float] = None) -> torch.Tensor:
    """Full attention over ``[B, S, H, D]`` activations.

    Routed on shape only: when ``max(Sq, Skv) <= 128`` the einsum path runs
    (no flash tiling pays off there), otherwise K1.
    """
    if max(q.shape[1], k.shape[1]) <= 128:
        d = q.shape[-1]
        return _attention_einsum(
            q, k, v, scale=(1.0 / math.sqrt(d)) if scale is None else scale,
            kv_len=kv_len)
    return flash_attention_bshd(q, k, v, scale=scale, kv_len=kv_len,
                                fixed_max=fixed_max)
