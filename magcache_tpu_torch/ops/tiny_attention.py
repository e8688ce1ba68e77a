"""Tiny-sequence attention over the fused qkv projection: temporal attention
in spatial-temporal DiTs (attention over T <= 32 frames at each of many
spatial locations), with optional per-head RMS qk-norm and RoPE.

``tiny_temporal_attention(qkv, q_gain, k_gain, cos, sin, heads, mode=...)``
is ``magcache_tpu.ops.tiny_attention.tiny_temporal_attention`` with its
routes as an explicit argument (the JAX package reads them from
``MAGCACHE_TINY_ATTN``):

- ``mode="grouped"`` (``_grouped``): norm and RoPE as plain ops, q and k
  rounded to the activation dtype, then K4 (``ops.attention.
  grouped_flash_attention_bshd``) with groups of T and the row-max softmax.
  The TPU's power-of-two group padding and 128-lane head padding are not
  carried over: masked keys contribute nothing, so ``group=T`` is the same.
- ``mode="vpu"``: K9 (``csrc/tiny_attention.cu``), the fused f32 kernel: q
  and k normed with the gains folded in, rotated, q times ``scale*log2(e)``,
  f32 scores and row-max base-2 softmax, p not rounded, an f32 accumulator
  over ``p*v``, one rounding at the store. ``tiny_temporal_attention_plain``
  is its plain version.

Either mode routes by shape as the JAX function does: T > 32 or an odd head
dim takes ``_reference``, the unfused composition over ``ops.attention.
attention``. (The JAX package's ``H*D % 128`` rule is a TPU lane constraint
and is not carried over.) K9 takes bf16 with a head dim that is a multiple
of 8 up to 128; anything else on a CUDA tensor raises. K9's launches count
in ``tiny_temporal_attention.launches``, K4's in
``grouped_flash_attention_bshd.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from magcache_tpu_torch.ops.attention import (attention, grouped_flash_attention_bshd,
                                              split_qkv)
from magcache_tpu_torch.ops.build import check_bf16, check_launch, load_cuda_library
from magcache_tpu_torch.ops.norms import rms_norm
from magcache_tpu_torch.ops.rope import apply_rope

__all__ = ["tiny_temporal_attention", "tiny_temporal_attention_plain", "MODES"]

MODES = ("grouped", "vpu")
MAX_FRAMES = 32                 # T above this takes the unfused composition
_LOG2E = math.log2(math.e)


def _norm_rope(q, k, q_gain, k_gain, cos, sin, eps):
    """``rms_norm`` and ``apply_rope`` as plain ops, each rounding to the
    activation dtype (JAX ``_reference``/``_grouped``)."""
    if q_gain is not None:
        q, k = rms_norm(q, q_gain, eps=eps), rms_norm(k, k_gain, eps=eps)
    if cos is not None:
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k


def _reference(qkv, q_gain, k_gain, cos, sin, heads, *, eps, scale):
    """The unfused composition: norm, RoPE, then ``attention()``."""
    r, t_len, three_hd = qkv.shape
    q, k, v = split_qkv(qkv, heads)
    q, k = _norm_rope(q, k, q_gain, k_gain, cos, sin, eps)
    return attention(q, k, v, scale=scale).reshape(r, t_len, three_hd // 3)


def _grouped(qkv, q_gain, k_gain, cos, sin, heads, *, eps, scale):
    """Norm and RoPE as plain ops, q and k rounded to the activation dtype,
    then K4 over groups of T (all keys valid, row-max softmax)."""
    r, t_len, three_hd = qkv.shape
    q, k, v = split_qkv(qkv, heads)
    q, k = _norm_rope(q, k, q_gain, k_gain, cos, sin, eps)
    q, k = q.to(v.dtype), k.to(v.dtype)
    flat = [t.reshape(1, r * t_len, heads, t.shape[-1]) for t in (q, k, v)]
    out = grouped_flash_attention_bshd(*flat, group=t_len, scale=scale)
    return out.reshape(r, t_len, three_hd // 3)


def tiny_temporal_attention_plain(
        qkv: torch.Tensor, q_gain: Optional[torch.Tensor],
        k_gain: Optional[torch.Tensor], cos: Optional[torch.Tensor],
        sin: Optional[torch.Tensor], heads: int, *, eps: float = 1e-6,
        scale: Optional[float] = None, chunk_rows: int = 4096) -> torch.Tensor:
    """K9's math in plain PyTorch, over chunks of ``chunk_rows`` rows:
    everything in f32 and rounded once at the end."""
    r, t_len, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    out = torch.empty((r, t_len, hd), dtype=qkv.dtype, device=qkv.device)
    for r0 in range(0, r, chunk_rows):
        q, k, v = (t.float() for t in split_qkv(qkv[r0:r0 + chunk_rows], heads))
        if q_gain is not None:   # x * (rsqrt(mean(x^2) + eps) * gain)
            q = q * (torch.rsqrt((q * q).mean(-1, keepdim=True) + eps) * q_gain.float())
            k = k * (torch.rsqrt((k * k).mean(-1, keepdim=True) + eps) * k_gain.float())
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        q = q * (scale * _LOG2E)
        s = torch.einsum("rthd,rshd->rhts", q, k)
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        acc = torch.einsum("rhts,rshd->rthd", p, v)
        out[r0:r0 + chunk_rows] = (acc * (1.0 / p.sum(-1)).permute(0, 2, 1)[..., None]
                                   ).reshape(-1, t_len, hd).to(qkv.dtype)
    return out


def _vpu(qkv, q_gain, k_gain, cos, sin, heads, *, eps, scale):
    """K9's launch: checks what the kernel takes, raises on anything else."""
    r, t_len, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    dev = qkv.device
    if d % 8 or d > 128 or heads > 65535:
        raise ValueError(f"tiny_temporal_attention: the kernel takes head dims "
                         f"that are multiples of 8 up to 128 (and at most 65,535 "
                         f"heads), got {heads} x {d}")
    check_bf16("tiny_temporal_attention: qkv", qkv, (r, t_len, three_hd), dev)
    gains = [None, None]
    if q_gain is not None:
        for i, (label, t) in enumerate((("q_gain", q_gain), ("k_gain", k_gain))):
            if t.device != dev or t.numel() not in (d, heads * d):
                raise ValueError(f"tiny_temporal_attention: {label} must hold "
                                 f"[{heads}, {d}] or [{d}] on {dev}")
            gains[i] = t.float().reshape(-1, d).expand(heads, d).contiguous()
    tabs = [None, None]
    if cos is not None:
        tabs = [t.float().contiguous() for t in (cos, sin)]
        for t in tabs:
            if t.device != dev or tuple(t.shape) != (t_len, d // 2):
                raise ValueError(f"tiny_temporal_attention: rope tables must be "
                                 f"[{t_len}, {d // 2}] on {dev}")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = load_cuda_library()
    out = torch.empty((r, t_len, hd), dtype=qkv.dtype, device=dev)
    code = lib.mc_tiny_attention(
        qkv.data_ptr(), out.data_ptr(), ptr(gains[0]), ptr(gains[1]), ptr(tabs[0]),
        ptr(tabs[1]), r, t_len, heads, d, scale * _LOG2E, float(eps),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "tiny_temporal_attention")
    tiny_temporal_attention.launches += 1
    return out


def tiny_temporal_attention(
        qkv: torch.Tensor, q_gain: Optional[torch.Tensor],
        k_gain: Optional[torch.Tensor], cos: Optional[torch.Tensor],
        sin: Optional[torch.Tensor], heads: int, *, eps: float = 1e-6,
        scale: Optional[float] = None, mode: str = "grouped") -> torch.Tensor:
    """Attention over ``qkv [R, T, 3*H*D]`` within each row's T tokens,
    head by head. ``q_gain``/``k_gain``: per-head RMS gains ``[D]`` (or
    ``[H, D]``; None skips the norm); ``cos``/``sin``: interleaved-pair
    tables ``[T, D/2]`` (None skips RoPE). ``mode``: "grouped" (K4) or
    "vpu" (K9), see the module docstring. Returns ``[R, T, H*D]``."""
    if mode not in MODES:
        raise ValueError(f"tiny_temporal_attention: mode must be one of {MODES}, "
                         f"got {mode!r}")
    r, t_len, three_hd = qkv.shape
    d = three_hd // 3 // heads
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kw = dict(eps=eps, scale=scale)
    if t_len > MAX_FRAMES or d % 2:
        return _reference(qkv, q_gain, k_gain, cos, sin, heads, **kw)
    if mode == "grouped":
        return _grouped(qkv, q_gain, k_gain, cos, sin, heads, **kw)
    if qkv.device.type == "cpu":
        return tiny_temporal_attention_plain(qkv, q_gain, k_gain, cos, sin, heads, **kw)
    return _vpu(qkv, q_gain, k_gain, cos, sin, heads, **kw)


tiny_temporal_attention.launches = 0
