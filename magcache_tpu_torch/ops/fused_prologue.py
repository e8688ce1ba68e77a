"""Attention-prologue ops: kernels K2 and K3, each beside its plain version.

``rms_norm_rope`` (K2) and ``layer_norm_mod`` (K3) take a CUDA tensor to the
Triton kernels in ``csrc/prologue_triton.py`` and a CPU tensor to their plain
PyTorch versions, ``rms_norm_rope_plain`` and ``layer_norm_mod_plain``. A
CUDA tensor the kernel does not take raises; nothing falls back. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

Rounding points, as the TPU kernels have them:
- K2 rounds the normed, gain-multiplied value to the activation dtype before
  the f32 rotation (``rms_norm`` returns the input dtype, ``apply_rope``
  then rotates in f32);
- K3 ``mod`` rounds ln(x) to the activation dtype before the f32
  ``*(1 + scale) + shift``; ``affine`` applies ``*w + b`` in f32 and rounds
  once.
"""

from __future__ import annotations

from typing import Optional

import torch

from magcache_tpu_torch.ops.norms import layer_norm, rms_norm
from magcache_tpu_torch.ops.rope import apply_rope

__all__ = ["rms_norm_rope", "rms_norm_rope_plain", "layer_norm_mod",
           "layer_norm_mod_plain"]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def rms_norm_rope_plain(x: torch.Tensor, gain: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, heads: int, *,
                        eps: float = 1e-5) -> torch.Tensor:
    """``rms_norm(x, gain)`` over H*D, split heads, ``apply_rope``:
    ``[B, S, H*D] -> [B, S, H, D]``."""
    b, s, hd = x.shape
    yh = rms_norm(x, gain, eps=eps).reshape(b, s, heads, hd // heads)
    return apply_rope(yh, cos, sin)


def rms_norm_rope(x: torch.Tensor, gain: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, heads: int, *, eps: float = 1e-5,
                  norm_scope: str = "token") -> torch.Tensor:
    """K2: token-scope RMSNorm + interleaved-pair RoPE in one pass.

    x: ``[B, S, H*D]`` projection output; gain: f32 ``[H*D]``; cos/sin: f32
    ``[S, D/2]``. Returns ``[B, S, H, D]`` in x's dtype. Only the token
    scope (Wan) is ported; the head scope raises.
    """
    if norm_scope != "token":
        raise NotImplementedError("rms_norm_rope: head scope is not ported yet")
    if x.device.type == "cpu":
        return rms_norm_rope_plain(x, gain, cos, sin, heads, eps=eps)
    b, s, hd = x.shape
    d = hd // heads
    _require(x.is_cuda and x.is_contiguous() and x.dtype == torch.bfloat16,
             f"rms_norm_rope: x must be a contiguous bf16 CUDA tensor, got "
             f"{x.dtype} on {x.device}")
    _require(hd == heads * d and d % 2 == 0, f"rms_norm_rope: bad heads "
             f"{heads} for width {hd}")
    for name, t, shape in (("gain", gain, (hd,)), ("cos", cos, (s, d // 2)),
                           ("sin", sin, (s, d // 2))):
        _require(t.device == x.device and t.dtype == torch.float32
                 and t.is_contiguous() and tuple(t.shape) == shape,
                 f"rms_norm_rope: {name} must be contiguous f32 {shape} on "
                 f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    from magcache_tpu_torch.ops.build import triton_prologue

    out = torch.empty((b, s, heads, d), dtype=x.dtype, device=x.device)
    triton_prologue().rms_norm_rope_kernel[(b * s,)](
        x, gain, cos, sin, out, s, eps, HD=hd, D=d,
        BLOCK_P=_next_pow2(hd // 2), num_warps=4)
    rms_norm_rope.launches += 1
    return out


rms_norm_rope.launches = 0


def layer_norm_mod_plain(x: torch.Tensor, *, weight: Optional[torch.Tensor] = None,
                         bias: Optional[torch.Tensor] = None,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """``layer_norm(x, weight, bias)``, then ``*(1 + scale) + shift`` in f32
    when scale/shift are given."""
    y = layer_norm(x, weight, bias, eps=eps)
    if scale is not None:
        b, _, hd = x.shape
        y = y.float() * (1.0 + scale.reshape(b, 1, hd).float()) \
            + shift.reshape(b, 1, hd).float()
    return y.to(x.dtype)


def layer_norm_mod(x: torch.Tensor, *, weight: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   shift: Optional[torch.Tensor] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """K3: LayerNorm + AdaLN modulation (``scale``/``shift``, ``[B, 1, D]`` or
    ``[B, D]`` f32 rows) or affine LayerNorm (``weight``/``bias``, ``[D]``).

    x: ``[B, S, D]``; returns x's dtype. The affine-free ``plain`` mode is
    not ported yet and raises.
    """
    if (scale is None) == (weight is None):
        raise NotImplementedError(
            "layer_norm_mod: pass scale/shift (mod) or weight/bias (affine); "
            "the plain mode is not ported yet")
    if x.device.type == "cpu":
        return layer_norm_mod_plain(x, weight=weight, bias=bias, scale=scale,
                                    shift=shift, eps=eps)
    b, s, hd = x.shape
    _require(x.is_cuda and x.is_contiguous() and x.dtype == torch.bfloat16,
             f"layer_norm_mod: x must be a contiguous bf16 CUDA tensor, got "
             f"{x.dtype} on {x.device}")
    mod = scale is not None
    if mod:   # per-sample rows, often strided slices of the modulation table
        a = scale.reshape(b, hd).contiguous()
        c = shift.reshape(b, hd).contiguous()
        shape = (b, hd)
    else:
        a = weight.contiguous()
        c = bias.contiguous() if bias is not None else torch.zeros_like(a)
        shape = (hd,)
    for name, t in (("a", a), ("b", c)):
        _require(t.device == x.device and t.dtype == torch.float32
                 and tuple(t.shape) == shape,
                 f"layer_norm_mod: {name} row must be f32 {shape} on "
                 f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    from magcache_tpu_torch.ops.build import triton_prologue

    out = torch.empty_like(x)
    triton_prologue().layer_norm_mod_kernel[(b * s,)](
        x, a, c, out, s, eps, D=hd, MOD=mod, BLOCK=_next_pow2(hd),
        num_warps=4)
    layer_norm_mod.launches += 1
    return out


layer_norm_mod.launches = 0
