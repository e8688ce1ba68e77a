"""K2, K3 and K3p: the attention-prologue kernels in Triton, one program per
token.

This module imports ``triton`` at the top, so only the launching wrappers in
``ops/fused_prologue.py`` import it, and only for a CUDA tensor.

K2, ``rms_norm_rope_kernel``, replaces the TPU kernel
``magcache_tpu/ops/fused_prologue.py:rms_norm_rope`` (Pallas body
``_kernel``) in both of its scopes: RMSNorm with f32 statistics over the
whole H*D row (token scope, Wan) or over each head's D channels (head scope,
FLUX), gain multiply, round to the activation dtype, then the
interleaved-pair RoPE rotation in f32, written as ``[B, S, H, D]``. The row
is read through its batch and token strides, so a q or k column slice of a
fused projection (FLUX's ``[B, S, 3*H*D (+ mlp)]``) is read in place.

K3, ``layer_norm_mod_kernel``, replaces ``magcache_tpu/ops/fused_prologue.py:
layer_norm_mod`` (Pallas body ``_ln_mod_kernel``): two-pass f32 LayerNorm,
then ``mod`` mode rounds ln(x) to the activation dtype and applies
``*(1 + scale) + shift`` with the sample's f32 rows, or ``affine`` mode
applies ``*w + b`` with no intermediate rounding. K3p is the TPU kernel's ``plain``
mode (``MODE == 2``): ln(x) alone, rounded once at the store.

What bounds them on the H100: each is one reduction over a 1536- to
3072-wide row plus an elementwise epilogue, about 2 flops per byte, so HBM
bandwidth is the limit (3.35 TB/s): at Wan-480p one call reads and writes
2 x 2 x 32,760 x 1536 bf16 values, 0.4 GB, about 0.12 ms at the bandwidth
roofline; a FLUX image-token q slice (4,096 x 3072) is 50 MB, 15 us.

What the design does about that: one program holds a whole row in registers,
so x is read from device memory once and the output written once; the
statistics, the rounding and the epilogue happen in registers, and the
small per-row tables (gain, cos/sin, the sample's modulation row) come from
L2. K2 loads the row as a contiguous ``[H, D]`` tile (coalesced vector
loads), splits each head's channels into RoPE pairs in registers
(``reshape`` to ``[H, D/2, 2]``, ``split``) and interleaves the rotated
pairs back for one contiguous store; the head scope reduces over axis 1,
the token scope over both axes. Loading even and odd channels as two
stride-2 ``[H, D/2]`` tiles instead ran 4-10x slower on the H100: those
loads were not coalesced.
"""

import triton
import triton.language as tl


@triton.jit
def rms_norm_rope_kernel(x_ptr, g_ptr, cos_ptr, sin_ptr, o_ptr, S, stride_b,
                         stride_s, g_hstride, eps, H: tl.constexpr,
                         D: tl.constexpr, BLOCK_H: tl.constexpr,
                         HEAD_SCOPE: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)         # token row over B*S
    pos = row % S
    h = tl.arange(0, BLOCK_H)[:, None]          # head
    k = tl.arange(0, D)[None, :]                # channel within the head
    mask = (h < H) & (k < D)
    base = x_ptr + (row // S) * stride_b + pos * stride_s
    x = tl.load(base + h * D + k, mask=mask, other=0.0).to(tl.float32)
    sq = x * x
    if HEAD_SCOPE:
        var = tl.sum(sq, axis=1)[:, None] / D   # per-head RMS over D
    else:
        var = tl.sum(tl.sum(sq, axis=1), axis=0) / (H * D)
    r = 1.0 / tl.sqrt(var + eps)
    # gain: [H*D] (g_hstride = D) or one [D] row for every head (0)
    g = tl.load(g_ptr + h * g_hstride + k, mask=mask, other=0.0)
    # round the normed value to the activation dtype before the f32 rotation
    y = (x * r * g).to(o_ptr.dtype.element_ty).to(tl.float32)
    ye, yo = tl.split(tl.reshape(y, (BLOCK_H, D // 2, 2)))   # RoPE pairs
    i = tl.arange(0, D // 2)[None, :]
    c = tl.load(cos_ptr + pos * (D // 2) + i)
    s = tl.load(sin_ptr + pos * (D // 2) + i)
    out = tl.interleave(ye * c - yo * s, ye * s + yo * c)
    tl.store(o_ptr + row * (H * D) + h * D + k, out.to(o_ptr.dtype.element_ty),
             mask=mask)


@triton.jit
def layer_norm_mod_kernel(x_ptr, a_ptr, b_ptr, o_ptr, S, eps,
                          D: tl.constexpr, MODE: tl.constexpr,
                          BLOCK: tl.constexpr):
    # MODE 0: affine (a/b = weight/bias), 1: mod (a/b = scale/shift rows),
    # 2: plain (a/b unread)
    row = tl.program_id(0).to(tl.int64)         # token row over B*S
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    cent = tl.where(mask, x - mean, 0.0)
    var = tl.sum(cent * cent, axis=0) / D
    y = cent * (1.0 / tl.sqrt(var + eps))
    if MODE == 1:
        # a/b are the sample's scale/shift rows [B, D]
        sample = row // S
        a = tl.load(a_ptr + sample * D + cols, mask=mask, other=0.0)
        b = tl.load(b_ptr + sample * D + cols, mask=mask, other=0.0)
        y = y.to(o_ptr.dtype.element_ty).to(tl.float32)
        y = y * (1.0 + a) + b
    elif MODE == 0:
        # a/b are the affine weight/bias [D]
        a = tl.load(a_ptr + cols, mask=mask, other=0.0)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0)
        y = y * a + b
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)
