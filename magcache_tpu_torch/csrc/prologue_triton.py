"""K2 and K3: the attention-prologue kernels in Triton, one program per token.

This module imports ``triton`` at the top, so only the launching wrappers in
``ops/fused_prologue.py`` import it, and only for a CUDA tensor.

K2, ``rms_norm_rope_kernel``, replaces the TPU kernel
``magcache_tpu/ops/fused_prologue.py:rms_norm_rope`` (Pallas body
``_kernel``), token scope: RMSNorm over the whole H*D row with f32
statistics, gain multiply, round to the activation dtype, then the
interleaved-pair RoPE rotation in f32, written as ``[B, S, H, D]``.

K3, ``layer_norm_mod_kernel``, replaces ``magcache_tpu/ops/fused_prologue.py:
layer_norm_mod`` (Pallas body ``_ln_mod_kernel``): two-pass f32 LayerNorm,
then ``mod`` mode rounds ln(x) to the activation dtype and applies
``*(1 + scale) + shift`` with the sample's f32 rows, or ``affine`` mode
applies ``*w + b`` with no intermediate rounding.

What bounds them on the H100: each is one reduction over a 1536-wide row plus
an elementwise epilogue, about 2 flops per byte, so HBM bandwidth is the
limit (3.35 TB/s): at Wan-480p one call reads and writes 2 x 2 x 32,760 x
1536 bf16 values, 0.4 GB, about 0.12 ms at the bandwidth roofline.

What the design does about that: one program holds a whole row in registers,
so x is read from device memory once and the output written once; the
statistics, the rounding and the epilogue happen in registers, and the
small per-row tables (gain, cos/sin, the sample's modulation row) come from
L2. K2 reads even and odd channels as two strided loads over the same cache
lines, which gives each thread both halves of its RoPE pairs.
"""

import triton
import triton.language as tl


@triton.jit
def rms_norm_rope_kernel(x_ptr, g_ptr, cos_ptr, sin_ptr, o_ptr, S, eps,
                         HD: tl.constexpr, D: tl.constexpr,
                         BLOCK_P: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)         # token row over B*S
    pos = row % S
    j = tl.arange(0, BLOCK_P)                   # pair index within the row
    mask = j < HD // 2
    base = x_ptr + row * HD
    xe = tl.load(base + 2 * j, mask=mask, other=0.0).to(tl.float32)
    xo = tl.load(base + 2 * j + 1, mask=mask, other=0.0).to(tl.float32)
    var = (tl.sum(xe * xe, axis=0) + tl.sum(xo * xo, axis=0)) / HD
    r = 1.0 / tl.sqrt(var + eps)
    ge = tl.load(g_ptr + 2 * j, mask=mask, other=0.0)
    go = tl.load(g_ptr + 2 * j + 1, mask=mask, other=0.0)
    # round the normed value to the activation dtype before the f32 rotation
    ye = (xe * r * ge).to(o_ptr.dtype.element_ty).to(tl.float32)
    yo = (xo * r * go).to(o_ptr.dtype.element_ty).to(tl.float32)
    i = j % (D // 2)                            # pair index within the head
    c = tl.load(cos_ptr + pos * (D // 2) + i, mask=mask, other=0.0)
    s = tl.load(sin_ptr + pos * (D // 2) + i, mask=mask, other=0.0)
    out = o_ptr + row * HD
    tl.store(out + 2 * j, (ye * c - yo * s).to(o_ptr.dtype.element_ty), mask=mask)
    tl.store(out + 2 * j + 1, (ye * s + yo * c).to(o_ptr.dtype.element_ty), mask=mask)


@triton.jit
def layer_norm_mod_kernel(x_ptr, a_ptr, b_ptr, o_ptr, S, eps,
                          D: tl.constexpr, MOD: tl.constexpr,
                          BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)         # token row over B*S
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / D
    cent = tl.where(mask, x - mean, 0.0)
    var = tl.sum(cent * cent, axis=0) / D
    y = cent * (1.0 / tl.sqrt(var + eps))
    if MOD:
        # a/b are the sample's scale/shift rows [B, D]
        sample = row // S
        a = tl.load(a_ptr + sample * D + cols, mask=mask, other=0.0)
        b = tl.load(b_ptr + sample * D + cols, mask=mask, other=0.0)
        y = y.to(o_ptr.dtype.element_ty).to(tl.float32)
        y = y * (1.0 + a) + b
    else:
        # a/b are the affine weight/bias [D]
        a = tl.load(a_ptr + cols, mask=mask, other=0.0)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0)
        y = y * a + b
    tl.store(o_ptr + row * D + cols, y.to(o_ptr.dtype.element_ty), mask=mask)
