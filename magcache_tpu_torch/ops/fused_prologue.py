"""Fused prologue/epilogue ops: kernels K2, K3 (and its plain mode K3p), K7
and K8, each beside its plain version.

``rms_norm_rope`` (K2) and ``layer_norm_mod`` (K3, K3p) take a CUDA tensor to the
row-resident kernels of ``csrc/prologue.cu``; ``lnmod_matmul`` (K7) to the
same body's operand pass and the wgmma/TMA GEMM body
(``csrc/stdit3_kernels.cu``, ``csrc/hopper_gemm.cuh``; ``ops/gemm.py``) and
``matmul_gated_residual`` (K8) to the same GEMM body with its gate
epilogue (``csrc/stdit3_kernels.cu``; rows flattened where ``rows_out ==
S_in``, ``ops.gemm.gate_geometry``). A CPU tensor goes to the plain PyTorch version
(``<name>_plain``). A CUDA tensor the kernel does not take raises; nothing
falls back. Each wrapper counts its kernel launches in ``<wrapper>.launches``;
``rms_norm_rope`` also counts them by norm scope in ``.scope_launches``.

Under tensor parallelism K2 runs in two passes over a rank's slice of the
token-scope row: ``row_sumsq`` (the statistics pass, f32 sums of squares
``[B, S]``, all-reduced over tp by the caller) and ``rms_norm_rope(...,
row_sumsq=, width=)`` (the apply pass, which reads the total in place of its
own reduction and divides it by the whole row's width); the apply pass
counts in ``rms_norm_rope.tp_launches`` (and ``.launches``), not by scope.

Rounding points, as the TPU kernels have them:
- K2 rounds the normed, gain-multiplied value to the activation dtype before
  the f32 rotation (``rms_norm`` returns the input dtype, ``apply_rope``
  then rotates in f32);
- K3 ``mod`` rounds ln(x) to the activation dtype before the f32
  ``*(1 + scale) + shift``; ``affine`` applies ``*w + b`` in f32 and rounds
  once; ``plain`` (K3p, neither given) rounds ln(x) once;
- K7 rounds ``(x - mean) * rsqrt(var + eps)`` to the activation dtype, then
  the f32 ``*(1 + scale) + shift`` to the weight dtype (the GEMM operand);
  bias and gelu apply in f32 and the output rounds once;
- K8 rounds ``x @ w + bias`` to the activation dtype before the f32 gate,
  and the gated value again before the f32 residual add.

K7 and K8 take ``w`` as an ``nn.Linear`` weight, ``[d_out, d_in]`` (the JAX
functions take its transpose).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from magcache_tpu_torch.ops.build import (check_bf16, check_launch, count_launch,
                                          load_cuda_library)
from magcache_tpu_torch.ops.gemm import gate_geometry, gemm_launch
from magcache_tpu_torch.ops.norms import layer_norm, rms_norm
from magcache_tpu_torch.ops.rope import apply_rope

__all__ = ["rms_norm_rope", "rms_norm_rope_plain", "row_sumsq", "row_sumsq_plain",
           "layer_norm_mod",
           "layer_norm_mod_plain", "lnmod_matmul", "lnmod_matmul_plain",
           "ln_stats_plain", "lnmod_operand_plain",
           "matmul_gated_residual", "matmul_gated_residual_plain"]


def _require(cond: bool, msg) -> None:
    """Raises ``ValueError(msg)`` unless ``cond``; ``msg`` may be a callable
    that builds the message, so a launch-bound wrapper formats none on the
    path that passes."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def _f32_row(name: str, t: torch.Tensor, n: int, device) -> torch.Tensor:
    """An affine weight or bias as the kernel reads it: f32 ``[n]`` with a
    unit stride on ``device``; raises otherwise."""
    _require(t.device == device and t.dtype == torch.float32 and t.numel() == n,
             lambda: f"layer_norm_mod: {name} must be f32 [{n}] on {device}, got "
             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.reshape(n).contiguous()


def _sample_rows(name: str, t: torch.Tensor, b: int, n: int, device):
    """``(rows, row_stride)``: a modulation table ``[B, 1, n]`` or ``[B, n]``
    as ``B`` f32 rows of ``n`` with a unit inner stride, read in place where
    it is a view of a wider table (stride 0: one row for every sample)."""
    _require(t.device == device and t.dtype == torch.float32 and t.numel() == b * n,
             lambda: f"layer_norm_mod: {name} rows must be f32 [{b}, {n}] on {device}, got "
             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    rows = t.reshape(b, n)
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    return rows, rows.stride(0) if b > 1 else 0


NORM_SCOPES = ("token", "head")
ROPE_HEAD_DIM = 128          # the head dim K2's kernel takes
MAX_ROW_WIDTH = 5120         # the widest row K2, K3 and K7's operand pass hold


def row_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """Each row's f32 sum of squares: ``[B, S, W] -> [B, S]``."""
    x32 = x.float()
    return (x32 * x32).sum(-1)


def row_sumsq(x: torch.Tensor) -> torch.Tensor:
    """K2's tp statistics pass: the f32 sum of squares of each row of x
    (``[B, S, W]``, rows read in place through their batch and token
    strides, as K2 reads them), ``[B, S]`` f32. The kernel
    (``csrc/prologue.cu``, ``row_sumsq_kernel``) takes bf16 rows of a
    multiple of 8 values up to ``MAX_ROW_WIDTH``, each starting 16-byte
    aligned; launches count in ``row_sumsq.launches``."""
    if x.device.type == "cpu":
        return row_sumsq_plain(x)
    b, s, w = x.shape
    _check_k2_rows("row_sumsq", x, w)
    out = torch.empty((b, s), dtype=torch.float32, device=x.device)
    if out.numel():
        lib = load_cuda_library()
        code = lib.mc_row_sumsq(x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), b, s,
                                w, torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(lib, code, "row_sumsq")
        count_launch(row_sumsq)
    return out


row_sumsq.launches = 0


def _check_k2_rows(name: str, x: torch.Tensor, width: int) -> None:
    """Raises unless x is a bf16 CUDA ``[B, S, width]`` tensor or view whose
    rows K2's body reads in place: unit channel stride, rows of a multiple
    of 8 values up to ``MAX_ROW_WIDTH``, each starting 16-byte aligned."""
    b, s, _ = x.shape
    _require(x.is_cuda and x.dtype == torch.bfloat16 and x.stride(2) == 1
             and x.stride(1) >= width,
             lambda: f"{name}: x must be a bf16 CUDA tensor with unit channel "
             f"stride, got {x.dtype} strides {x.stride()} on {x.device}")
    _require(width % 8 == 0 and 0 < width <= MAX_ROW_WIDTH,
             lambda: f"{name}: the kernel takes rows of a multiple of 8 values, at most "
             f"{MAX_ROW_WIDTH}, got {width}")
    _require(x.data_ptr() % 16 == 0 and (b == 1 or x.stride(0) % 8 == 0)
             and (s == 1 or x.stride(1) % 8 == 0),
             lambda: f"{name}: every row of x must start 16-byte aligned, got "
             f"strides {x.stride()} at offset {x.storage_offset()}")


def rms_norm_rope_plain(x: torch.Tensor, gain: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor, heads: int, *, eps: float = 1e-5,
                        norm_scope: str = "token",
                        row_sumsq: Optional[torch.Tensor] = None,
                        width: Optional[int] = None) -> torch.Tensor:
    """``rms_norm`` over H*D (token scope) or over each head's D channels
    with a ``[D]`` or ``[H*D]`` gain (head scope), split heads,
    ``apply_rope``: ``[B, S, H*D] -> [B, S, H, D]``. With ``row_sumsq``
    (token scope: x is a tp rank's slice of wider rows) the mean square is
    ``row_sumsq / width``, the rows' f32 sums of squares over every rank's
    slice, in place of x's own."""
    b, s, hd = x.shape
    d = hd // heads
    if norm_scope == "token":
        yh = rms_norm(x, gain, eps=eps, row_sumsq=row_sumsq,
                      width=width).reshape(b, s, heads, d)
    else:
        g = gain if gain.numel() == d else gain.reshape(heads, d)
        yh = rms_norm(x.reshape(b, s, heads, d), g, eps=eps)
    return apply_rope(yh, cos, sin)


def rms_norm_rope(x: torch.Tensor, gain: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, heads: int, *, eps: float = 1e-5,
                  norm_scope: str = "token", row_sumsq: Optional[torch.Tensor] = None,
                  width: Optional[int] = None) -> torch.Tensor:
    """K2: RMSNorm + interleaved-pair RoPE in one pass, in token scope (over
    H*D, Wan) or head scope (per head over D, FLUX).

    x: ``[B, S, H*D]`` projection output, rows may be strided (a q or k
    column slice of a fused projection is read in place); gain: f32
    ``[H*D]``, or ``[D]`` shared by every head in head scope; cos/sin: f32
    ``[S, D/2]``. Returns a contiguous ``[B, S, H, D]`` in x's dtype. The
    kernel (``csrc/prologue.cu``) takes bf16, head dim 128, rows of at most
    ``MAX_ROW_WIDTH`` values each starting 16-byte aligned (strides and
    offset multiples of 8 values), and 16-byte aligned f32 tables.

    ``row_sumsq`` (f32 ``[B, S]``, contiguous) and ``width`` make it K2's
    tp apply pass (token scope only): x holds a tp rank's heads of rows
    ``width`` wide, and each row's sum of squares over every rank's slice
    (``row_sumsq`` of each slice, all-reduced) replaces x's own; the gain is
    the rank's ``[H*D]`` slice.
    """
    _require(norm_scope in NORM_SCOPES, lambda: f"rms_norm_rope: norm_scope must be "
             f"one of {NORM_SCOPES}, got {norm_scope!r}")
    b, s, hd = x.shape
    ext = row_sumsq is not None
    _require(not ext or (norm_scope == "token" and width is not None and width >= hd
                         and tuple(row_sumsq.shape) == (b, s)
                         and row_sumsq.dtype == torch.float32
                         and row_sumsq.device == x.device),
             lambda: f"rms_norm_rope: row_sumsq must be f32 [{b}, {s}] on {x.device} with "
             f"a width of at least {hd}, in token scope; got "
             f"{row_sumsq.dtype} {tuple(row_sumsq.shape)} on {row_sumsq.device}, width "
             f"{width}, scope {norm_scope!r}")
    if x.device.type == "cpu":
        return rms_norm_rope_plain(x, gain, cos, sin, heads, eps=eps,
                                   norm_scope=norm_scope, row_sumsq=row_sumsq, width=width)
    d = hd // heads
    _check_k2_rows("rms_norm_rope", x, hd)
    _require(hd == heads * d and d == ROPE_HEAD_DIM,
             lambda: f"rms_norm_rope: the kernel takes head dim {ROPE_HEAD_DIM}, got "
             f"{heads} heads over width {hd}")
    _require(not ext or row_sumsq.is_contiguous(),
             "rms_norm_rope: row_sumsq must be contiguous")
    shared_gain = norm_scope == "head" and gain.numel() == d
    for name, t, shape in (("gain", gain, (d,) if shared_gain else (hd,)),
                           ("cos", cos, (s, d // 2)), ("sin", sin, (s, d // 2))):
        _require(t.device == x.device and t.dtype == torch.float32
                 and t.is_contiguous() and tuple(t.shape) == shape
                 and t.data_ptr() % 16 == 0,
                 lambda: f"rms_norm_rope: {name} must be contiguous 16-byte aligned f32 "
                 f"{shape} on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((b, s, heads, d), dtype=x.dtype, device=x.device)
    if out.numel():
        lib = load_cuda_library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if ext:
            code = lib.mc_rms_norm_rope_ext(
                x.data_ptr(), x.stride(0), x.stride(1), gain.data_ptr(), cos.data_ptr(),
                sin.data_ptr(), row_sumsq.data_ptr(), int(width), out.data_ptr(), b, s, heads,
                float(eps), stream)
        else:
            code = lib.mc_rms_norm_rope(
                x.data_ptr(), x.stride(0), x.stride(1), gain.data_ptr(), int(shared_gain),
                cos.data_ptr(), sin.data_ptr(), out.data_ptr(), b, s, heads,
                int(norm_scope == "head"), float(eps), stream)
        check_launch(lib, code, "rms_norm_rope")
        count_launch(rms_norm_rope)
        if ext:
            count_launch(rms_norm_rope, "tp_launches")
        else:
            count_launch(rms_norm_rope, "scope_launches", norm_scope)
    return out


rms_norm_rope.launches = 0
rms_norm_rope.scope_launches = dict.fromkeys(NORM_SCOPES, 0)   # the same, by scope
rms_norm_rope.tp_launches = 0       # the tp apply pass (an external row statistic)


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
    ``[B, D]`` f32 rows) or affine LayerNorm (``weight``/``bias``, ``[D]``);
    with neither, K3p: the two-pass f32 LayerNorm alone, rounded once.

    x: ``[B, S, D]``; returns x's dtype. The kernel (``csrc/prologue.cu``)
    takes contiguous 16-byte aligned bf16 rows of a multiple of 8 values, at
    most ``MAX_ROW_WIDTH``; the scale/shift rows may be views of a wider
    table (a unit inner stride, any row stride). Launches count in ``layer_norm_mod.launches``, K3p's in
    ``layer_norm_mod.plain_launches``.
    """
    if scale is not None and weight is not None:
        raise ValueError(
            "layer_norm_mod: affine weight/bias and AdaLN scale/shift are "
            "separate modes; pass one pair, or neither for the plain LayerNorm")
    if x.device.type == "cpu":
        return layer_norm_mod_plain(x, weight=weight, bias=bias, scale=scale,
                                    shift=shift, eps=eps)
    b, s, hd = x.shape
    _require(x.is_cuda and x.is_contiguous() and x.dtype == torch.bfloat16
             and x.data_ptr() % 16 == 0,
             lambda: f"layer_norm_mod: x must be a contiguous 16-byte aligned bf16 CUDA "
             f"tensor, got {x.dtype} on {x.device}")
    _require(hd % 8 == 0 and 0 < hd <= MAX_ROW_WIDTH,
             lambda: f"layer_norm_mod: the kernel takes widths that are multiples of 8 "
             f"up to {MAX_ROW_WIDTH}, got {hd}")
    a = c = None
    sa = sc = 0
    if scale is not None:   # per-sample rows, often strided slices of the modulation table
        mode = 1
        (a, sa), (c, sc) = (_sample_rows("scale", scale, b, hd, x.device),
                            _sample_rows("shift", shift, b, hd, x.device))
    elif weight is not None:
        mode = 0
        a = _f32_row("weight", weight, hd, x.device)
        c = None if bias is None else _f32_row("bias", bias, hd, x.device)
    else:                   # K3p: the kernel reads neither row
        mode = 2
    out = torch.empty_like(x)
    if out.numel():
        lib = load_cuda_library()
        code = lib.mc_layer_norm_mod(
            x.data_ptr(), None if a is None else a.data_ptr(),
            None if c is None else c.data_ptr(), sa, sc, out.data_ptr(), b, s, hd, mode,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
        check_launch(lib, code, "layer_norm_mod")
        count_launch(layer_norm_mod, "plain_launches" if mode == 2 else "launches")
    return out


layer_norm_mod.launches = 0
layer_norm_mod.plain_launches = 0       # K3p


def _pad_rows(out: torch.Tensor, rows_out: int) -> torch.Tensor:
    """Zero rows appended on axis 1 up to ``rows_out``."""
    if rows_out == out.shape[1]:
        return out
    pad = out.new_zeros((out.shape[0], rows_out - out.shape[1], out.shape[2]))
    return torch.cat([out, pad], dim=1)


def _per_row(t: torch.Tensor, nb: int, width: int) -> torch.Tensor:
    """A modulation or gate table as contiguous f32 ``[nb, width]``."""
    return t.reshape(nb, width).float().contiguous()


def _f32_vector(t: Optional[torch.Tensor], n: int, like: torch.Tensor) -> torch.Tensor:
    """A bias as contiguous f32 ``[n]`` on ``like``'s device (zeros for None);
    raises when it lies elsewhere."""
    if t is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    _require(t.device == like.device and t.numel() == n,
             f"bias must hold [{n}] on {like.device}, got {tuple(t.shape)} on {t.device}")
    return t.reshape(n).float().contiguous()


def ln_stats_plain(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Each row's two-pass f32 LayerNorm statistics, ``[B*S, 2]`` f32 (the
    mean, then rsqrt of the mean of the squared centred values + eps)."""
    x32 = x.reshape(-1, x.shape[-1]).float()
    mean = x32.mean(-1)
    cent = x32 - mean[:, None]
    return torch.stack([mean, torch.rsqrt((cent * cent).mean(-1) + eps)], -1)


def lnmod_operand_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
                        eps: float = 1e-6, batch_repeat: int = 1,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K7's first stage in plain PyTorch, its GEMM operand: ``(x - mean) *
    rstd`` (``ln_stats_plain``) rounded to x's dtype, then ``* (1 + scale) +
    shift`` in f32 (row ``b // batch_repeat``) rounded to ``dtype`` (the
    weight's; default x's)."""
    b, s, d_in = x.shape
    nb = b // batch_repeat
    st = ln_stats_plain(x, eps).reshape(b, s, 2)
    y = ((x.float() - st[..., :1]) * st[..., 1:]).to(x.dtype).float()
    y = y.reshape(nb, batch_repeat, s, d_in)
    y = y * (1.0 + scale.reshape(nb, 1, 1, d_in).float()) \
        + shift.reshape(nb, 1, 1, d_in).float()
    return y.reshape(b, s, d_in).to(dtype or x.dtype)


def lnmod_matmul_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                       w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                       act: Optional[str] = None, eps: float = 1e-6,
                       rows_out: Optional[int] = None,
                       batch_repeat: int = 1) -> torch.Tensor:
    """K7's math in plain PyTorch (GEMM in f32 from the rounded operands)."""
    b, s, d_in = x.shape
    rows_out = s if rows_out is None else rows_out
    nb = b // batch_repeat
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    cent = x32 - mean
    var = (cent * cent).mean(-1, keepdim=True)
    y = (cent * torch.rsqrt(var + eps)).to(x.dtype).float()
    y = y.reshape(nb, batch_repeat, s, d_in)
    y = y * (1.0 + scale.reshape(nb, 1, 1, d_in).float()) \
        + shift.reshape(nb, 1, 1, d_in).float()
    y = y.reshape(b, s, d_in).to(w.dtype).float()
    out = y @ w.float().T
    if bias is not None:
        out = out + bias.float()
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    return _pad_rows(out.to(x.dtype), rows_out)


def lnmod_matmul(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 act: Optional[str] = None, eps: float = 1e-6,
                 rows_out: Optional[int] = None,
                 batch_repeat: int = 1) -> torch.Tensor:
    """K7: ``(layer_norm(x) * (1 + scale) + shift) @ w.T [+ bias] [-> gelu]``.

    x: ``[B, S, d_in]``; scale/shift: ``[B / batch_repeat, d_in]`` f32 AdaLN
    rows (x row b takes modulation row ``b // batch_repeat``); w:
    ``[d_out, d_in]``; bias ``[d_out]``. Returns ``[B, rows_out, d_out]`` in
    x's dtype; rows ``S..rows_out-1`` of each batch row are zeros. The
    kernels (the modulated operand in one pass over x, then the wgmma/TMA
    GEMM body) take contiguous bf16 and widths that are multiples of 8;
    the stages' plain versions are ``lnmod_operand_plain`` and
    ``ops.gemm.linear_plain``.
    """
    b, s, d_in = x.shape
    rows_out = s if rows_out is None else rows_out
    if act not in (None, "gelu"):
        raise ValueError(f"lnmod_matmul: act must be None or 'gelu', got {act!r}")
    if rows_out < s or batch_repeat < 1 or b % batch_repeat:
        raise ValueError(f"lnmod_matmul: rows_out {rows_out} < S {s}, or batch "
                         f"{b} not a multiple of batch_repeat {batch_repeat}")
    if x.device.type == "cpu":
        return lnmod_matmul_plain(x, scale, shift, w, bias, act=act, eps=eps,
                                  rows_out=rows_out, batch_repeat=batch_repeat)
    d_out = w.shape[0]
    nb = b // batch_repeat
    check_bf16("lnmod_matmul: x", x, (b, s, d_in), x.device)
    check_bf16("lnmod_matmul: w", w, (d_out, d_in), x.device)
    _require(d_in % 8 == 0 and d_out % 8 == 0 and d_in <= MAX_ROW_WIDTH,
             f"lnmod_matmul: widths {d_in} -> {d_out} must be multiples of 8, d_in "
             f"at most {MAX_ROW_WIDTH}")
    _require(scale.numel() == nb * d_in and shift.numel() == nb * d_in
             and scale.device == x.device and shift.device == x.device,
             f"lnmod_matmul: scale/shift must hold [{nb}, {d_in}] on {x.device}")
    a = (1.0 + _per_row(scale, nb, d_in)).contiguous()   # f32, as the plain form
    c = _per_row(shift, nb, d_in)
    bias32 = _f32_vector(bias, d_out, x)
    lib = load_cuda_library()
    y = torch.empty_like(x)
    code = lib.mc_ln_modulate(x.data_ptr(), a.data_ptr(), c.data_ptr(), y.data_ptr(), b, s,
                              d_in, batch_repeat, float(eps),
                              torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, "lnmod_matmul (modulate)")
    out = gemm_launch("lnmod_matmul", y, w, bias32,
                      epilogue="gelu" if act == "gelu" else "bias", rows_out=rows_out)
    count_launch(lnmod_matmul)
    return out


lnmod_matmul.launches = 0


def matmul_gated_residual_plain(x: torch.Tensor, w: torch.Tensor,
                                bias: Optional[torch.Tensor], gate: torch.Tensor,
                                resid: Optional[torch.Tensor] = None, *,
                                rows_out: Optional[int] = None,
                                batch_repeat: int = 1) -> torch.Tensor:
    """K8's math in plain PyTorch (GEMM in f32 from the rounded operands)."""
    b, s_in, _ = x.shape
    rows_out = s_in if rows_out is None else rows_out
    y = x[:, :rows_out] if rows_out < s_in else x
    out = y.float() @ w.float().T
    if bias is not None:
        out = out + bias.float()
    g = gate.reshape(b // batch_repeat, -1).float()
    g = g.repeat_interleave(batch_repeat, dim=0) if batch_repeat > 1 else g
    out = out.to(x.dtype).float() * g[:, None]
    if resid is not None:
        out = out.to(x.dtype).float() + resid[:, :out.shape[1]].float()
    return _pad_rows(out.to(x.dtype), rows_out)


def matmul_gated_residual(x: torch.Tensor, w: torch.Tensor,
                          bias: Optional[torch.Tensor], gate: torch.Tensor,
                          resid: Optional[torch.Tensor] = None, *,
                          rows_out: Optional[int] = None,
                          batch_repeat: int = 1) -> torch.Tensor:
    """K8: ``[resid +] gate * (x @ w.T + bias)``, the DiT block epilogue.

    x: ``[B, S_in, d_in]``; w: ``[d_out, d_in]``; gate: ``[B / batch_repeat,
    d_out]`` f32; resid: ``[B, rows_out, d_out]`` or None. Returns
    ``[B, rows_out, d_out]``: ``rows_out < S_in`` drops trailing rows,
    ``rows_out > S_in`` appends zero rows.

    The kernel (the wgmma/TMA GEMM body with the gate epilogue) takes
    contiguous bf16 x, w and resid and widths that are multiples of 8;
    anything else on a CUDA tensor raises. Its stages' plain form is
    ``ops.gemm.linear_plain`` with ``gate`` rows from
    ``ops.gemm.gate_row_index``.
    """
    b, s_in, d_in = x.shape
    rows_out = s_in if rows_out is None else rows_out
    if rows_out < 1 or batch_repeat < 1 or b % batch_repeat:
        raise ValueError(f"matmul_gated_residual: rows_out {rows_out} < 1, or "
                         f"batch {b} not a multiple of batch_repeat {batch_repeat}")
    if x.device.type == "cpu":
        return matmul_gated_residual_plain(x, w, bias, gate, resid,
                                           rows_out=rows_out,
                                           batch_repeat=batch_repeat)
    d_out = w.shape[0]
    nb = b // batch_repeat
    check_bf16("matmul_gated_residual: x", x, (b, s_in, d_in), x.device)
    check_bf16("matmul_gated_residual: w", w, (d_out, d_in), x.device)
    if resid is not None:
        check_bf16("matmul_gated_residual: resid", resid, (b, rows_out, d_out),
                    x.device)
    _require(d_in % 8 == 0 and d_out % 8 == 0,
             f"matmul_gated_residual: widths {d_in} -> {d_out} must be "
             f"multiples of 8")
    _require(gate.numel() == nb * d_out and gate.device == x.device,
             f"matmul_gated_residual: gate must hold [{nb}, {d_out}] on {x.device}")
    g = _per_row(gate, nb, d_out)
    bias32 = _f32_vector(bias, d_out, x)
    geom = gate_geometry(b, s_in, rows_out, batch_repeat)
    out = gemm_launch(
        "matmul_gated_residual", x.reshape(geom.batches, geom.rows, d_in), w, bias32,
        resid=resid.reshape(geom.batches, geom.rows_out, d_out) if resid is not None else None,
        rows_out=geom.rows_out, gate=g, rep=geom.rep, span=geom.span)
    count_launch(matmul_gated_residual)
    return out.reshape(b, rows_out, d_out)


matmul_gated_residual.launches = 0
