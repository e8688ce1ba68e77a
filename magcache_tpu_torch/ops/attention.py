"""Attention for DiT trunks: kernels K1, K1b, K1c, K4, K5 and K6 beside their
plain versions, and the ``attention()`` dispatcher.

Layout at the API boundary is ``[batch, seq, heads, head_dim]``, as the
patch-embedded activations are. Each kernel wrapper takes a CUDA tensor to
its hand-written kernel and a CPU tensor to ``<name>_plain``; a CUDA tensor
the kernel does not take raises. Launch counts are ``<wrapper>.launches``
(K1q's: ``flash_attention_bshd.qknorm_launches``; K5r's:
``grouped_attention_fused_qkv.rowmax_launches``).

- ``flash_attention_bshd`` (K1, ``csrc/flash_attention.cu`` on the
  warp-specialised wgmma/TMA body of ``csrc/hopper_attention.cuh``): full
  attention, head dim 128; with ``qk_gains`` (K1q, STDiT3's frames of more
  than 2,048 tokens) the per-head RMS qk-norm at head dim 72: a pre-pass
  reads the q and k views once and writes normed contiguous copies, then the
  same body at head dim 72 carried as 80 reads them and v in place.
- ``flash_attention_bhsd`` (K1b, the same kernel body): the same attention
  on ``[B, H, S, D]``, read through (batch, head, token) strides, so a
  ``[B, S, H, D]`` tensor viewed as ``[B, H, S, D]`` costs no copy; each
  rank's full-sequence attention under Ulysses sequence parallelism, and
  cross-attention under any plan.
- ``flash_attention_bhsd_aux`` (K1c, the same body): the running-max softmax
  that also returns each row's max ``m`` and sum ``l``; one step of ring
  attention.
- ``grouped_attention_fused_qkv`` (K5, ``csrc/grouped_attention.cu``):
  block-diagonal grouped attention read from the fused ``[B, S, 3*H*D]``
  projection with the per-head RMS qk-norm and optional in-group RoPE;
  head dim 72 (STDiT3's spatial and temporal attention). Without gains and
  with the row-max softmax it is K5r (Latte's packed attention). Three
  routes (``grouped_kernel``): groups of up to 16 tokens stream through
  ``grouped_stream_kernel`` (one fused pass, bound by its bytes); larger
  groups run the wgmma/TMA body at head dim 80, on the q/k/v views ("tma",
  the row max without gains or RoPE) or after the norm pre-pass
  ("prepass": K1q's ``qk_norm_kernel`` with RoPE at ``token % group``).
- ``grouped_flash_attention_bshd`` (K4, the same kernels): the same on
  separate ``[B, S, H, D]`` q, k and v read through their strides (the
  "grouped" mode of ``ops.tiny_attention``).
- ``fused_cross_attention`` (K6, ``csrc/stdit3_kernels.cu``): q-projection,
  attention over a short context and out-projection (+ residual) as three
  launches: the projections on the wgmma/TMA GEMM body (``ops/gemm.py``),
  the attention on ``hopper_cross_kernel`` (the row max with K and V
  resident); head dim 72, at most 512 keys.

K5 and K6 keep the published 72-wide heads; the TPU package pads them to 128
lanes, which the port does not carry over.

Wan runs cross-attention over the full zero-padded 512-token context without
masking; ``kv_len`` masks trailing keys for callers that do mask.

The wgmma/TMA body reads q, k and v through TMA tensor maps. Their geometry
(extents, byte strides, boxes, swizzle) is computed in plain Python
(``ops.build.tma_map``; here ``flash_tma_maps``, ``grouped_tma_maps``,
``cross_tma_maps``) and handed to the C side, which only encodes it
(``cuTensorMapEncodeTiled``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from magcache_tpu_torch.ops.build import (check_bf16, check_launch, count_launch,
                                          load_cuda_library, map_words, tma_map)
from magcache_tpu_torch.ops.gemm import gemm_launch
from magcache_tpu_torch.ops.rope import apply_rope

__all__ = ["attention", "flash_attention_bshd", "flash_attention_bshd_plain",
           "flash_attention_bhsd", "flash_attention_bhsd_plain",
           "flash_attention_bhsd_aux", "flash_attention_bhsd_aux_plain",
           "grouped_attention_fused_qkv", "grouped_attention_fused_qkv_plain",
           "grouped_flash_attention_bshd", "grouped_flash_attention_bshd_plain",
           "fused_cross_attention", "fused_cross_attention_plain",
           "cross_attention_rowmax_plain", "qk_norm_plain",
           "flash_attention_prescaled_plain", "grouped_attention_prescaled_plain",
           "QKNORM_FIXED_MAX"]

_LOG2E = math.log2(math.e)
_NEG_INF = -1e30

# Static softmax shift for RMS-qk-normed trunks: their base-2 scores stay far
# inside exp2's +-126 headroom around it. Models with qk-norm pass it as
# ``fixed_max``.
QKNORM_FIXED_MAX = 16.0

KERNEL_HEAD_DIM = 128
GROUPED_HEAD_DIM = 72        # K5's and K6's head dim
CROSS_MAX_KEYS = 512         # K6 keeps a (batch, head)'s K and V resident: 4 tiles
SMEM_LIMIT = 232448          # dynamic shared memory an H100 block may use
TMA_BOX_ROWS = 128           # the wgmma/TMA body's query and key tiles
TMA_PADDED_DIM = 80          # head dim 72 as the body carries it: boxes of 64 + 16


def flash_tma_maps(name: str, q, k, v, kv_len: int) -> list:
    """The six maps of K1/K1b/K1c/K1q (q, k, v x two column boxes) over
    ``[B, H, S, D]`` tensors or views: dimensions (channel, token, head,
    batch), token extent Sq for q and ``kv_len`` for k and v (rows past it
    arrive as zeros), boxes of 128 tokens. Head dim 128: two 64-wide boxes
    (128-byte swizzle). Head dim 72 (K1q): a 64-wide box and a 16-wide one
    (32-byte swizzle) over columns 64..79, whose columns 72..79 lie past the
    channel extent and arrive as zeros."""
    maps = []
    for label, t, rows in (("q", q, q.shape[2]), ("k", k, kv_len), ("v", v, kv_len)):
        b, h, _, d = t.shape
        sb, sh, st, sd = t.stride()
        second = (64, 128) if d == KERNEL_HEAD_DIM else (TMA_PADDED_DIM - 64, 32)
        for width, swizzle in ((64, 128), second):   # the second box at column 64
            maps.append(tma_map(f"{name}: {label}", (d, rows, h, b), (sd, st, sh, sb),
                                (width, TMA_BOX_ROWS, 1, 1), swizzle))
    return maps


def grouped_tma_maps(name: str, q, k, v, group: int, group_valid: int) -> list:
    """The six maps of the row-max grouped body over ``[B, S, H, 72]``
    tensors or views (K5r's column views of one projection, K4's tensors):
    dimensions (channel, head, in-group position, group, batch), position
    extent ``group`` for q and ``group_valid`` for k and v, boxes of 128
    positions of one head; per tensor a 64-wide box (128-byte swizzle) and a
    16-wide one over columns 64..79 (32-byte swizzle), whose columns 72..79
    lie past the channel extent and arrive as zeros."""
    maps = []
    for label, t, rows in (("q", q, group), ("k", k, group_valid), ("v", v, group_valid)):
        b, s_len, h, d = t.shape
        bs, ts, hs, cs = t.stride()
        sizes = (d, h, rows, s_len // group, b)
        strides = (cs, hs, ts, ts * group, bs)
        for width, swizzle in ((64, 128), (TMA_PADDED_DIM - 64, 32)):
            maps.append(tma_map(f"{name}: {label}", sizes, strides,
                                (width, 1, TMA_BOX_ROWS, 1, 1), swizzle))
    return maps


def cross_tma_maps(name: str, q, k, v, kv_valid: int) -> list:
    """The six maps of K6's attention stage over ``[B, S, H, 72]`` views of
    contiguous ``[B, S, H*72]`` tensors: dimensions (channel, head, token,
    batch), token extent Sq for q and ``kv_valid`` for k and v (keys past
    it arrive as zeros), boxes of 128 tokens of one head; per tensor a
    64-wide box (128-byte swizzle) and a 16-wide one (32-byte), columns
    72..79 past the channel extent zero-filled, as ``grouped_tma_maps``."""
    maps = []
    for label, t, rows in (("q", q, q.shape[1]), ("k", k, kv_valid), ("v", v, kv_valid)):
        b, _, h, d = t.shape
        bs, ts, hs, cs = t.stride()
        for width, swizzle in ((64, 128), (TMA_PADDED_DIM - 64, 32)):
            maps.append(tma_map(f"{name}: {label}", (d, h, rows, b), (cs, hs, ts, bs),
                                (width, 1, TMA_BOX_ROWS, 1), swizzle))
    return maps


def _q_scale(scale: float, dtype: torch.dtype) -> torch.Tensor:
    """scale * log2(e) rounded to the activation dtype, as the kernel uses it."""
    return torch.tensor(scale * _LOG2E, dtype=dtype)


def _rms_head(t: torch.Tensor, gain: torch.Tensor, true_d: int,
              eps: float) -> torch.Tensor:
    """Per-head RMS norm in f32 over the last dim (variance = sum of squares
    / ``true_d``) times the f32 gain (``[H, D]`` or ``[D]``)."""
    t32 = t.float()
    var = (t32 * t32).sum(-1, keepdim=True) * (1.0 / true_d)
    return t32 * torch.rsqrt(var + eps) * gain.float().reshape(-1, t.shape[-1])


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, scale: Optional[float] = None,
                               kv_len: Optional[int] = None,
                               fixed_max: Optional[float] = None,
                               qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                               true_d: Optional[int] = None, eps: float = 1e-6,
                               chunk: int = 256) -> torch.Tensor:
    """K1's (and K1q's) math in plain PyTorch, over query-row chunks of
    ``chunk`` rows so that ``[Sq, Skv]`` scores never exist whole.

    Without ``qk_gains``, q is pre-scaled by ``scale*log2(e)`` in the
    activation dtype. With ``qk_gains=(qg, kg)``, q and k are RMS-normed per
    head in f32 (variance over ``true_d``, default D) times their gains; q is
    then scaled by ``scale*log2(e)`` in f32 and rounded to the activation
    dtype, and k is rounded. Scores are f32, the base-2 softmax uses the
    static shift ``fixed_max`` (or the row max when None), p is rounded to
    v's dtype before the f32 PV product, and the result is divided by the f32
    row sum.
    """
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kv_len = k.shape[1] if kv_len is None else min(kv_len, k.shape[1])
    k = k[:, :kv_len]
    if qk_gains is not None:
        qs, k = qk_norm_plain(q, k, qk_gains, scale=scale, true_d=true_d, eps=eps,
                              dtype=v.dtype)
    else:
        qs = q * _q_scale(scale, q.dtype).to(q.device)
    return flash_attention_prescaled_plain(qs, k, v, kv_len=kv_len, fixed_max=fixed_max,
                                           chunk=chunk)


def qk_norm_plain(q: torch.Tensor, k: torch.Tensor,
                  qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]], *, scale: float,
                  true_d: Optional[int] = None, eps: float = 1e-6,
                  dtype: Optional[torch.dtype] = None,
                  rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  group: Optional[int] = None):
    """The pre-pass of K1q and of K5's groups above 16 tokens in plain
    PyTorch: q and k RMS-normed per head in f32 (variance over ``true_d``,
    default D) times their gains, or taken to f32 when ``qk_gains`` is None;
    with ``rope_tables`` (``[group, D/2]``) rotated in f32 at the in-group
    position ``token % group`` (S a multiple of ``group``); q then times
    ``scale*log2(e)`` in f32 and rounded to its dtype, k rounded to ``dtype``
    (default k's). Returns contiguous ``(q^, k^)``."""
    td = q.shape[-1] if true_d is None else true_d

    def prep(t, gain):
        t32 = _rms_head(t, gain, td, eps) if gain is not None else t.float()
        if rope_tables is None:
            return t32
        b, s_len, h, d = t32.shape
        grouped = t32.reshape(b, s_len // group, group, h, d)
        return apply_rope(grouped, *rope_tables).reshape(b, s_len, h, d)

    gq, gk = qk_gains if qk_gains is not None else (None, None)
    qs = (prep(q, gq) * (scale * _LOG2E)).to(q.dtype)
    ks = prep(k, gk).to(dtype or k.dtype)
    return qs.contiguous(), ks.contiguous()


def flash_attention_prescaled_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    *, kv_len: Optional[int] = None,
                                    fixed_max: Optional[float] = None,
                                    chunk: int = 256) -> torch.Tensor:
    """The attention body's math on a q already scaled by ``scale*log2(e)``
    and rounded (the body at q_scale 1, as K1q runs it after its pre-pass):
    f32 scores, the base-2 softmax with the static shift ``fixed_max`` (or
    the row max when None), p rounded to v's dtype before the f32 PV
    product, divided by the f32 row sum; keys at or past ``kv_len`` left
    out. Over query-row chunks of ``chunk`` rows."""
    b, sq, h, d = qs.shape
    kv_len = k.shape[1] if kv_len is None else min(kv_len, k.shape[1])
    k = k[:, :kv_len]
    kt = k.permute(0, 2, 3, 1).float()                   # [B, H, D, Skv]
    vf = v[:, :kv_len].permute(0, 2, 1, 3).float()       # [B, H, Skv, D]
    out = torch.empty((b, sq, h, d), dtype=qs.dtype, device=qs.device)
    for i0 in range(0, sq, chunk):
        s = qs[:, i0:i0 + chunk].permute(0, 2, 1, 3).float() @ kt
        if fixed_max is not None:
            p = torch.exp2(torch.clamp(s, max=fixed_max + 126.0) - fixed_max)
        else:
            p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = (p.to(v.dtype).float() @ vf) / p.sum(-1, keepdim=True)
        out[:, i0:i0 + chunk] = o.permute(0, 2, 1, 3).to(qs.dtype)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         fixed_max: Optional[float] = None,
                         qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         true_d: Optional[int] = None,
                         eps: float = 1e-6) -> torch.Tensor:
    """K1: full non-causal attention on ``[B, S, H, D]`` -> ``[B, Sq, H, D]``.

    ``fixed_max``: the static softmax shift (pass only for trunks whose scores
    are norm-bounded); None runs the online running-max softmax.

    ``qk_gains=(qg, kg)`` (``[H, D]`` or ``[D]`` f32) add the per-head RMS
    qk-norm (variance over ``true_d``): K1q, which takes bf16 head dim 72
    with ``fixed_max`` and reads q, k and v through their batch and token
    strides (unit channel stride, 16-byte aligned rows), so column slices of
    one fused projection need no copies; a pre-pass writes the normed q and
    k (``qk_norm_plain``), the body then runs at q_scale 1
    (``flash_attention_prescaled_plain``). K1 without the norm takes
    contiguous bf16 head dim 128. Anything else on a CUDA tensor raises.
    Launches count in ``flash_attention_bshd.launches`` (K1; by softmax
    shift in ``flash_attention_bshd.modes``, "fixed" or "running") and
    ``flash_attention_bshd.qknorm_launches`` (K1q).
    """
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, scale=scale, kv_len=kv_len,
                                          fixed_max=fixed_max, qk_gains=qk_gains,
                                          true_d=true_d, eps=eps)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kv_len = skv if kv_len is None else min(kv_len, skv)
    if kv_len < 1 or b * h > 65535:
        raise ValueError(f"flash_attention_bshd: kv_len {kv_len} < 1 or "
                         f"B*H {b * h} > 65535")
    if qk_gains is not None:
        return _flash_attention_qknorm(q, k, v, scale, kv_len, fixed_max,
                                       qk_gains, true_d, eps)
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention_bshd: the kernel takes head dim "
                         f"{KERNEL_HEAD_DIM}, got {d}")
    for name, t, shape in (("q", q, (b, sq, h, d)), ("k", k, (b, skv, h, d)),
                           ("v", v, (b, skv, h, d))):
        check_bf16(f"flash_attention_bshd: {name}", t, shape, q.device)
    # K1b's launch on the head-major views: one body, one tile order
    out, _, _ = _strided_launch("flash_attention_bshd",
                                *(t.transpose(1, 2) for t in (q, k, v)), scale=scale,
                                kv_len=kv_len, mode=int(fixed_max is not None),
                                fixed_max=fixed_max)
    out = out.transpose(1, 2)
    count_launch(flash_attention_bshd)
    count_launch(flash_attention_bshd, "modes", "running" if fixed_max is None else "fixed")
    return out


def _flash_attention_qknorm(q, k, v, scale, kv_len, fixed_max, qk_gains, true_d,
                            eps) -> torch.Tensor:
    """K1q's launch: checks what the kernel takes, raises on anything else."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if d != GROUPED_HEAD_DIM or true_d not in (None, d):
        raise ValueError(f"flash_attention_bshd: the qk-normed kernel takes head "
                         f"dim {GROUPED_HEAD_DIM} (true_d None or equal), got {d} "
                         f"(true_d {true_d})")
    if fixed_max is None:
        raise ValueError("flash_attention_bshd: the qk-normed kernel takes the "
                         "fixed softmax shift only (pass fixed_max)")
    dev = q.device
    for name, t, shape in (("q", q, (b, sq, h, d)), ("k", k, (b, skv, h, d)),
                           ("v", v, (b, skv, h, d))):
        _check_head_rows(f"flash_attention_bshd: {name}", t, shape, dev)
    gains = []
    for name, t in zip(("qg", "kg"), qk_gains):
        if t.device != dev or t.numel() not in (d, h * d):
            raise ValueError(f"flash_attention_bshd: {name} must hold [{h}, {d}] "
                             f"or [{d}] on {dev}")
        gains.append(t.float().reshape(-1, d).expand(h, d).contiguous())
    qn, kn = _qk_norm_launch(q, k[:, :kv_len], gains, scale, eps)
    out = _qknorm_attention_launch(qn, kn, v, kv_len, fixed_max)
    count_launch(flash_attention_bshd, "qknorm_launches")
    return out


def _qk_norm_launch(q, k, gains, scale: float, eps: float, *, rope=None,
                    group: Optional[int] = None, group_valid: Optional[int] = None):
    """The pre-pass on the card (``qk_norm_kernel``): contiguous ``(q^,
    k^)`` from checked ``[B, S, H, 72]`` q and k views, f32 ``[H, 72]``
    gains (or ``[None, None]``) and optional f32 ``[group, 36]`` RoPE tables
    at ``token % group``. K1q: no RoPE, every row (``group`` None). K5: k^
    rows at in-group positions from ``group_valid`` on are left unwritten
    (the attention's tensor map never reads them)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qn = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    kn = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    gq, gk = (sq, sk) if group is None else (group, group)
    kv = gk if group_valid is None else group_valid
    cos, sin = rope if rope is not None else (None, None)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = load_cuda_library()
    code = lib.mc_qk_prepass(
        q.data_ptr(), k.data_ptr(), qn.data_ptr(), kn.data_ptr(), ptr(gains[0]),
        ptr(gains[1]), ptr(cos), ptr(sin), b, sq, sk, h, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), gq, gk, gq, kv, scale * _LOG2E, 1.0 / d, float(eps),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, code, "qk-norm pre-pass")
    return qn, kn


def _qknorm_attention_launch(qn, kn, v, kv_len: int, fixed_max: float):
    """K1q's attention on the card: the body at head dim 72 carried as 80,
    fixed max, q used as it is; q^ and k^ contiguous, v a checked view.
    Returns a contiguous ``[B, Sq, H, 72]``."""
    b, sq, h, d = qn.shape
    out = torch.empty_like(qn)
    heads_major = [t.transpose(1, 2) for t in (qn, kn, v, out)]
    maps = flash_tma_maps("flash_attention_bshd (qk-norm)", *heads_major[:3], kv_len)
    lib = load_cuda_library()
    code = lib.mc_flash_attention_qknorm_tma(
        qn.data_ptr(), kn.data_ptr(), v.data_ptr(), out.data_ptr(), map_words(maps),
        (ctypes.c_longlong * 3)(*heads_major[3].stride()[:3]), b, h, sq, kv_len,
        float(fixed_max), torch.cuda.current_stream(qn.device).cuda_stream)
    check_launch(lib, code, "flash_attention_bshd (qk-norm)")
    return out


flash_attention_bshd.launches = 0
flash_attention_bshd.modes = {"fixed": 0, "running": 0}
flash_attention_bshd.qknorm_launches = 0


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, scale: Optional[float] = None,
                               kv_len: Optional[int] = None,
                               fixed_max: Optional[float] = None,
                               chunk: int = 256) -> torch.Tensor:
    """K1b's math in plain PyTorch: ``flash_attention_bshd_plain`` on
    ``[B, H, S, D]`` (the same rounding points; only the layout differs)."""
    out = flash_attention_bshd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale,
        kv_len=kv_len, fixed_max=fixed_max, chunk=chunk)
    return out.transpose(1, 2)


def _strided_launch(name: str, q, k, v, *, scale, kv_len, mode: int,
                    fixed_max: Optional[float]):
    """Launch of the wgmma/TMA body (K1 and K1b: mode 0 running max, 1 fixed
    max; K1c: mode 2) on bf16 ``[B, H, S, 128]`` tensors or views. Checks
    what the kernel takes and raises on anything else. Returns ``(o, m, l)``,
    m and l None unless mode 2; o has q's layout."""
    if not (q.ndim == k.ndim == v.ndim == 4):
        raise ValueError(f"{name}: q, k and v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dev = q.device
    kv_len = skv if kv_len is None else min(kv_len, skv)
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes head dim {KERNEL_HEAD_DIM}, "
                         f"got {d}")
    if kv_len < 1 or b * h > 65535:
        raise ValueError(f"{name}: kv_len {kv_len} < 1 or B*H {b * h} > 65535")
    for label, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, h, skv, d)),
                            ("v", v, (b, h, skv, d))):
        if not (t.is_cuda and t.device == dev and t.dtype == torch.bfloat16
                and tuple(t.shape) == shape and t.stride(3) == 1
                and t.data_ptr() % 16 == 0
                and all(st % 8 == 0 for st in t.stride()[:3])):
            raise ValueError(
                f"{name}: {label} must be a bf16 CUDA tensor of shape {shape} on "
                f"{dev} with unit channel stride and 16-byte aligned rows; got "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")
    # o takes q's layout when q is a head-major view of [B, S, H, D]
    if q.transpose(1, 2).is_contiguous():
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    else:
        out = torch.empty((b, h, sq, d), dtype=q.dtype, device=dev)
    m = l = None
    if mode == 2:
        m = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        l = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        q_scale = scale * _LOG2E          # applied to the f32 scores
    else:
        q_scale = float(_q_scale(scale, q.dtype))
    maps = flash_tma_maps(name, q, k, v, kv_len)
    lib = load_cuda_library()
    code = lib.mc_flash_attention_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, map_words(maps),
        (ctypes.c_longlong * 3)(*out.stride()[:3]), b, h, sq, kv_len, q_scale, mode,
        float(fixed_max) if fixed_max is not None else 0.0,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, name)
    return out, m, l


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale: Optional[float] = None,
                         kv_len: Optional[int] = None,
                         fixed_max: Optional[float] = None) -> torch.Tensor:
    """K1b: full non-causal attention on ``[B, H, S, D]`` -> ``[B, H, Sq, D]``,
    K1's math (q pre-scaled by ``scale*log2(e)`` in the activation dtype,
    keys at or past ``kv_len`` masked, the fixed shift ``fixed_max`` with its
    clamp at ``fixed_max + 126`` or the running max).

    The kernel takes bf16, head dim 128, and reads q, k and v through their
    batch, head and token strides (unit channel stride, 16-byte aligned
    rows): the head-major view ``x.transpose(1, 2)`` of a ``[B, S, H, D]``
    tensor is read in place, and the output then has the same layout.
    Anything else on a CUDA tensor raises. Launches count in
    ``flash_attention_bhsd.launches``.
    """
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, scale=scale, kv_len=kv_len,
                                          fixed_max=fixed_max)
    out, _, _ = _strided_launch("flash_attention_bhsd", q, k, v, scale=scale,
                                kv_len=kv_len, mode=int(fixed_max is not None),
                                fixed_max=fixed_max)
    count_launch(flash_attention_bhsd)
    return out


flash_attention_bhsd.launches = 0


def flash_attention_bhsd_aux_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   *, scale: Optional[float] = None,
                                   kv_len: Optional[int] = None, chunk: int = 256):
    """K1c's math in plain PyTorch over query-row chunks: f32 scores from the
    unscaled q, times ``scale*log2(e)`` in f32, keys at or past ``kv_len``
    masked, base-2 softmax around the row max, p rounded to v's dtype before
    the f32 PV product, ``o = acc / l`` rounded to q's dtype. Returns
    ``(o [B, H, Sq, D], m, l)`` with m (natural base) and l f32 ``[B, H, Sq]``.
    """
    b, h, sq, d = q.shape
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    kv_len = k.shape[2] if kv_len is None else min(kv_len, k.shape[2])
    kt = k[:, :, :kv_len].float().transpose(2, 3)        # [B, H, D, Skv]
    vf = v[:, :, :kv_len].float()
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for i0 in range(0, sq, chunk):
        s = (q[:, :, i0:i0 + chunk].float() @ kt) * (scale * _LOG2E)
        m2 = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m2)
        lc = p.sum(-1, keepdim=True)
        out[:, :, i0:i0 + chunk] = ((p.to(v.dtype).float() @ vf) / lc).to(q.dtype)
        m[:, :, i0:i0 + chunk] = m2[..., 0] / _LOG2E
        l[:, :, i0:i0 + chunk] = lc[..., 0]
    return out, m, l


def flash_attention_bhsd_aux(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             *, scale: Optional[float] = None,
                             kv_len: Optional[int] = None):
    """K1c: ``flash_attention_bhsd`` with the running max that also returns
    each row's softmax max ``m`` (natural base) and normaliser ``l``, f32
    ``[B, H, Sq]``, so that partial results over key shards can be merged
    (ring attention). Unlike K1 and K1b, q is not pre-scaled: the f32 scores
    are multiplied by ``scale*log2(e)`` after the product.

    The kernel takes what K1b's takes; anything else on a CUDA tensor raises.
    Launches count in ``flash_attention_bhsd_aux.launches``.
    """
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if q.device.type == "cpu":
        return flash_attention_bhsd_aux_plain(q, k, v, scale=scale, kv_len=kv_len)
    out = _strided_launch("flash_attention_bhsd_aux", q, k, v, scale=scale,
                          kv_len=kv_len, mode=2, fixed_max=None)
    count_launch(flash_attention_bhsd_aux)
    return out


flash_attention_bhsd_aux.launches = 0


def _attention_einsum(q, k, v, *, scale, kv_len):
    """Layout-native einsum attention for tiny sequences: f32 scores and
    softmax, p rounded to v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        key_pos = torch.arange(k.shape[1], device=k.device)
        s = torch.where(key_pos < kv_len, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


RING_THRESHOLD = 128 * 1024    # global tokens from which "auto" takes the ring
SP_IMPLS = ("auto", "ulysses", "ring")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None, kv_len: Optional[int] = None,
              fixed_max: Optional[float] = None, plan=None,
              sp_impl: str = "auto", ring_threshold: int = RING_THRESHOLD,
              kv_replicated: Optional[bool] = None,
              whole_prefix: int = 0) -> torch.Tensor:
    """Full attention over ``[B, S, H, D]`` activations.

    Without a ``plan``, routed on shape only: when ``max(Sq, Skv) <= 128`` the
    einsum path runs (no flash tiling pays off there), otherwise K1. On a
    CUDA tensor with head dim below K1's 128, q, k and v are zero-padded to
    128 and the result sliced back (exact: the padded q/k lanes add 0 to
    every score, the padded v lanes only fill output lanes that are dropped).

    Under a ``plan`` (``parallel.mesh.MeshPlan``) q holds this rank's
    ``S/sp`` tokens and the sequence-parallel strategy is picked as the JAX
    dispatcher picks it: ring attention when ``sp_impl == "ring"``, or when
    it is ``"auto"`` and the global sequence ``Sq * sp`` reaches
    ``ring_threshold``, and never for replicated k/v; otherwise Ulysses with
    ``kv_len``, ``kv_replicated`` and ``fixed_max`` passed on.
    ``kv_replicated`` (k/v whole on every rank, cross-attention) defaults to
    ``Skv != Sq``. ``"ring"`` or ``"ulysses"`` without a plan raises.
    ``whole_prefix`` (FLUX's joint text tokens): the first ``whole_prefix``
    rows of q, k and v are the same whole rows on every rank and the rest
    is the rank's shard; they enter the attention once (the global sequence
    is ``whole_prefix + (Sq - whole_prefix) * sp``).
    """
    if sp_impl not in SP_IMPLS:
        raise ValueError(f"attention: sp_impl must be one of {SP_IMPLS}, got "
                         f"{sp_impl!r}")
    d = q.shape[-1]
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    if plan is not None:
        from magcache_tpu_torch.parallel.collectives import (ring_attention,
                                                             ulysses_attention)
        kv_rep = (k.shape[1] != q.shape[1]) if kv_replicated is None else kv_replicated
        seq = whole_prefix + (q.shape[1] - whole_prefix) * plan.sp
        want_ring = sp_impl == "ring" or (sp_impl == "auto" and seq >= ring_threshold)
        if want_ring and not kv_rep:
            return ring_attention(q, k, v, plan, scale=scale, whole_prefix=whole_prefix)
        return ulysses_attention(q, k, v, plan, scale=scale, kv_len=kv_len,
                                 kv_replicated=kv_rep, fixed_max=fixed_max,
                                 whole_prefix=whole_prefix)
    if sp_impl in ("ring", "ulysses"):
        raise ValueError(f"attention sp_impl {sp_impl!r} needs a mesh plan "
                         f"(pass plan=)")
    if max(q.shape[1], k.shape[1]) <= 128:
        return _attention_einsum(q, k, v, scale=scale, kv_len=kv_len)
    if q.is_cuda and d < KERNEL_HEAD_DIM:
        q, k, v = (torch.nn.functional.pad(t, (0, KERNEL_HEAD_DIM - d)) for t in (q, k, v))
        return flash_attention_bshd(q, k, v, scale=scale, kv_len=kv_len,
                                    fixed_max=fixed_max)[..., :d]
    return flash_attention_bshd(q, k, v, scale=scale, kv_len=kv_len,
                                fixed_max=fixed_max)


def _grouped_geometry(name: str, s_len: int, group: int,
                      group_valid: Optional[int], qk_gains, fixed_max) -> int:
    """``group_valid`` resolved; raises on a bad geometry, and on a fixed
    shift without qk-norm gains (unbounded scores can underflow every p to
    0; the JAX package's STDiT3 ``qk_norm=False`` fault)."""
    gvalid = group if group_valid is None else group_valid
    if group < 1 or s_len % group or not 1 <= gvalid <= group:
        raise ValueError(f"{name}: bad geometry: S {s_len}, group {group}, "
                         f"group_valid {group_valid}")
    if fixed_max is not None and qk_gains is None:
        raise ValueError(f"{name}: fixed_max needs qk_gains (a static shift is "
                         f"exact only for RMS-normed scores)")
    return gvalid


def _check_head_rows(name: str, t: torch.Tensor, shape, dev) -> None:
    """Raises unless ``t`` is a bf16 CUDA ``[B, S, H, D]`` tensor or view that
    a head-dim-72 kernel reads through its batch and token strides: unit
    channel stride, heads D apart, 16-byte aligned rows."""
    bs, ts, hs, cs = t.stride()
    if not (t.is_cuda and t.device == dev and t.dtype == torch.bfloat16
            and tuple(t.shape) == tuple(shape) and cs == 1 and hs == shape[-1]
            and t.data_ptr() % 16 == 0 and bs % 8 == 0 and ts % 8 == 0):
        raise ValueError(
            f"{name} must be a bf16 CUDA tensor of shape {tuple(shape)} on {dev} "
            f"with unit channel stride, heads {shape[-1]} apart and 16-byte "
            f"aligned rows; got {t.dtype} {tuple(t.shape)} strides {t.stride()} "
            f"on {t.device}")


STREAM_SLOTS = 8              # the stream kernel's heads a stage, one a warp
STREAM_RING = 3               # its stages in shared memory (K9's kernel: 2)
STREAM_MAX_GROUP = 16         # groups it takes: up to 16 tokens (a box of 16 rows)
STREAM_BOX_BYTES = STREAM_MAX_GROUP * GROUPED_HEAD_DIM * 2    # a head's 16 rows of 72


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """The launch of a kernel on the stream skeleton (K5's stream route,
    K9's): ``grid`` persistent blocks walking ``per_block`` consecutive
    stages each (``stages`` in all: one a group and ``STREAM_SLOTS`` heads),
    with ``smem_bytes`` of shared memory: the ring (a stage holds one TMA box
    of 8 heads x 16 rows x 72 columns of q, k and v each), each consumer
    warp's scratch rows, two mbarriers a stage, 128 bytes of alignment and,
    when present, the gains ``[2, H, 72]`` and RoPE tables ``[2, group, 36]``
    in f32."""
    stages: int
    per_block: int
    grid: int
    smem_bytes: int


def persistent_stream(name: str, n_groups: int, heads: int, group: int, sms: int,
                      scratch: int, *, gains: bool, rope: bool,
                      ring: int = STREAM_RING) -> StreamGeometry:
    """The launch of a kernel on the stream skeleton (``csrc/stream_ring.cuh``)
    for ``n_groups`` groups of ``group`` tokens and ``heads`` heads on a card
    with ``sms`` SMs: ``ceil(H / 8)`` stages a group, split into contiguous
    ranges, one a block and at most one block an SM; shared memory for the
    ring (``ring`` stages of q, k and v boxes, two mbarriers each), the
    kernel's ``scratch`` bytes, 128 bytes of alignment, and the gains
    ``[2, H, 72]`` and RoPE tables ``[2, group, 36]`` in f32 when present.
    Raises naming ``name`` when that exceeds a block's shared memory."""
    stages = n_groups * -(-heads // STREAM_SLOTS)
    per_block = -(-stages // min(sms, stages))
    smem = ring * (3 * STREAM_SLOTS * STREAM_BOX_BYTES + 2 * 8) + scratch + 128 \
        + (2 * heads * GROUPED_HEAD_DIM * 4 if gains else 0) \
        + (2 * group * GROUPED_HEAD_DIM // 2 * 4 if rope else 0)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name}: {heads} heads with gains need {smem} bytes "
                         f"of shared memory, more than {SMEM_LIMIT}")
    return StreamGeometry(stages, per_block, -(-stages // per_block), smem)


def stream_geometry(n_groups: int, heads: int, group: int, sms: int, *,
                    gains: bool, rope: bool) -> StreamGeometry:
    """The stream kernel's geometry (``persistent_stream``; its scratch is
    each consumer warp's q^ and k^ rows in bf16); raises when its shared
    memory would exceed a block's (more than 43 heads with gains and
    RoPE)."""
    return persistent_stream("grouped attention", n_groups, heads, group, sms,
                             STREAM_SLOTS * 2 * STREAM_BOX_BYTES, gains=gains, rope=rope)


def stream_tma_maps(name: str, q, k, v, group: int, group_valid: int) -> list:
    """The stream kernel's three maps over ``[B, S, H, 72]`` tensors or
    views: dimensions (channel, in-group position, head, group, batch) over
    the tensors' own strides, position extent ``group`` for q and
    ``group_valid`` for k and v; one box is 72 columns x 16 positions x 8
    heads of one group, unswizzled, so that shared memory holds each head's
    16 rows of 72 (144 bytes) together. Positions past the extent and heads
    past H arrive as zeros."""
    maps = []
    for label, t, rows in (("q", q, group), ("k", k, group_valid), ("v", v, group_valid)):
        b, s_len, h, d = t.shape
        bs, ts, hs, cs = t.stride()
        maps.append(tma_map(f"{name}: {label}", (d, rows, h, s_len // group, b),
                            (cs, ts, hs, ts * group, bs),
                            (d, STREAM_MAX_GROUP, STREAM_SLOTS, 1, 1), 0))
    return maps


def _grouped_launch(name: str, q, k, v, *, group, gvalid, scale, qk_gains,
                    rope_tables, true_d, eps, fixed_max) -> torch.Tensor:
    """The grouped kernels' launch (K4, K5, K5r) on ``[B, S, H, 72]`` q/k/v
    read through their strides; returns ``[B, S, H*72]``. The route
    (``grouped_kernel``): "stream" for groups of up to 16 tokens; above
    that the wgmma/TMA body, on the q/k/v views ("tma") or after the norm
    pre-pass ("prepass"). Checks what the kernels take and raises on
    anything else."""
    b, s_len, heads, d = q.shape
    dev = q.device
    true_d = d if true_d is None else true_d
    scale = (1.0 / math.sqrt(true_d)) if scale is None else scale
    if d != GROUPED_HEAD_DIM or true_d != d:
        raise ValueError(f"{name}: the kernel takes head dim {GROUPED_HEAD_DIM} "
                         f"(true_d None or equal), got {d} (true_d {true_d})")
    for label, t in (("q", q), ("k", k), ("v", v)):
        _check_head_rows(f"{name}: {label}", t, (b, s_len, heads, d), dev)
    n_groups = b * s_len // group
    route = grouped_kernel(group, qk_gains, rope_tables, fixed_max)
    if route != "stream" and n_groups > 65535 or heads > 65535:
        raise ValueError(f"{name}: {n_groups} groups or {heads} heads exceed "
                         f"the launch grid")
    gains = [None, None]
    if qk_gains is not None:
        for i, (label, t) in enumerate(zip(("qg", "kg"), qk_gains)):
            if t.device != dev or t.numel() not in (d, heads * d):
                raise ValueError(f"{name}: {label} must hold [{heads}, {d}] or "
                                 f"[{d}] on {dev}")
            gains[i] = t.float().reshape(-1, d).expand(heads, d).contiguous()
    rope = None
    if rope_tables is not None:
        rope = tuple(t.float().contiguous() for t in rope_tables)
        for t in rope:
            if t.device != dev or tuple(t.shape) != (group, d // 2):
                raise ValueError(f"{name}: rope tables must be [{group}, "
                                 f"{d // 2}] on {dev}")

    if route == "prepass":
        # q^ (normed, rotated, scaled, rounded) and k^ (normed, rotated,
        # rounded), contiguous; the body then uses q as it is
        qn, kn = _qk_norm_launch(q, k, gains, scale, eps, rope=rope, group=group,
                                 group_valid=gvalid)
        out = _grouped_tma_launch(name, qn, kn, v, group, gvalid, 1.0, fixed_max)
    elif route == "tma":
        out = _grouped_tma_launch(name, q, k, v, group, gvalid, scale * _LOG2E, fixed_max)
    else:
        out = torch.empty((b, s_len, heads * d), dtype=v.dtype, device=dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        geom = stream_geometry(n_groups, heads, group, sms, gains=qk_gains is not None,
                               rope=rope is not None)
        cos, sin = rope if rope is not None else (None, None)
        ptr = lambda t: t.data_ptr() if t is not None else None
        maps = stream_tma_maps(name, q, k, v, group, gvalid)
        lib = load_cuda_library()
        code = lib.mc_grouped_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), map_words(maps), out.data_ptr(),
            ptr(gains[0]), ptr(gains[1]), ptr(cos), ptr(sin), n_groups, s_len // group,
            heads, group, gvalid, int(fixed_max is None), scale * _LOG2E, float(d),
            float(eps), float(fixed_max or 0.0), geom.grid, geom.per_block,
            geom.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
        check_launch(lib, code, name)
    count_launch(_grouped_launch, "routes", route)
    return out


def _grouped_tma_launch(name: str, q, k, v, group: int, gvalid: int, q_scale: float,
                        fixed_max: Optional[float]) -> torch.Tensor:
    """The wgmma/TMA body in the grouped geometry on checked ``[B, S, H, 72]``
    q, k and v (views, or the pre-pass's copies with ``q_scale`` 1): the
    fixed max when given, else the row max. Returns ``[B, S, H*72]``."""
    b, s_len, heads, d = q.shape
    out = torch.empty((b, s_len, heads * d), dtype=v.dtype, device=q.device)
    maps = grouped_tma_maps(name, q, k, v, group, gvalid)
    lib = load_cuda_library()
    code = lib.mc_grouped_attention_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), map_words(maps),
        b * s_len // group, s_len // group, heads, group, gvalid, q_scale,
        int(fixed_max is not None), float(fixed_max or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch(lib, code, name)
    return out


_grouped_launch.routes = {"stream": 0, "tma": 0, "prepass": 0}


def grouped_kernel(group: int, qk_gains, rope_tables, fixed_max) -> str:
    """Which grouped kernel a CUDA call runs, by its arguments alone:
    "stream" (groups of up to 16 tokens: ``grouped_stream_kernel``), "tma"
    (the wgmma/TMA body on the q/k/v views: the row max without gains or
    RoPE on larger groups) or "prepass" (larger groups with gains or RoPE,
    fixed max or row max: the norm pre-pass, then the same body). Launches
    count by route in ``_grouped_launch.routes`` beside the wrappers' own
    counts."""
    if group <= STREAM_MAX_GROUP:
        return "stream"
    if qk_gains is None and rope_tables is None:
        return "tma"
    return "prepass"


def _grouped_softmax_pv(qc, kc, vc, key_ok, fixed_max, dtype) -> torch.Tensor:
    """One chunk of groups ``[n, group, H, D]`` of f32 q (scaled, rounded)
    and k (rounded): f32 scores over the keys ``key_ok``, the fixed or the
    row-max shift, p rounded to ``dtype`` before PV, divided by the f32 sum
    of p; returns ``dtype``."""
    s = torch.einsum("nqhd,nkhd->nhqk", qc, kc)
    s = torch.where(key_ok, s, torch.full_like(s, _NEG_INF))
    if fixed_max is not None:
        p = torch.exp2(torch.clamp(s, max=fixed_max + 126.0) - fixed_max)
    else:
        p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("nhqk,nkhd->nqhd", p.to(dtype).float(), vc)
    return (o / p.sum(-1).permute(0, 2, 1)[..., None]).to(dtype)


def grouped_attention_prescaled_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      *, group: int, group_valid: Optional[int] = None,
                                      fixed_max: Optional[float] = None,
                                      chunk_elems: int = 1 << 26) -> torch.Tensor:
    """The "prepass" route's attention in plain PyTorch: on a q already
    normed, rotated, scaled by ``scale*log2(e)`` and rounded, and a k
    normed, rotated and rounded (``qk_norm_plain`` with ``group``), each
    ``[B, S, H, D]``: the groups' attention as ``grouped_flash_attention_bshd_plain``
    computes it from there, over chunks of groups. Returns ``[B, S, H, D]``."""
    group_valid = group if group_valid is None else group_valid
    b, s_len, heads, d = qs.shape
    ng = b * (s_len // group)
    qg, kg, vg = (t.reshape(ng, group, heads, d) for t in (qs, k, v))
    key_ok = torch.arange(group, device=qs.device) < group_valid
    out = torch.empty((ng, group, heads, d), dtype=v.dtype, device=qs.device)
    step = max(1, chunk_elems // (heads * group * group))
    for g0 in range(0, ng, step):
        out[g0:g0 + step] = _grouped_softmax_pv(
            *(t[g0:g0 + step].float() for t in (qg, kg, vg)), key_ok, fixed_max, v.dtype)
    return out.reshape(b, s_len, heads, d)


def grouped_flash_attention_bshd_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group: int,
        group_valid: Optional[int] = None, scale: Optional[float] = None,
        qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        true_d: Optional[int] = None, eps: float = 1e-6,
        fixed_max: Optional[float] = None,
        chunk_elems: int = 1 << 26) -> torch.Tensor:
    """K4's (and K5's) math in plain PyTorch on ``[B, S, H, D]`` q/k/v, over
    chunks of groups so that no more than ``chunk_elems`` scores exist at
    once: q and k normed (with gains) or taken to f32, rotated (with
    tables), q times ``scale*log2(e)`` in f32 and rounded once, k rounded;
    f32 scores; the fixed or the row-max shift; p rounded before PV, divided
    by the f32 sum of p after. Returns ``[B, S, H, D]``."""
    true_d = q.shape[-1] if true_d is None else true_d
    group_valid = group if group_valid is None else group_valid
    scale = (1.0 / math.sqrt(true_d)) if scale is None else scale
    b, s_len, heads, d = q.shape
    ng = b * (s_len // group)
    qg, kg, vg = (t.reshape(ng, group, heads, d) for t in (q, k, v))
    key_ok = torch.arange(group, device=q.device) < group_valid
    out = torch.empty((ng, group, heads, d), dtype=v.dtype, device=q.device)
    step = max(1, chunk_elems // (heads * group * group))
    for g0 in range(0, ng, step):
        qc, kc, vc = (t[g0:g0 + step] for t in (qg, kg, vg))      # [n, g, H, D]
        if qk_gains is not None:
            qc, kc = (_rms_head(qc, qk_gains[0], true_d, eps),
                      _rms_head(kc, qk_gains[1], true_d, eps))
        else:
            qc, kc = qc.float(), kc.float()
        if rope_tables is not None:    # f32 in, f32 out: no rounding here
            qc, kc = apply_rope(qc, *rope_tables), apply_rope(kc, *rope_tables)
        qc = (qc * (scale * _LOG2E)).to(v.dtype).float()
        kc = kc.to(v.dtype).float()
        out[g0:g0 + step] = _grouped_softmax_pv(qc, kc, vc.float(), key_ok, fixed_max,
                                                v.dtype)
    return out.reshape(b, s_len, heads, d)



def grouped_flash_attention_bshd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group: int,
        group_valid: Optional[int] = None, scale: Optional[float] = None,
        qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        true_d: Optional[int] = None, eps: float = 1e-6,
        fixed_max: Optional[float] = None) -> torch.Tensor:
    """K4: block-diagonal grouped attention on ``[B, S, H, D]`` q, k and v:
    token i attends within its contiguous group ``i // group`` to the keys
    at in-group positions ``< group_valid``. ``qk_gains``, ``rope_tables``,
    ``true_d`` and ``fixed_max`` as in ``grouped_attention_fused_qkv``;
    without ``fixed_max`` the softmax shift is each row's max. Returns
    ``[B, S, H, D]``.

    The kernel takes bf16 q/k/v of head dim 72 read through their batch and
    token strides (unit channel stride, heads 72 apart, 16-byte aligned
    rows), so column views of one projection need no copies; anything else
    on a CUDA tensor raises. Launches count in
    ``grouped_flash_attention_bshd.launches``.
    """
    b, s_len, heads, d = q.shape
    gvalid = _grouped_geometry("grouped_flash_attention_bshd", s_len, group,
                               group_valid, qk_gains, fixed_max)
    kw = dict(group=group, group_valid=gvalid, scale=scale, qk_gains=qk_gains,
              rope_tables=rope_tables, true_d=true_d, eps=eps, fixed_max=fixed_max)
    if q.device.type == "cpu":
        return grouped_flash_attention_bshd_plain(q, k, v, **kw)
    out = _grouped_launch("grouped_flash_attention_bshd", q, k, v, group=group,
                          gvalid=gvalid, scale=scale, qk_gains=qk_gains,
                          rope_tables=rope_tables, true_d=true_d, eps=eps,
                          fixed_max=fixed_max)
    count_launch(grouped_flash_attention_bshd)
    return out.reshape(b, s_len, heads, d)


grouped_flash_attention_bshd.launches = 0


def split_qkv(qkv: torch.Tensor, heads: int):
    """q, k and v ``[B, S, H, D]`` as column views of ``[B, S, 3*H*D]``."""
    return qkv.unflatten(-1, (3, heads, -1)).unbind(2)


def grouped_attention_fused_qkv_plain(
        qkv: torch.Tensor, heads: int, *, group: int,
        qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        fixed_max: Optional[float] = None,
        group_valid: Optional[int] = None, scale: Optional[float] = None,
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        true_d: Optional[int] = None, eps: float = 1e-6,
        chunk_elems: int = 1 << 26) -> torch.Tensor:
    """K5's (and K5r's) math in plain PyTorch (``grouped_flash_attention_bshd_plain``
    on column views)."""
    b, s_len, _ = qkv.shape
    q, k, v = split_qkv(qkv, heads)
    return grouped_flash_attention_bshd_plain(
        q, k, v, group=group, group_valid=group_valid, scale=scale,
        qk_gains=qk_gains, rope_tables=rope_tables, true_d=true_d, eps=eps,
        fixed_max=fixed_max, chunk_elems=chunk_elems).reshape(b, s_len, -1)


def grouped_attention_fused_qkv(
        qkv: torch.Tensor, heads: int, *, group: int,
        qk_gains: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        fixed_max: Optional[float] = None,
        group_valid: Optional[int] = None, scale: Optional[float] = None,
        rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        true_d: Optional[int] = None, eps: float = 1e-6) -> torch.Tensor:
    """K5: block-diagonal grouped attention over the fused projection.

    qkv: ``[B, S, 3*H*D]`` (columns q|k|v, head-major inside each); token i
    attends within its contiguous group ``i // group`` to the keys at
    in-group positions ``< group_valid``. ``qk_gains=(qg, kg)`` (``[H, D]``
    or ``[D]`` f32) are the per-head RMS qk-norm's gains (variance over
    ``true_d``); ``fixed_max`` is the static softmax shift, exact only for
    such normed scores (refused without gains); without it the shift is
    each row's max over the group's valid keys (K5r: Latte's attention, no
    qk-norm); ``rope_tables=(cos, sin)`` (``[group, D/2]`` f32, see
    ``ops.rope.grouped_rope_tables``) fuse RoPE over the in-group position.
    Returns ``[B, S, H*D]``.

    The kernel takes contiguous bf16 and D = 72 (STDiT3's and Latte's
    heads); anything else on a CUDA tensor raises. Launches count in
    ``grouped_attention_fused_qkv.launches`` (fixed max) and
    ``grouped_attention_fused_qkv.rowmax_launches`` (K5r).
    """
    b, s_len, three_hd = qkv.shape
    if three_hd % (3 * heads):
        raise ValueError(f"grouped_attention_fused_qkv: width {three_hd} is not "
                         f"3 x {heads} heads")
    gvalid = _grouped_geometry("grouped_attention_fused_qkv", s_len, group,
                               group_valid, qk_gains, fixed_max)
    if qkv.device.type == "cpu":
        return grouped_attention_fused_qkv_plain(
            qkv, heads, group=group, group_valid=gvalid, scale=scale,
            qk_gains=qk_gains, rope_tables=rope_tables, true_d=true_d, eps=eps,
            fixed_max=fixed_max)
    check_bf16("grouped_attention_fused_qkv: qkv", qkv, (b, s_len, three_hd),
               qkv.device)
    q, k, v = split_qkv(qkv, heads)
    out = _grouped_launch("grouped_attention_fused_qkv", q, k, v, group=group,
                          gvalid=gvalid, scale=scale, qk_gains=qk_gains,
                          rope_tables=rope_tables, true_d=true_d, eps=eps,
                          fixed_max=fixed_max)
    count_launch(grouped_attention_fused_qkv,
                 "rowmax_launches" if fixed_max is None else "launches")
    return out


grouped_attention_fused_qkv.launches = 0
grouped_attention_fused_qkv.rowmax_launches = 0


def fused_cross_attention_plain(
        x: torch.Tensor, wq: torch.Tensor, bq: Optional[torch.Tensor],
        k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
        bo: Optional[torch.Tensor], heads: int, *,
        scale: Optional[float] = None, kv_valid: Optional[int] = None,
        true_d: Optional[int] = None, residual: bool = False,
        chunk: int = 4096) -> torch.Tensor:
    """K6's math in plain PyTorch over query chunks of ``chunk`` rows (GEMMs
    in f32 from the rounded operands). ``true_d`` only sets the default
    scale: the normaliser is always the f32 sum of p."""
    b, n, _ = x.shape
    hd = wq.shape[0]
    d = hd // heads
    L = k.shape[1]
    scale = (1.0 / math.sqrt(true_d or d)) if scale is None else scale
    kv_valid = L if kv_valid is None else kv_valid
    kf = k.float().reshape(b, L, heads, d)
    vf = v.float().reshape(b, L, heads, d)
    key_ok = torch.arange(L, device=x.device) < kv_valid
    wq32, wo32 = wq.float(), wo.float()
    out = torch.empty((b, n, wo.shape[0]), dtype=x.dtype, device=x.device)
    for i0 in range(0, n, chunk):
        xc = x[:, i0:i0 + chunk].float()
        q = xc @ wq32.T
        if bq is not None:
            q = q + bq.float()
        q = q.to(k.dtype).float().reshape(b, -1, heads, d)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kf) * (scale * _LOG2E)
        s = torch.where(key_ok, s, torch.full_like(s, _NEG_INF))
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        o = o / p.sum(-1).permute(0, 2, 1)[..., None]
        acc = o.reshape(b, -1, hd).to(wo.dtype).float() @ wo32.T
        if bo is not None:
            acc = acc + bo.float()
        if residual:
            acc = acc + xc
        out[:, i0:i0 + chunk] = acc.to(x.dtype)
    return out


def cross_attention_rowmax_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 heads: int, *, scale: float,
                                 kv_valid: Optional[int] = None,
                                 chunk: int = 4096) -> torch.Tensor:
    """K6's attention stage in plain PyTorch on ``[B, N, H*D]`` q and
    ``[B, L, H*D]`` k/v: f32 scores from the unscaled q times
    ``scale*log2(e)``, keys at or past ``kv_valid`` masked, p = exp2(s -
    row max) rounded to v's dtype before the f32 PV product, divided by the
    f32 sum of p, rounded to q's dtype. Returns ``[B, N, H*D]``."""
    b, n, hd = q.shape
    L = k.shape[1]
    d = hd // heads
    kv_valid = L if kv_valid is None else kv_valid
    kf = k.float().reshape(b, L, heads, d)
    vf = v.float().reshape(b, L, heads, d)
    key_ok = torch.arange(L, device=q.device) < kv_valid
    out = torch.empty_like(q)
    for i0 in range(0, n, chunk):
        qc = q[:, i0:i0 + chunk].float().reshape(b, -1, heads, d)
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * (scale * _LOG2E)
        s = torch.where(key_ok, s, torch.full_like(s, _NEG_INF))
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
        o = o / p.sum(-1).permute(0, 2, 1)[..., None]
        out[:, i0:i0 + chunk] = o.reshape(b, -1, hd).to(q.dtype)
    return out


def fused_cross_attention(
        x: torch.Tensor, wq: torch.Tensor, bq: Optional[torch.Tensor],
        k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
        bo: Optional[torch.Tensor], heads: int, *,
        scale: Optional[float] = None, kv_valid: Optional[int] = None,
        true_d: Optional[int] = None, residual: bool = False) -> torch.Tensor:
    """K6: ``[x +] attention(x @ wq.T + bq, k, v) @ wo.T + bo``.

    x: ``[B, N, d_model]``; wq: ``[H*D, d_model]`` and wo: ``[d_out, H*D]``
    (``nn.Linear`` weights); k/v: ``[B, L, H*D]``, the context projections.
    Keys at or past ``kv_valid`` (default: all) are masked. ``residual``
    needs ``d_out == d_model``. Returns ``[B, N, d_out]``.

    On a CUDA tensor, three kernels (one launch count, and one in
    ``fused_cross_attention.epilogues`` by ``residual``): q = x @ wq.T + bq
    and the out-projection on the GEMM body (``ops/gemm.py``), the attention
    between them on ``hopper_cross_kernel``. They take contiguous bf16, D =
    72, at most 512 valid keys and widths that are multiples of 8; anything
    else raises. The stages' plain versions are ``ops.gemm.linear_plain``
    and ``cross_attention_rowmax_plain``.
    """
    b, n, dm = x.shape
    hd = wq.shape[0]
    L = k.shape[1]
    d_out = wo.shape[0]
    kv_valid = L if kv_valid is None else kv_valid
    if hd % heads or not 1 <= kv_valid <= L or (residual and d_out != dm):
        raise ValueError(f"fused_cross_attention: bad geometry: width {hd}, "
                         f"heads {heads}, kv_valid {kv_valid} of {L}, d_out "
                         f"{d_out}, d_model {dm}, residual {residual}")
    if x.device.type == "cpu":
        return fused_cross_attention_plain(x, wq, bq, k, v, wo, bo, heads,
                                           scale=scale, kv_valid=kv_valid,
                                           true_d=true_d, residual=residual)
    d = hd // heads
    if d != GROUPED_HEAD_DIM or true_d not in (None, d) or kv_valid > CROSS_MAX_KEYS:
        raise ValueError(f"fused_cross_attention: the kernels take head dim "
                         f"{GROUPED_HEAD_DIM} and at most {CROSS_MAX_KEYS} valid keys, "
                         f"got {heads} x {d} (true_d {true_d}), {kv_valid} keys")
    if dm % 8 or d_out % 8 or b * heads > 65535:
        raise ValueError(f"fused_cross_attention: widths {dm} -> {d_out} must "
                         f"be multiples of 8, batch x heads {b * heads} <= 65535")
    dev = x.device
    check_bf16("fused_cross_attention: x", x, (b, n, dm), dev)
    check_bf16("fused_cross_attention: wq", wq, (hd, dm), dev)
    check_bf16("fused_cross_attention: k", k, (b, L, hd), dev)
    check_bf16("fused_cross_attention: v", v, (b, L, hd), dev)
    check_bf16("fused_cross_attention: wo", wo, (d_out, hd), dev)
    bq32 = (bq.float().contiguous() if bq is not None
            else torch.zeros(hd, dtype=torch.float32, device=dev))
    bo32 = (bo.float().contiguous() if bo is not None
            else torch.zeros(d_out, dtype=torch.float32, device=dev))
    if bq32.shape != (hd,) or bo32.shape != (d_out,) or bq32.device != dev \
            or bo32.device != dev:
        raise ValueError(f"fused_cross_attention: biases must be [{hd}] and "
                         f"[{d_out}] on {dev}")
    scale = (1.0 / math.sqrt(d)) if scale is None else scale
    q = gemm_launch("fused_cross_attention (q)", x, wq, bq32)
    o = _cross_attention_launch(q, k, v, heads, scale, kv_valid)
    out = gemm_launch("fused_cross_attention (out)", o, wo, bo32,
                      epilogue="resid" if residual else "bias",
                      resid=x if residual else None)
    count_launch(fused_cross_attention)
    count_launch(fused_cross_attention, "epilogues", "resid" if residual else "bias")
    return out


def _cross_attention_launch(q, k, v, heads: int, scale: float, kv_valid: int):
    """K6's attention stage on the card: ``[B, N, H*72]`` from checked
    contiguous bf16 q and k/v. A block walks query tiles of one (batch,
    head), as many blocks per (batch, head) as fill the card once."""
    b, n, hd = q.shape
    dev = q.device
    views = [t.unflatten(-1, (heads, GROUPED_HEAD_DIM)) for t in (q, k, v)]
    maps = cross_tma_maps("fused_cross_attention", *views, kv_valid)
    n_tiles = -(-n // TMA_BOX_ROWS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_head = max(1, min(n_tiles, sms // (b * heads)))
    o = torch.empty_like(q)
    lib = load_cuda_library()
    code = lib.mc_cross_attention_tma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), map_words(maps), o.data_ptr(), b, n,
        heads, kv_valid, -(-n_tiles // per_head), scale * _LOG2E,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, code, "fused_cross_attention (attention)")
    return o


fused_cross_attention.launches = 0
# launches by the out-projection's epilogue: "resid" (the residual fused),
# "bias" (PAB's cached branch, no residual)
fused_cross_attention.epilogues = {"resid": 0, "bias": 0}
