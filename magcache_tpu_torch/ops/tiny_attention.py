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
  over ``p*v``, times ``1/l``, one rounding at the store.
  ``tiny_temporal_attention_plain`` is its plain version. Two kernels, by
  shape alone (``tiny_kernel_route``): "stream" (T <= 16 and head dim 72,
  every caller's shape: ``tiny_stream_kernel``, persistent blocks fed by TMA
  through a ring, on the skeleton of K5's stream route) and "general"
  (``tiny_attention_kernel``, one thread a (row, head, frame)).

Either mode routes by shape as the JAX function does: T > 32 or an odd head
dim takes ``_reference``, the unfused composition over ``ops.attention.
attention``. (The JAX package's ``H*D % 128`` rule is a TPU lane constraint
and is not carried over.) K9 takes bf16 with a head dim that is a multiple
of 8 up to 128; anything else on a CUDA tensor raises. K9's launches count
in ``tiny_temporal_attention.launches`` and by route in
``tiny_temporal_attention.routes``, K4's in
``grouped_flash_attention_bshd.launches``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from magcache_tpu_torch.ops.attention import (GROUPED_HEAD_DIM, STREAM_MAX_GROUP,
                                              STREAM_SLOTS, StreamGeometry, attention,
                                              grouped_flash_attention_bshd,
                                              persistent_stream, split_qkv,
                                              stream_tma_maps)
from magcache_tpu_torch.ops.build import (check_bf16, check_launch, count_launch,
                                          load_cuda_library, map_words)
from magcache_tpu_torch.ops.norms import rms_norm
from magcache_tpu_torch.ops.rope import apply_rope

__all__ = ["tiny_temporal_attention", "tiny_temporal_attention_plain", "MODES",
           "tiny_kernel_route", "tiny_stream_geometry"]

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


def tiny_kernel_route(t_len: int, d: int) -> str:
    """Which K9 kernel a CUDA call runs, by its frame count and head dim
    alone: "stream" (``tiny_stream_kernel``: T <= 16 and head dim 72, the
    boxes of 16 frames x 72 columns) or "general" (``tiny_attention_kernel``:
    any other shape the wrapper takes). Launches count by route in
    ``tiny_temporal_attention.routes``."""
    return "stream" if t_len <= STREAM_MAX_GROUP and d == GROUPED_HEAD_DIM else "general"


# a consumer warp's f32 scratch rows: k^ and v, 16 rows of 72 + 4 each (then
# the output in bf16); the ring holds two stages
TINY_SCRATCH_BYTES = 2 * STREAM_MAX_GROUP * (GROUPED_HEAD_DIM + 4) * 4
TINY_RING = 2


def tiny_stream_geometry(rows: int, heads: int, t_len: int, sms: int, *, gains: bool,
                         rope: bool) -> StreamGeometry:
    """The stream route's launch for ``rows`` groups of ``t_len`` frames and
    ``heads`` heads on a card with ``sms`` SMs (``ops.attention.
    persistent_stream`` with two ring stages and each consumer warp's f32
    scratch rows); raises when its shared memory would exceed a block's
    (more than 68 heads with gains and 16 frames of RoPE)."""
    return persistent_stream("tiny_temporal_attention", rows, heads, t_len, sms,
                             STREAM_SLOTS * TINY_SCRATCH_BYTES, gains=gains, rope=rope,
                             ring=TINY_RING)


def check_kernel_args(shape, heads: int, q_gain, k_gain, cos, sin, dev):
    """What K9 takes besides the qkv tensor itself: head dims that are
    multiples of 8 up to 128, gains of ``[H, D]`` or ``[D]`` values and RoPE
    tables ``[T, D/2]``, all on ``dev``. Returns the gains ``[H, D]`` and
    tables in contiguous f32 (None where absent); raises ``ValueError`` on
    anything else."""
    r, t_len, three_hd = shape
    d = three_hd // 3 // heads
    if d % 8 or d > 128 or heads > 65535:
        raise ValueError(f"tiny_temporal_attention: the kernel takes head dims "
                         f"that are multiples of 8 up to 128 (and at most 65,535 "
                         f"heads), got {heads} x {d}")
    gains = [None, None]
    if q_gain is not None:
        for i, (label, t) in enumerate((("q_gain", q_gain), ("k_gain", k_gain))):
            if t is None or t.device != dev or t.numel() not in (d, heads * d):
                raise ValueError(f"tiny_temporal_attention: {label} must hold "
                                 f"[{heads}, {d}] or [{d}] on {dev}")
            gains[i] = t.float().reshape(-1, d).expand(heads, d).contiguous()
    tabs = [None, None]
    if cos is not None:
        tabs = [None if t is None else t.float().contiguous() for t in (cos, sin)]
        for t in tabs:
            if t is None or t.device != dev or tuple(t.shape) != (t_len, d // 2):
                raise ValueError(f"tiny_temporal_attention: rope tables must be "
                                 f"[{t_len}, {d // 2}] on {dev}")
    return gains, tabs


def _vpu(qkv, q_gain, k_gain, cos, sin, heads, *, eps, scale):
    """K9's launch on the route ``tiny_kernel_route`` picks: checks what the
    kernels take, raises on anything else."""
    r, t_len, three_hd = qkv.shape
    hd = three_hd // 3
    d = hd // heads
    dev = qkv.device
    gains, tabs = check_kernel_args(qkv.shape, heads, q_gain, k_gain, cos, sin, dev)
    check_bf16("tiny_temporal_attention: qkv", qkv, (r, t_len, three_hd), dev)
    route = tiny_kernel_route(t_len, d)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = load_cuda_library()
    out = torch.empty((r, t_len, hd), dtype=qkv.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "stream":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        geom = tiny_stream_geometry(r, heads, t_len, sms, gains=gains[0] is not None,
                                    rope=tabs[0] is not None)
        # q, k and v as [1, R*T, H, 72] column views: groups of T frames
        q, k, v = split_qkv(qkv.reshape(1, r * t_len, three_hd), heads)
        maps = stream_tma_maps("tiny_temporal_attention", q, k, v, t_len, t_len)
        code = lib.mc_tiny_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), map_words(maps), out.data_ptr(),
            ptr(gains[0]), ptr(gains[1]), ptr(tabs[0]), ptr(tabs[1]), r, t_len, heads,
            scale * _LOG2E, float(eps), geom.grid, geom.per_block, geom.smem_bytes, stream)
    else:
        code = lib.mc_tiny_attention(
            qkv.data_ptr(), out.data_ptr(), ptr(gains[0]), ptr(gains[1]), ptr(tabs[0]),
            ptr(tabs[1]), r, t_len, heads, d, scale * _LOG2E, float(eps), stream)
    check_launch(lib, code, "tiny_temporal_attention")
    count_launch(tiny_temporal_attention)
    count_launch(tiny_temporal_attention, "routes", route)
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
tiny_temporal_attention.routes = {"stream": 0, "general": 0}
