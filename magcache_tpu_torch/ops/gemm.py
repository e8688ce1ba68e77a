"""The wgmma/TMA GEMM body (``csrc/hopper_gemm.cuh``) that K7, K6's two
projections and K8 run on: its plain version, its tensor-map geometry, K8's
row geometry and its launch.

``out = epilogue(x @ w.T)`` with x ``[B, S, K]`` and w an ``nn.Linear``
weight ``[N, K]``, both bf16 and contiguous; the output is ``[B, rows_out,
N]`` with rows ``S..rows_out-1`` of each batch row zeros. Epilogues: bias,
bias + tanh-gelu, bias + residual, and K8's gate (``bf16(acc + bias) *
gate``, then with a residual ``bf16(that) + resid``), each in f32 with one
rounding at the store. K7 (``ops.fused_prologue``) runs it on its
LayerNorm-modulated operand. Nothing here counts launches: the wrappers
that call it do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from magcache_tpu_torch.ops.build import check_launch, load_cuda_library, map_words, tma_map

__all__ = ["linear_plain", "gemm_tma_maps", "gemm_launch", "GEMM_TILE",
           "GateGeometry", "gate_geometry", "gate_row_index"]

GEMM_TILE = (128, 192, 64)      # rows, columns and k of the body's tiles
EPILOGUES = {"bias": 0, "gelu": 1, "resid": 2}


class GateGeometry(NamedTuple):
    """How K8 lays ``[B, S_in, K] -> [B, rows_out, N]`` onto the body:
    ``batches x rows`` input rows (x viewed as ``[batches, rows, K]``),
    ``rows_out`` output rows a batch, and output row (b, s) multiplied by
    gate row ``b // rep + s // span``. ``flat``: the batch folded into the
    rows (B = 1), so that a 128-row tile holds 128 live rows."""
    flat: bool
    batches: int
    rows: int
    rows_out: int
    rep: int
    span: int


def gate_geometry(b: int, s_in: int, rows_out: int, batch_repeat: int) -> GateGeometry:
    """K8's geometry: flat ``[1, B*S_in]`` when ``rows_out == S_in`` (every
    call of the paths: a batch row of STDiT3's temporal projection has 15
    rows, and tiles of one batch row would leave 113 of 128 rows dead);
    otherwise the 3-D ``[B, S_in]`` whose tiles stay in one batch row, where
    the row extent S_in zero-fills pad rows and the output extent drops
    rows. Gate rows are ``b // batch_repeat`` in the caller's rows: one
    gate row spans ``S_in * batch_repeat`` flat rows."""
    span = s_in * batch_repeat
    if rows_out == s_in:
        return GateGeometry(True, 1, b * s_in, b * s_in, batch_repeat, span)
    return GateGeometry(False, b, s_in, rows_out, batch_repeat, span)


def gate_row_index(geom: GateGeometry) -> torch.Tensor:
    """The gate row each output row of ``[batches, rows_out]`` reads, as the
    kernel computes it (``b // rep + s // span``); -1 where the row is
    written as zeros (a pad row, at or past the input's rows)."""
    b = torch.arange(geom.batches)[:, None]
    s = torch.arange(geom.rows_out)[None, :]
    idx = b // geom.rep + s // geom.span
    return torch.where(s < geom.rows, idx, torch.full_like(idx, -1))


def linear_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 act: Optional[str] = None, gate: Optional[torch.Tensor] = None,
                 resid: Optional[torch.Tensor] = None,
                 rows_out: Optional[int] = None) -> torch.Tensor:
    """The body's math in plain PyTorch: the f32 product of the rounded
    operands, + bias, then tanh-gelu (``act="gelu"``), or rounded to x's
    dtype and times ``gate`` (f32 ``[B, rows, N]``, one gate row per output
    row: K8), then + resid (rounded first after a gate), in f32, rounded
    once to x's dtype. Rows at or past ``rows_out`` are dropped, and zero
    rows appended up to it."""
    rows_out = x.shape[1] if rows_out is None else rows_out
    out = x[:, :rows_out].float() @ w.float().T
    if bias is not None:
        out = out + bias.float()
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    if gate is not None:
        out = out.to(x.dtype).float() * gate[:, :out.shape[1]].float()
        if resid is not None:
            out = out.to(x.dtype).float()
    if resid is not None:
        out = out + resid[:, :out.shape[1]].float()
    out = out.to(x.dtype)
    if rows_out == out.shape[1]:
        return out
    pad = out.new_zeros((out.shape[0], rows_out - out.shape[1], out.shape[2]))
    return torch.cat([out, pad], dim=1)


def gemm_tma_maps(name: str, x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                  resid: Optional[torch.Tensor] = None) -> list:
    """The body's maps: x ``[B, S, K]`` as (column, row, batch) with the row
    extent S (rows past it arrive as zeros), boxes of 64 columns x 128 rows;
    w ``[N, K]`` as (column, row), boxes of 64 x 192 (columns past K arrive
    as zeros in both); out ``[B, rows_out, N]`` as (column, row, batch),
    boxes of 64 x 64 that the stores clip at rows_out and N; and resid
    ``[B, rows_out, N]``, when given, as out. All with the 128-byte
    swizzle."""
    rows, cols, k = GEMM_TILE

    def geometry(label, t, box):
        return tma_map(f"{name}: {label}", tuple(reversed(t.shape)),
                       tuple(reversed(t.stride())), box, 128)

    maps = [geometry("x", x, (k, rows, 1)), geometry("w", w, (k, cols)),
            geometry("out", out, (64, 64, 1))]
    return maps + ([geometry("resid", resid, (64, 64, 1))] if resid is not None else [])


def gemm_launch(name: str, x: torch.Tensor, w: torch.Tensor, bias32: torch.Tensor, *,
                epilogue: str = "bias", resid: Optional[torch.Tensor] = None,
                rows_out: Optional[int] = None, gate: Optional[torch.Tensor] = None,
                rep: int = 1, span: int = 1) -> torch.Tensor:
    """One launch of the body on bf16 CUDA tensors the caller has checked
    (contiguous, widths multiples of 8, bias32 contiguous f32 ``[N]``,
    resid ``[B, rows_out, N]`` with the "resid" epilogue or with a gate).
    With ``gate`` (contiguous f32 rows of N) the epilogue is K8's, gate row
    ``b // rep + s // span`` for output row (b, s), and ``epilogue`` is not
    read. Returns ``[B, rows_out, N]``."""
    b, s, k = x.shape
    n = w.shape[0]
    rows_out = s if rows_out is None else rows_out
    out = torch.empty((b, rows_out, n), dtype=x.dtype, device=x.device)
    lib = load_cuda_library()
    words = map_words(gemm_tma_maps(name, x, w, out, resid))
    r_ptr = resid.data_ptr() if resid is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if gate is not None:
        code = lib.mc_matmul_gated_residual(
            x.data_ptr(), w.data_ptr(), words, out.data_ptr(), bias32.data_ptr(),
            gate.data_ptr(), r_ptr, b, s, rows_out, k, n, rep, span, stream)
    else:
        code = lib.mc_hopper_gemm(
            x.data_ptr(), w.data_ptr(), words, out.data_ptr(), bias32.data_ptr(), r_ptr,
            b, s, rows_out, k, n, EPILOGUES[epilogue], stream)
    check_launch(lib, code, name)
    return out
