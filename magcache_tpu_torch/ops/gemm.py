"""The wgmma/TMA GEMM body (``csrc/hopper_gemm.cuh``) that K7 and K6's two
projections run on: its plain version, its tensor-map geometry and its
launch.

``out = epilogue(x @ w.T)`` with x ``[B, S, K]`` and w an ``nn.Linear``
weight ``[N, K]``, both bf16 and contiguous; the output is ``[B, rows_out,
N]`` with rows ``S..rows_out-1`` of each batch row zeros. Epilogues: bias,
bias + tanh-gelu, bias + residual, each in f32 with one rounding at the
store. K7 (``ops.fused_prologue``) runs it on its LayerNorm-modulated
operand. Nothing here counts launches: the wrappers that call it do.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from magcache_tpu_torch.ops.build import check_launch, load_cuda_library, map_words, tma_map

__all__ = ["linear_plain", "gemm_tma_maps", "gemm_launch", "GEMM_TILE"]

GEMM_TILE = (128, 192, 64)      # rows, columns and k of the body's tiles
EPILOGUES = {"bias": 0, "gelu": 1, "resid": 2}


def linear_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 act: Optional[str] = None, resid: Optional[torch.Tensor] = None,
                 rows_out: Optional[int] = None) -> torch.Tensor:
    """The body's math in plain PyTorch: the f32 product of the rounded
    operands, + bias, then tanh-gelu (``act="gelu"``) or + resid, in f32,
    rounded once to x's dtype; zero rows appended up to ``rows_out``."""
    out = x.float() @ w.float().T
    if bias is not None:
        out = out + bias.float()
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    if resid is not None:
        out = out + resid.float()
    out = out.to(x.dtype)
    rows_out = x.shape[1] if rows_out is None else rows_out
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
    ``[B, S, N]``, when given, as out. All with the 128-byte swizzle."""
    rows, cols, k = GEMM_TILE

    def geometry(label, t, box):
        return tma_map(f"{name}: {label}", tuple(reversed(t.shape)),
                       tuple(reversed(t.stride())), box, 128)

    maps = [geometry("x", x, (k, rows, 1)), geometry("w", w, (k, cols)),
            geometry("out", out, (64, 64, 1))]
    return maps + ([geometry("resid", resid, (64, 64, 1))] if resid is not None else [])


def gemm_launch(name: str, x: torch.Tensor, w: torch.Tensor, bias32: torch.Tensor, *,
                epilogue: str = "bias", resid: Optional[torch.Tensor] = None,
                rows_out: Optional[int] = None) -> torch.Tensor:
    """One launch of the body on bf16 CUDA tensors the caller has checked
    (contiguous, widths multiples of 8, bias32 contiguous f32 ``[N]``,
    resid ``[B, S, N]`` with the "resid" epilogue). Returns ``[B, rows_out,
    N]``."""
    b, s, k = x.shape
    n = w.shape[0]
    rows_out = s if rows_out is None else rows_out
    out = torch.empty((b, rows_out, n), dtype=x.dtype, device=x.device)
    lib = load_cuda_library()
    code = lib.mc_hopper_gemm(
        x.data_ptr(), w.data_ptr(), map_words(gemm_tma_maps(name, x, w, out, resid)),
        out.data_ptr(), bias32.data_ptr(), resid.data_ptr() if resid is not None else None,
        b, s, rows_out, k, n, EPILOGUES[epilogue],
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch(lib, code, name)
    return out
