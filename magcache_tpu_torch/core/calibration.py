"""Calibration mode: per-step magnitude-ratio statistics of trunk residuals.

For each forward index ``cnt >= lanes`` the current trunk residual is
compared with the same lane's previous one:

    ratio_tok  = ||r_t||_dim / ||r_{t-lanes}||_dim          (per token)
    norm_ratio = mean(ratio_tok)        # not the ratio of global norms
    norm_std   = std(ratio_tok)         # unbiased (ddof=1)
    cos_dis    = mean(1 - cos_sim(r_t, r_prev, dim=-1, eps=1e-8))

The recorded ``norm_ratio`` list becomes the ``mag_ratios`` of the skip mode
after ``[1.0] * lanes`` padding.
"""

from __future__ import annotations

import torch

__all__ = ["calibration_stats"]


def calibration_stats(residual: torch.Tensor, prev_residual: torch.Tensor) -> torch.Tensor:
    """(norm_ratio, norm_std, cos_dis) for one residual pair ``[..., tokens,
    dim]``, as an f32[3] tensor on the residual's device."""
    r = residual.float()
    p = prev_residual.float()
    r_norm = torch.linalg.vector_norm(r, dim=-1)
    p_norm = torch.linalg.vector_norm(p, dim=-1)
    ratio_tok = r_norm / p_norm
    norm_ratio = ratio_tok.mean()
    norm_std = ratio_tok.std(correction=1 if ratio_tok.numel() > 1 else 0)
    cos = (r * p).sum(-1) / torch.clamp(r_norm * p_norm, min=1e-8)
    cos_dis = (1.0 - cos).mean()
    return torch.stack([norm_ratio, norm_std, cos_dis])
