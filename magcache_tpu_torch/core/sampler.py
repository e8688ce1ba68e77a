"""Cached denoising loops: MagCache in a Python loop over a host schedule.

Same design as ``magcache_tpu.core.sampler``, in PyTorch's eager idiom:

- A model is three functions (`DiTCore`): ``prepare`` (embeddings),
  ``trunk`` (the transformer blocks, which MagCache elides) and ``head``
  (final layer + unpatchify). The cached residual is ``trunk_out -
  trunk_in`` in hidden's dtype.
- The skip decision is precomputed on the host (`compute_skip_schedule`
  never looks at activations), so each step reads a numpy bit per lane and
  branches in Python: no device-to-host sync decides a skip. A skipped step
  still runs ``prepare``, ``head`` and the solver update.
- CFG runs batched: cond and uncond ride one leading axis of ``2*batch``
  rows. Each lane keeps its own cache slice and skip bit; on a
  lane-asymmetric step only the computing lane's rows go through the trunk
  (half the batch) and its residuals are scattered back into the cache.
- Calibration mode runs the same loop full-compute and stacks per-step
  (norm_ratio, norm_std, cos_dis) statistics per lane on the device, with one
  device-to-host copy at the end.
- UniPC coefficients are computed on the host in f64 and cast to f32 for
  the device update, as the JAX sampler does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.calibration import calibration_stats
from magcache_tpu_torch.core.magcache import MagCacheConfig, compute_skip_schedule
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule

__all__ = ["DiTCore", "unipc_executor", "sample_unipc", "calibrate_unipc"]


@dataclasses.dataclass(frozen=True)
class DiTCore:
    """A DiT denoiser split at the MagCache cache boundary.

    prepare: (x, t, cond) -> (hidden, ctx)   # patch/time/text embed
    trunk:   (hidden, ctx) -> hidden          # the blocks (cacheable)
    head:    (hidden, ctx) -> out             # final layer + unpatchify

    The parameters live in the model the functions close over.
    """

    prepare: Callable[..., Tuple[torch.Tensor, Any]]
    trunk: Callable[..., torch.Tensor]
    head: Callable[..., torch.Tensor]


def _lane_masks(cache_cfg: Optional[MagCacheConfig], num_steps: int):
    """Static per-scheduler-step skip bits ``bool[num_steps, lanes]``; the
    forward index of step i, lane l is ``i*lanes + l``."""
    if cache_cfg is None:
        return np.zeros((num_steps, 1), bool), 1
    sched = compute_skip_schedule(cache_cfg)
    lanes = cache_cfg.lanes
    if cache_cfg.num_steps != num_steps * lanes:
        raise ValueError(f"cache num_steps {cache_cfg.num_steps} != sampler "
                         f"steps {num_steps} * lanes {lanes}")
    return sched.reshape(num_steps, lanes), lanes


def _cfg_combine(out: torch.Tensor, guidance_scale: Optional[float],
                 batch: int) -> torch.Tensor:
    """Dual-lane guidance: ``uncond + g * (cond - uncond)``."""
    if guidance_scale is None:
        return out
    cond, uncond = out[:batch], out[batch:]
    return uncond + guidance_scale * (cond - uncond)


def _gather_rows(ctx: dict, idx: torch.Tensor, rows: int) -> dict:
    """Gather axis-0 rows of every per-row ctx leaf (leading dim == rows);
    other leaves pass through."""
    return {k: (v[idx] if torch.is_tensor(v) and v.ndim >= 1
                and v.shape[0] == rows else v)
            for k, v in ctx.items()}


def _stack_lanes(x: torch.Tensor, lanes: int) -> torch.Tensor:
    return torch.cat([x] * lanes, dim=0) if lanes > 1 else x


def _cached_trunk(core: DiTCore, hidden, ctx, cache, skip_bits: np.ndarray,
                  lane_of_row: np.ndarray, partial_lanes: Optional[int]):
    """One trunk evaluation under the cache policy.

    skip_bits: host ``bool[lanes]``; cache has hidden's shape and dtype.
    Returns ``(hidden_out, new_cache)``.

    With ``partial_lanes`` (cache lanes == stacked lanes > 1) the step
    branches on how many lanes skip: all replay their residuals, none runs
    the full trunk, and in between only the computing lanes' rows (in order)
    go through the trunk and their residuals are scattered into the cache.
    """
    row_skip = skip_bits[lane_of_row]
    if partial_lanes is not None:
        n_skip = int(skip_bits.sum())
        if n_skip == partial_lanes:
            return hidden + cache, cache
        if n_skip == 0:
            h = core.trunk(hidden, ctx)
            return h, h - hidden
        rows = hidden.shape[0]
        # stable: non-skipping rows first, original order kept
        keep = (partial_lanes - n_skip) * (rows // partial_lanes)
        order = np.argsort(row_skip, kind="stable")[:keep]
        idx = torch.as_tensor(order, device=hidden.device)
        h_in = hidden[idx]
        resid_g = core.trunk(h_in, _gather_rows(ctx, idx, rows)) - h_in
        resid_full = cache.clone()
        resid_full[idx] = resid_g.to(cache.dtype)
        return hidden + resid_full, resid_full
    # one cache lane over all rows: they skip together or compute together
    if row_skip.all():
        return hidden + cache, cache
    resid = core.trunk(hidden, ctx) - hidden
    return hidden + resid, resid


def _lane_setup(cache_cfg, num_steps, guidance_scale, lanes, batch):
    """Resolve ``(skip_mask, n_lanes, lane_of_row, partial_lanes)``:
    ``n_lanes`` copies of x are stacked per step; the cache may have fewer
    lanes (one lane over both CFG copies when caching is off)."""
    skip_mask, cache_lanes = _lane_masks(cache_cfg, num_steps)
    if lanes is not None:
        n_lanes = lanes
    elif guidance_scale is not None:
        n_lanes = 2
    else:
        n_lanes = 1
    rows = batch * n_lanes
    if cache_lanes == 1:
        lane_rows = np.zeros(rows, int)
    else:
        if cache_lanes != n_lanes:
            raise ValueError(f"cache lanes {cache_lanes} != sampler lanes {n_lanes}")
        lane_rows = np.arange(rows) // batch
    partial = cache_lanes if cache_lanes == n_lanes and cache_lanes > 1 else None
    return skip_mask, n_lanes, lane_rows, partial


def _f32(a) -> np.ndarray:
    """f64 host coefficients rounded to f32, the device update's precision."""
    return np.asarray(a, np.float64).astype(np.float32)


def unipc_executor(
    core: DiTCore,
    schedule: UniPCSchedule,
    *,
    cache_cfg: Optional[MagCacheConfig] = None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    skip_mask_override: Optional[np.ndarray] = None,
    batch: int = 1,
    calibrate: bool = False,
):
    """The UniPC step machinery. Returns ``(init_carry, step)``:
    ``init_carry(x_init)`` builds the carry and ``step(carry, i, cond)``
    returns ``(carry, emitted)``, where ``emitted`` is the step's realized
    skip bits ``bool[lanes]``, or its calibration stats ``f32[lanes, 3]``
    (a device tensor) when ``calibrate``.

    ``skip_mask_override`` (``bool[num_steps, lanes]``) replaces the schedule
    that ``cache_cfg`` would give; ``calibrate=True`` disables the cache.
    """
    if calibrate:
        cache_cfg = None
        skip_mask_override = None
    n = schedule.num_steps
    hist = max(2, schedule.order)
    skip_mask, n_lanes, lane_of_row, partial_lanes = _lane_setup(
        cache_cfg, n, guidance_scale, lanes, batch)
    if skip_mask_override is not None:
        skip_mask = np.asarray(skip_mask_override, bool).reshape(skip_mask.shape)

    # host-precomputed per-step coefficient tables, padded to fixed width
    p_cx, p_cm0, p_w = np.zeros(n), np.zeros(n), np.zeros((n, hist))
    c_cx, c_cm0, c_w, c_wt = np.zeros(n), np.zeros(n), np.zeros((n, hist)), np.zeros(n)
    use_corr = np.zeros(n, bool)
    for i in range(n):
        cx, cm0, w, offs = schedule.predictor_coeffs(i)
        p_cx[i], p_cm0[i] = cx, cm0
        for l, wl in zip(offs, w):
            p_w[i, l - 1] = wl
        if schedule.corrector_ok(i):
            cx, cm0, w, offs, wt = schedule.corrector_coeffs(i)
            c_cx[i], c_cm0[i], c_wt[i] = cx, cm0, wt
            for l, wl in zip(offs, w):
                c_w[i, l - 1] = wl
            use_corr[i] = True
    p_cx, p_cm0, p_w = _f32(p_cx), _f32(p_cm0), _f32(p_w)
    c_cx, c_cm0, c_w, c_wt = _f32(c_cx), _f32(c_cm0), _f32(c_w), _f32(c_wt)
    ts = np.asarray(schedule.timesteps, np.float32)
    sig = np.asarray(schedule.sigmas[:-1], np.float32)

    def init_carry(x_init):
        m_hist = [torch.zeros_like(x_init)] * hist
        return (x_init, x_init, m_hist, None)

    def step(carry, i, cond):
        x_pred, x_prev, m_hist, cache = carry
        x2 = _stack_lanes(x_pred, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32,
                          device=x2.device)
        hidden, ctx = core.prepare(x2, tvec, cond)
        if cache is None:
            cache = torch.zeros_like(hidden)
        if calibrate:
            h_out = core.trunk(hidden, ctx)
            resid = h_out - hidden
            rpl = hidden.shape[0] // n_lanes
            emitted = torch.stack([
                calibration_stats(resid[l * rpl:(l + 1) * rpl],
                                  cache[l * rpl:(l + 1) * rpl])
                for l in range(n_lanes)])
            cache = resid
        else:
            emitted = skip_mask[i]
            h_out, cache = _cached_trunk(core, hidden, ctx, cache, emitted,
                                         lane_of_row, partial_lanes)
        out = core.head(h_out, ctx)
        v = _cfg_combine(out, guidance_scale, batch)
        m = x_pred - float(sig[i]) * v.to(x_pred.dtype)

        # corrector of the previous step with this step's model output:
        # m_hist[0] = m_{i-1}, m_hist[l] = m_{i-1-l}
        if use_corr[i]:
            x_cur = (float(c_cx[i]) * x_prev + float(c_cm0[i]) * m_hist[0]
                     + float(c_wt[i]) * m)
            for l in range(hist - 1):
                x_cur = x_cur + float(c_w[i, l]) * m_hist[l + 1]
        else:
            x_cur = x_pred
        # predictor for the next sample: m_hist[l-1] = m_{i-l}
        x_next = float(p_cx[i]) * x_cur + float(p_cm0[i]) * m
        for l in range(hist):
            x_next = x_next + float(p_w[i, l]) * m_hist[l]
        m_hist = [m] + m_hist[:-1]
        return (x_next, x_cur, m_hist, cache), emitted

    return init_carry, step


@torch.inference_mode()
def calibrate_unipc(core: DiTCore, x_init: torch.Tensor, cond, schedule: UniPCSchedule,
                    *, lanes: int = 1, guidance_scale: Optional[float] = None):
    """Full-compute UniPC run that records calibration statistics on the
    generation trajectory. Returns ``(x_final, stats f64[num_steps-1, lanes,
    3])``: step i compares with step i-1's residual of the same lane."""
    init_carry, step = unipc_executor(
        core, schedule, guidance_scale=guidance_scale,
        lanes=lanes if lanes > 1 else None, batch=x_init.shape[0],
        calibrate=True)
    carry = init_carry(x_init)
    stats = []
    for i in range(schedule.num_steps):
        carry, st = step(carry, i, cond)
        stats.append(st)
    stats = torch.stack(stats[1:]).double().cpu().numpy()  # step 0 has no predecessor
    return carry[0], stats


@torch.inference_mode()
def sample_unipc(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    schedule: UniPCSchedule,
    *,
    cache_cfg: Optional[MagCacheConfig] = None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    skip_mask_override: Optional[np.ndarray] = None,
    return_skips: bool = False,
):
    """UniPC predictor-corrector flow sampler with MagCache.

    ``cond`` is lane-stacked ([cond; uncond] on axis 0) when
    ``guidance_scale`` is set. ``return_skips=True`` also returns the
    realized skip bits ``bool[num_steps, lanes]``. After the final step the
    predictor's output for sigma = 0 is the sample.
    """
    init_carry, step = unipc_executor(
        core, schedule, cache_cfg=cache_cfg, guidance_scale=guidance_scale,
        lanes=lanes, skip_mask_override=skip_mask_override,
        batch=x_init.shape[0])
    carry = init_carry(x_init)
    skips = []
    for i in range(schedule.num_steps):
        carry, bits = step(carry, i, cond)
        skips.append(bits)
    if return_skips:
        return carry[0], np.stack(skips)
    return carry[0]
