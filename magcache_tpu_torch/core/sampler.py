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
- Sequence and tensor parallelism need nothing of the loop: under a
  ``plan`` a core's ``prepare`` returns the rank's token shard (whole over
  tp), so the residual cache holds that shard only, and its ``head``
  returns the whole output on every rank.
  The skip bits come from the static schedule, or from TeaCache's signal
  (the time embedding, whole on every rank), and are the same on every
  rank. Only calibration uses the plan (``plan=``), to all-reduce its token
  means.
- Under a plan with ``dp = 2`` (``plan=``) the two CFG lanes ride dp, as
  the JAX package's lane-stacked batch rides its ``dp`` axis: dp rank d
  runs only lane d's rows (its rows of ``cond``, its skip bit, its own
  cache; the lane's TeaCache decision from its own signal), the head's
  output is all-gathered over dp before the guidance combine, and the
  realized skip bits and calibration statistics are gathered likewise, so
  every rank returns what one rank would. Other dp sizes raise: the batch
  has two CFG rows. A caller whose dp ranks each hold whole batch rows
  (``generate_batch``) passes ``plan.without_dp()``.
- ``sample_euler`` is the linear-update loop ``x <- cx_i * x + dt_i * v``
  (RFLOW's Euler step, and DDIM-eps with ``x_coeffs``); Open-Sora and Latte
  run it with a joint CFG batch of 2 rows under one cache lane and an
  N-branch ``combine_fn``. ``sample_rflow_masked`` is its masked-frame
  variant (references, edit ratios, looped extension): the per-frame mask
  logic is host numpy, so it costs no device-to-host sync either.
- A core may carry trunk state across steps (``DiTCore.init_state``; PAB's
  per-block output caches): its trunk is then ``trunk(hidden, ctx, state,
  step_idx) -> (hidden, state)``, a skipped step passes the state through,
  and a stateful trunk never takes the half-batch branch (its lanes compute
  together and the skipping lane keeps its cached residual).
- ``dynamic_skip`` (TeaCache's ``TeaCacheLanes``) decides each lane's skip
  from the step's ``prepare`` outputs: the static mask then carries the
  policy's forced-compute window, and each step reads one small host copy
  of the per-lane accumulators (the only activation-dependent decision).
- ``sample_euler(dpm_coeffs=)`` is DPM-Solver++(2M) on the flow sigmas
  (Wan's dpm++), with the previous data prediction carried; ``post_step``
  maps the sample after every update on both samplers.
- Euler-Ancestral (Open-Sora-Plan v1.2) is ``sample_euler`` with
  ``in_scales`` (the model input's scaling) and ``noise_scales`` with a
  ``noise_fn(step, shape)`` noise source, as ``sample_rflow_masked`` takes
  its re-noise draws. ``sample_pndm`` (Open-Sora-Plan v1.1's PLMS) and
  ``sample_dpm_cogvideo`` (CogVideoX's DPM-Solver++ 2M) are linear
  multistep loops over host coefficient tables. A two-argument
  ``combine_fn(chunks, step_idx)`` gets the step index in every sampler
  that takes one (CogVideoX's dynamic CFG).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.calibration import calibration_stats
from magcache_tpu_torch.core.magcache import MagCacheConfig, compute_skip_schedule
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule

__all__ = ["DiTCore", "unipc_executor", "sample_unipc", "calibrate_unipc",
           "sample_euler", "sample_rflow_masked", "sample_pndm", "sample_dpm_cogvideo",
           "lane_skip_masks"]


@dataclasses.dataclass(frozen=True)
class DiTCore:
    """A DiT denoiser split at the MagCache cache boundary.

    prepare: (x, t, cond) -> (hidden, ctx)   # patch/time/text embed
    trunk:   (hidden, ctx) -> hidden          # the blocks (cacheable)
    head:    (hidden, ctx) -> out             # final layer + unpatchify

    With ``init_state`` (``(hidden, ctx) -> state``, built from the first
    step's prepare outputs) the trunk carries state across steps:
    ``trunk(hidden, ctx, state, step_idx) -> (hidden, state)``, where
    ``step_idx = -1`` asks for full compute. The parameters live in the
    model the functions close over.
    """

    prepare: Callable[..., Tuple[torch.Tensor, Any]]
    trunk: Callable[..., Any]
    head: Callable[..., torch.Tensor]
    init_state: Optional[Callable[..., Any]] = None


def lane_skip_masks(cache_cfg, num_steps: int):
    """Static per-scheduler-step skip bits ``bool[num_steps, lanes]``; the
    forward index of step i, lane l is ``i*lanes + l``. ``cache_cfg`` is a
    ``MagCacheConfig``, or any config with ``lanes``, ``num_steps`` and its
    own ``skip_schedule()`` (``core.rolling.RollingCacheConfig``)."""
    if cache_cfg is None:
        return np.zeros((num_steps, 1), bool), 1
    if hasattr(cache_cfg, "skip_schedule"):
        sched = np.asarray(cache_cfg.skip_schedule(), bool)
    else:
        sched = compute_skip_schedule(cache_cfg)
    lanes = cache_cfg.lanes
    if cache_cfg.num_steps != num_steps * lanes:
        raise ValueError(f"cache num_steps {cache_cfg.num_steps} != sampler "
                         f"steps {num_steps} * lanes {lanes}")
    return sched.reshape(num_steps, lanes), lanes


def _cfg_combine(out: torch.Tensor, guidance_scale: Optional[float],
                 batch: int, combine_fn: Optional[Callable] = None,
                 n_lanes: int = 1, step_idx: Optional[int] = None) -> torch.Tensor:
    """Combine the lanes of the head's output. ``combine_fn(chunks) -> v``
    takes the per-lane slices (N-branch guidance); one that takes two
    arguments, ``combine_fn(chunks, step_idx)``, also gets the step index
    (step-dependent guidance such as CogVideoX's dynamic CFG). Without it,
    dual-lane guidance ``uncond + g * (cond - uncond)``, or the output
    itself without ``guidance_scale``."""
    if combine_fn is not None:
        chunks = [out[l * batch:(l + 1) * batch] for l in range(n_lanes)]
        if step_idx is not None and len(inspect.signature(combine_fn).parameters) >= 2:
            return combine_fn(chunks, step_idx)
        return combine_fn(chunks)
    if guidance_scale is None:
        return out
    cond, uncond = out[:batch], out[batch:]
    return uncond + guidance_scale * (cond - uncond)


class _DpLanes:
    """The CFG lanes over dp: this rank's ``lane`` of ``n_lanes`` (one a dp
    rank), each of ``batch`` rows."""

    def __init__(self, plan, n_lanes: int, batch: int):
        if n_lanes != plan.dp:
            raise ValueError(
                f"dp = {plan.dp}: the sampler puts one CFG lane on each dp rank and this "
                f"batch has {n_lanes} (the cond and the uncond rows); run it at dp "
                f"{n_lanes} or 1")
        self.plan, self.lane, self.batch, self.n_lanes = plan, plan.dp_rank, batch, n_lanes

    def cond(self, cond: dict) -> dict:
        """This lane's rows of every lane-stacked leaf of ``cond``."""
        rows = self.batch * self.n_lanes
        return {k: (v.narrow(0, self.lane * self.batch, self.batch)
                    if torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == rows else v)
                for k, v in cond.items()}

    def bits(self, bits: np.ndarray) -> np.ndarray:
        return np.asarray(bits, bool)[self.lane:self.lane + 1]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every lane's ``t``, stacked on axis 0 in lane order."""
        return self.plan.dp_group.all_gather(t, 0)

    def gather_bits(self, bits: np.ndarray, device) -> np.ndarray:
        t = torch.as_tensor(np.asarray(bits, np.int32), device=device)
        return self.gather(t).cpu().numpy().astype(bool)


def _dp_lanes(plan, n_lanes: int, batch: int) -> Optional[_DpLanes]:
    if plan is None or plan.dp == 1:
        return None
    return _DpLanes(plan, n_lanes, batch)


def _decide_lanes(dpl: Optional[_DpLanes], dynamic_skip, hidden, ctx, dstate,
                  bits: np.ndarray):
    """``(emitted, local, dstate)``: the step's skip bits over every lane,
    those of the lanes this rank runs, and the dynamic policy's new state
    (``_decide``; under dp lanes the rank decides its own lane and the bits
    are gathered)."""
    if dpl is None:
        bits, dstate = _decide(dynamic_skip, hidden, ctx, dstate, bits)
        return bits, bits, dstate
    local, dstate = _decide(dynamic_skip, hidden, ctx, dstate, dpl.bits(bits))
    if dynamic_skip is None:
        return np.asarray(bits, bool), local, dstate
    return dpl.gather_bits(local, hidden.device), local, dstate


def _gather_rows(ctx: dict, idx: torch.Tensor, rows: int) -> dict:
    """Gather axis-0 rows of every per-row ctx leaf (leading dim == rows);
    other leaves pass through."""
    return {k: (v[idx] if torch.is_tensor(v) and v.ndim >= 1
                and v.shape[0] == rows else v)
            for k, v in ctx.items()}


def _stack_lanes(x: torch.Tensor, lanes: int) -> torch.Tensor:
    return torch.cat([x] * lanes, dim=0) if lanes > 1 else x


def _run_trunk(core: DiTCore, hidden, ctx, state, step_idx: int):
    if core.init_state is None:
        return core.trunk(hidden, ctx), state
    return core.trunk(hidden, ctx, state, step_idx)


def _cached_trunk(core: DiTCore, hidden, ctx, cache, skip_bits: np.ndarray,
                  lane_of_row: np.ndarray, partial_lanes: Optional[int],
                  state=None, step_idx: int = -1):
    """One trunk evaluation under the cache policy.

    skip_bits: host ``bool[lanes]``; cache has hidden's shape and dtype.
    Returns ``(hidden_out, new_cache, new_state)``; a step that skips every
    lane passes ``state`` through.

    With ``partial_lanes`` (cache lanes == stacked lanes > 1) and a
    stateless trunk the step branches on how many lanes skip: all replay
    their residuals, none runs the full trunk, and in between only the
    computing lanes' rows (in order) go through the trunk and their
    residuals are scattered into the cache. A stateful trunk runs all rows
    whenever a lane computes, and the skipping rows keep their cache.
    """
    row_skip = skip_bits[lane_of_row]
    if partial_lanes is not None and core.init_state is None:
        n_skip = int(skip_bits.sum())
        if n_skip == partial_lanes:
            return hidden + cache, cache, state
        if n_skip == 0:
            h = core.trunk(hidden, ctx)
            return h, h - hidden, state
        rows = hidden.shape[0]
        # stable: non-skipping rows first, original order kept
        keep = (partial_lanes - n_skip) * (rows // partial_lanes)
        order = np.argsort(row_skip, kind="stable")[:keep]
        idx = torch.as_tensor(order, device=hidden.device)
        h_in = hidden[idx]
        resid_g = core.trunk(h_in, _gather_rows(ctx, idx, rows)) - h_in
        resid_full = cache.clone()
        resid_full[idx] = resid_g.to(cache.dtype)
        return hidden + resid_full, resid_full, state
    if row_skip.all():
        return hidden + cache, cache, state
    h, state = _run_trunk(core, hidden, ctx, state, step_idx)
    resid = h - hidden
    if row_skip.any():
        keep = torch.as_tensor(row_skip, device=hidden.device)
        resid = torch.where(keep.reshape((-1,) + (1,) * (hidden.ndim - 1)), cache, resid)
    return hidden + resid, resid, state


def _lane_setup(cache_cfg, num_steps, guidance_scale, lanes, batch,
                combine_fn=None):
    """Resolve ``(skip_mask, n_lanes, lane_of_row, partial_lanes)``:
    ``n_lanes`` copies of x are stacked per step; the cache may have fewer
    lanes (one lane over both CFG copies when caching is off, or Open-Sora's
    single lane over its joint CFG batch)."""
    skip_mask, cache_lanes = lane_skip_masks(cache_cfg, num_steps)
    if lanes is not None:
        n_lanes = lanes
    elif combine_fn is not None:
        n_lanes = max(cache_lanes, 1)
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


def _dynamic_setup(dynamic_skip, core: DiTCore, n_lanes: int, batch: int,
                   num_steps: int):
    """``(forced_mask, lane_of_row, partial_lanes)`` of a dynamic policy: the
    static mask slot carries its forced-compute window, each lane owns its
    rows, and lane-asymmetric steps run the half-batch trunk."""
    if core.init_state is not None:
        raise ValueError("a dynamic skip policy needs a stateless trunk")
    if dynamic_skip.lanes != n_lanes:
        raise ValueError(f"dynamic_skip lanes {dynamic_skip.lanes} != sampler "
                         f"lanes {n_lanes}")
    return (np.asarray(dynamic_skip.forced_mask(num_steps), bool),
            np.arange(batch * n_lanes) // batch, n_lanes if n_lanes > 1 else None)


def _decide(dynamic_skip, hidden, ctx, dstate, bits):
    """The step's skip bits: the static ones, or the dynamic policy's
    decision (and its new state) given the forced bits."""
    if dynamic_skip is None:
        return bits, dstate
    if dstate is None:
        dstate = dynamic_skip.init_state(dynamic_skip.signal_fn(hidden, ctx))
    return dynamic_skip.decide(hidden, ctx, dstate, bits)


def unipc_executor(
    core: DiTCore,
    schedule: UniPCSchedule,
    *,
    cache_cfg=None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    skip_mask_override: Optional[np.ndarray] = None,
    batch: int = 1,
    calibrate: bool = False,
    plan=None,
    dynamic_skip=None,
    post_step: Optional[Callable] = None,
):
    """The UniPC step machinery. Returns ``(init_carry, step)``:
    ``init_carry(x_init)`` builds the carry and ``step(carry, i, cond)``
    returns ``(carry, emitted)``, where ``emitted`` is the step's realized
    skip bits ``bool[lanes]``, or its calibration stats ``f32[lanes, 3]``
    (a device tensor) when ``calibrate``.

    ``skip_mask_override`` (``bool[num_steps, lanes]``) replaces the schedule
    that ``cache_cfg`` would give; ``calibrate=True`` disables the cache.
    ``plan``: the plan the core was made with, for the calibration
    statistics (means over all sp ranks' tokens) and, at ``dp = 2``, the
    CFG lanes over dp (one a rank; see the module docstring).

    ``dynamic_skip`` (``core.teacache.TeaCacheLanes``): an activation-gated
    per-lane policy in place of ``cache_cfg``; the step then decides its
    bits from ``prepare``'s outputs. ``post_step`` (``x -> x``) maps both
    the corrected and the predicted sample after every step.
    """
    if calibrate:
        cache_cfg = None
        skip_mask_override = None
        if dynamic_skip is not None or core.init_state is not None:
            raise ValueError("calibration runs full compute on a stateless trunk")
    n = schedule.num_steps
    hist = max(2, schedule.order)
    skip_mask, n_lanes, lane_of_row, partial_lanes = _lane_setup(
        cache_cfg, n, guidance_scale, lanes, batch)
    if skip_mask_override is not None:
        skip_mask = np.asarray(skip_mask_override, bool).reshape(skip_mask.shape)
    if dynamic_skip is not None:
        if cache_cfg is not None or skip_mask_override is not None:
            raise ValueError("dynamic_skip replaces cache_cfg and skip_mask_override")
        skip_mask, lane_of_row, partial_lanes = _dynamic_setup(
            dynamic_skip, core, n_lanes, batch, n)
    dpl = _dp_lanes(plan, n_lanes, batch)
    if dpl is not None:         # this rank's lane: its own rows, one cache lane
        lane_of_row, partial_lanes = np.zeros(batch, int), None
        if dynamic_skip is not None:
            dynamic_skip = dataclasses.replace(dynamic_skip, lanes=1)

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
        # (x_pred, x_prev, m_hist, cache, trunk state, dynamic policy state)
        return (x_init, x_init, m_hist, None, None, None)

    def step(carry, i, cond):
        x_pred, x_prev, m_hist, cache, state, dstate = carry
        x2 = x_pred if dpl is not None else _stack_lanes(x_pred, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32,
                          device=x2.device)
        hidden, ctx = core.prepare(x2, tvec, cond if dpl is None else dpl.cond(cond))
        if cache is None:
            cache = torch.zeros_like(hidden)
        if state is None and core.init_state is not None:
            state = core.init_state(hidden, ctx)
        if calibrate:
            h_out = core.trunk(hidden, ctx)
            resid = h_out - hidden
            if dpl is not None:
                emitted = dpl.gather(calibration_stats(resid, cache, plan)[None])
            else:
                rpl = hidden.shape[0] // n_lanes
                emitted = torch.stack([
                    calibration_stats(resid[l * rpl:(l + 1) * rpl],
                                      cache[l * rpl:(l + 1) * rpl], plan)
                    for l in range(n_lanes)])
            cache = resid
        else:
            emitted, local, dstate = _decide_lanes(dpl, dynamic_skip, hidden, ctx, dstate,
                                                   skip_mask[i])
            h_out, cache, state = _cached_trunk(core, hidden, ctx, cache, local,
                                                lane_of_row, partial_lanes, state, i)
        out = core.head(h_out, ctx)
        if dpl is not None:
            out = dpl.gather(out)
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
        if post_step is not None:
            x_cur, x_next = post_step(x_cur), post_step(x_next)
        m_hist = [m] + m_hist[:-1]
        return (x_next, x_cur, m_hist, cache, state, dstate), emitted

    return init_carry, step


@torch.inference_mode()
def calibrate_unipc(core: DiTCore, x_init: torch.Tensor, cond, schedule: UniPCSchedule,
                    *, lanes: int = 1, guidance_scale: Optional[float] = None,
                    plan=None):
    """Full-compute UniPC run that records calibration statistics on the
    generation trajectory. Returns ``(x_final, stats f64[num_steps-1, lanes,
    3])``: step i compares with step i-1's residual of the same lane. Pass
    the ``plan`` a sequence-parallel core was made with."""
    init_carry, step = unipc_executor(
        core, schedule, guidance_scale=guidance_scale,
        lanes=lanes if lanes > 1 else None, batch=x_init.shape[0],
        calibrate=True, plan=plan)
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
    cache_cfg=None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    skip_mask_override: Optional[np.ndarray] = None,
    dynamic_skip=None,
    return_skips: bool = False,
    post_step: Optional[Callable] = None,
    plan=None,
):
    """UniPC predictor-corrector flow sampler with MagCache (or the dynamic
    policy ``dynamic_skip``).

    ``cond`` is lane-stacked ([cond; uncond] on axis 0) when
    ``guidance_scale`` is set. ``return_skips=True`` also returns the
    realized skip bits ``bool[num_steps, lanes]``. After the final step the
    predictor's output for sigma = 0 is the sample. ``plan``: the plan the
    core was made with (the loop needs it for the CFG lanes over dp).
    """
    init_carry, step = unipc_executor(
        core, schedule, cache_cfg=cache_cfg, guidance_scale=guidance_scale,
        lanes=lanes, skip_mask_override=skip_mask_override,
        batch=x_init.shape[0], dynamic_skip=dynamic_skip, post_step=post_step,
        plan=plan)
    carry = init_carry(x_init)
    skips = []
    for i in range(schedule.num_steps):
        carry, bits = step(carry, i, cond)
        skips.append(bits)
    if return_skips:
        return carry[0], np.stack(skips)
    return carry[0]


_DPM_KEYS = ("sigma_t", "a", "b", "c_x", "c_d")


@torch.inference_mode()
def sample_euler(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    *,
    timesteps: np.ndarray,
    dts: np.ndarray,
    cache_cfg=None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    combine_fn: Optional[Callable] = None,
    skip_mask_override: Optional[np.ndarray] = None,
    x_coeffs: Optional[np.ndarray] = None,
    in_scales: Optional[np.ndarray] = None,
    noise_scales: Optional[np.ndarray] = None,
    noise_fn: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
    noise_key=None,
    dynamic_skip=None,
    dpm_coeffs=None,
    return_skips: bool = False,
    post_step: Optional[Callable] = None,
    calibrate: bool = False,
    calibrate_lanes: Optional[int] = None,
    prev_residual: Optional[torch.Tensor] = None,
    return_residual: bool = False,
    plan=None,
):
    """Linear-update sampler ``x <- cx_i * x + dt_i * v [+ ns_i * z_i]`` with
    MagCache (the JAX ``magcache_tpu.core.sampler.sample_euler``).

    ``cond`` is lane-stacked on axis 0 when CFG is on: ``guidance_scale``
    combines two lanes as ``uncond + g * (cond - uncond)``, ``combine_fn
    (chunks) -> v`` takes the per-lane slices of the head's output, and
    ``combine_fn(chunks, step_idx)`` also the step index (without either,
    the output is v). ``dts`` is the per-step multiplier of v
    (sigma deltas for flow matching, t-deltas / T for RFLOW, DDIM's eps
    coefficient) and ``x_coeffs`` that of x (default 1; DDIM's ``c_x``).
    ``skip_mask_override``
    (``bool[num_steps, lanes]``) replaces the schedule; ``return_skips``
    also returns the realized skip bits.

    ``dpm_coeffs`` (``schedulers.dpm_flow.dpmpp_2m_flow_coeffs``) switches
    the update to DPM-Solver++(2M): ``x0 = x - sigma_t * v``, ``x <- c_x * x
    + c_d * (a * x0 + b * x0_prev)``, the previous x0 carried (``dts`` is
    then unused). ``dynamic_skip`` and ``post_step`` as in
    ``unipc_executor``.

    ``calibrate=True`` runs full compute and returns ``(x, stats f64
    [num_steps-1, calibrate_lanes, 3])``, each step's residual against the
    previous step's; ``calibrate_lanes`` (default: the stacked lanes) is the
    cache's lane count, 1 for a joint CFG batch. ``prev_residual`` seeds
    step 0's predecessor residual (FramePack's sections carry the previous
    section's last residual, so the calibration records one continuous run
    of ratios across sections); stats then have ``num_steps`` rows.
    ``return_residual`` also returns the run's last residual, ``(x, stats,
    residual)``. Pass the ``plan`` a parallel core was made with: the
    statistics' token means then run over every sp rank's tokens, and at
    ``dp = 2`` the CFG lanes ride dp (see the module docstring).

    Euler-Ancestral (``schedulers.euler_ancestral``): ``in_scales`` scales
    the model's input only (``x_model = in_i * x``), and ``noise_scales``
    adds ``ns_i * noise_fn(i, x.shape)`` after each update. ``noise_fn`` is
    the noise source (a seeded CPU generator's draws in the pipelines, given
    draws in a test) and must return ``x``'s shape on any device; it is
    called at every step. The JAX ``noise_key`` has no counterpart and
    raises.
    """
    if noise_key is not None:
        raise NotImplementedError("sample_euler: noise_key is the JAX noise source; "
                                  "pass noise_fn(step, shape) -> Tensor")
    num_steps = len(timesteps)
    batch = x_init.shape[0]
    if calibrate and (cache_cfg is not None or skip_mask_override is not None
                      or return_skips or dynamic_skip is not None):
        raise ValueError("calibrate is a full-compute recording mode")
    if not calibrate and (prev_residual is not None or return_residual):
        raise ValueError("prev_residual and return_residual belong to calibrate")
    if dpm_coeffs is not None and (x_coeffs is not None or in_scales is not None
                                   or noise_scales is not None):
        raise ValueError("dpm_coeffs replaces the linear-update coefficients "
                         "(x_coeffs, in_scales, noise_scales)")
    if (noise_scales is None) != (noise_fn is None):
        raise ValueError("noise_scales and noise_fn come together (ancestral noise)")
    skip_mask, n_lanes, lane_of_row, partial_lanes = _lane_setup(
        cache_cfg, num_steps, guidance_scale, lanes, batch, combine_fn)
    if skip_mask_override is not None:
        skip_mask = np.asarray(skip_mask_override, bool).reshape(skip_mask.shape)
    if dynamic_skip is not None:
        if cache_cfg is not None or skip_mask_override is not None:
            raise ValueError("dynamic_skip replaces cache_cfg and skip_mask_override")
        skip_mask, lane_of_row, partial_lanes = _dynamic_setup(
            dynamic_skip, core, n_lanes, batch, num_steps)
    dpl = _dp_lanes(plan, n_lanes, batch)
    if dpl is not None:         # this rank's lane: its own rows, one cache lane
        if combine_fn is not None or calibrate_lanes not in (None, n_lanes):
            raise ValueError("the CFG lanes over dp take the two-lane guidance combine")
        lane_of_row, partial_lanes = np.zeros(batch, int), None
        if dynamic_skip is not None:
            dynamic_skip = dataclasses.replace(dynamic_skip, lanes=1)
    ts = np.asarray(timesteps, np.float32)
    dts = np.asarray(dts, np.float32)
    cxs = None if x_coeffs is None else np.asarray(x_coeffs, np.float32)
    cins = None if in_scales is None else np.asarray(in_scales, np.float32)
    nss = None if noise_scales is None else np.asarray(noise_scales, np.float32)
    dpm = (None if dpm_coeffs is None else
           {k: np.asarray(dpm_coeffs[k], np.float32) for k in _DPM_KEYS})
    cal_lanes = calibrate_lanes or n_lanes

    x = x_init
    x0_prev = torch.zeros_like(x_init) if dpm is not None else None
    cache, state, dstate = prev_residual, None, None
    skips, stats = [], []
    for i in range(num_steps):
        xi = x if cins is None else float(cins[i]) * x
        x2 = xi if dpl is not None else _stack_lanes(xi, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32,
                          device=x2.device)
        hidden, ctx = core.prepare(x2, tvec, cond if dpl is None else dpl.cond(cond))
        if cache is None:
            cache = torch.zeros_like(hidden)
        if state is None and core.init_state is not None:
            state = core.init_state(hidden, ctx)
        cache_prev = cache
        bits, local, dstate = _decide_lanes(dpl, dynamic_skip, hidden, ctx, dstate,
                                            skip_mask[i])
        h_out, cache, state = _cached_trunk(core, hidden, ctx, cache, local,
                                            lane_of_row, partial_lanes, state, i)
        out = core.head(h_out, ctx)
        if dpl is not None:
            out = dpl.gather(out)
        v = _cfg_combine(out, guidance_scale, batch, combine_fn, n_lanes, i)
        if dpm is not None:
            sg, av, bv, cxd, cdd = (float(dpm[k][i]) for k in _DPM_KEYS)
            x0 = x - sg * v.to(x.dtype)
            x = cxd * x + cdd * (av * x0 + bv * x0_prev)
            x0_prev = x0
        else:
            if cxs is not None:
                x = float(cxs[i]) * x
            x = x + float(dts[i]) * v.to(x.dtype)
        if nss is not None:
            z = noise_fn(i, tuple(x.shape)).to(device=x.device, dtype=x.dtype)
            x = x + float(nss[i]) * z
        if post_step is not None:
            x = post_step(x)
        if calibrate and dpl is not None:
            stats.append(dpl.gather(calibration_stats(cache, cache_prev, plan)[None]))
        elif calibrate:
            rpl = x2.shape[0] // cal_lanes
            stats.append(torch.stack([
                calibration_stats(cache[l * rpl:(l + 1) * rpl],
                                  cache_prev[l * rpl:(l + 1) * rpl], plan)
                for l in range(cal_lanes)]))
        skips.append(bits)
    if calibrate:
        kept = stats if prev_residual is not None else stats[1:]
        stats = torch.stack(kept).double().cpu().numpy()
        return (x, stats, cache) if return_residual else (x, stats)
    if return_skips:
        return x, np.stack(skips)
    return x


@torch.inference_mode()
def sample_rflow_masked(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    *,
    timesteps: np.ndarray,
    dts: np.ndarray,
    num_train_timesteps: int,
    mask: np.ndarray,
    noise_fn: Callable[[int, Tuple[int, ...]], torch.Tensor],
    lanes: int = 2,
    combine_fn: Optional[Callable] = None,
    cache_cfg: Optional[MagCacheConfig] = None,
    return_skips: bool = False,
):
    """RFLOW Euler sampling with Open-Sora's masked-frame conditioning (the
    JAX ``sample_rflow_masked``; reference ``scheduling_rflow_open_sora.py:
    215-255``).

    ``x_init`` ``[B, T, H, W, C]`` has the references pasted in; ``mask``
    (host ``f32[B, T]``) is 0 for a frozen condition frame, in (0, 1) for an
    edit ratio, 1 for a freely generated frame. At step i a frame is active
    when ``mask * num_train_timesteps >= t_i``; on its first active step it
    is re-noised to the current level with ``noise_fn(i, x.shape)`` (frames
    with mask 1 count as noised from the start, so a mask of only 0 and 1
    never draws), the model sees the active frames under the step's
    modulation and the others under t = 0 (``cond["x_mask"]``), and after
    the Euler update inactive frames revert to their latents before it.
    ``noise_fn`` is the noise source (a seeded generator's draws, or given
    draws in a test); it must return ``x``'s shape on any device.

    MagCache runs its single cache lane over the joint CFG batch (the
    Open-Sora configuration); a cache with more lanes raises.
    """
    num_steps = len(timesteps)
    batch = x_init.shape[0]
    skip_mask, n_lanes, lane_of_row, _ = _lane_setup(
        cache_cfg, num_steps, None, lanes, batch, combine_fn)
    if skip_mask.shape[1] != 1:
        raise ValueError("sample_rflow_masked runs one cache lane over the joint "
                         f"CFG batch; the cache has {skip_mask.shape[1]} lanes")
    ts = np.asarray(timesteps, np.float32)
    dts = np.asarray(dts, np.float32)
    mask = np.asarray(mask, np.float32)
    scaled = mask * np.float32(num_train_timesteps)
    noise_added = mask >= 1.0
    dev = x_init.device

    x = x_init
    cache = state = None
    skips = []
    for i in range(num_steps):
        x0 = x
        upper = scaled >= ts[i]                          # host bool[B, T]
        add = upper & ~noise_added
        xm = x0
        if add.any():
            tp = np.float32(1.0) - ts[i] / np.float32(num_train_timesteps)
            noise = noise_fn(i, tuple(x.shape)).to(device=dev, dtype=x.dtype)
            x_noise = float(tp) * x0 + float(np.float32(1.0) - tp) * noise
            sel = torch.as_tensor(add, device=dev)[:, :, None, None, None]
            xm = torch.where(sel, x_noise, x0)
        noise_added = upper
        active = torch.as_tensor(upper, device=dev)
        x2 = _stack_lanes(xm, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32,
                          device=dev)
        hidden, ctx = core.prepare(x2, tvec,
                                   dict(cond, x_mask=_stack_lanes(active, n_lanes)))
        if cache is None:
            cache = torch.zeros_like(hidden)
        if state is None and core.init_state is not None:
            state = core.init_state(hidden, ctx)
        h_out, cache, state = _cached_trunk(core, hidden, ctx, cache, skip_mask[i],
                                            lane_of_row, None, state, i)
        out = core.head(h_out, ctx)
        v = _cfg_combine(out, None, batch, combine_fn, n_lanes, i)
        x = xm + float(dts[i]) * v.to(x.dtype)
        x = torch.where(active[:, :, None, None, None], x, x0)
        skips.append(skip_mask[i])
    if return_skips:
        return x, np.stack(skips)
    return x


def _model_call(core: DiTCore, x, i: int, t: float, cond, carry, skip_bits,
                   lane_of_row, partial_lanes, n_lanes: int):
    """One model call of a linear multistep sampler: prepare on the lanes
    stacked from ``x``, the cached trunk and the head. ``carry`` is
    ``(cache, state)``, built on the first call; returns ``(out, carry)``."""
    cache, state = carry
    x2 = _stack_lanes(x, n_lanes)
    tvec = torch.full((x2.shape[0],), t, dtype=torch.float32, device=x2.device)
    hidden, ctx = core.prepare(x2, tvec, cond)
    if cache is None:
        cache = torch.zeros_like(hidden)
    if state is None and core.init_state is not None:
        state = core.init_state(hidden, ctx)
    h_out, cache, state = _cached_trunk(core, hidden, ctx, cache, skip_bits,
                                        lane_of_row, partial_lanes, state, i)
    return core.head(h_out, ctx), (cache, state)


@torch.inference_mode()
def sample_pndm(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    schedule,
    *,
    cache_cfg=None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    combine_fn: Optional[Callable] = None,
    return_skips: bool = False,
):
    """PNDM/PLMS sampler (Open-Sora-Plan v1.1's scheduler, the JAX
    ``sample_pndm``) with MagCache over ``schedule``'s n+1 model calls
    (``schedulers.pndm.PNDMSchedule``): each call's eps (the lanes combined
    by ``guidance_scale`` or ``combine_fn``) is weighted with the three last
    pushed ones by the step's Adams-Bashforth row, and ``x <- c_x * base +
    c_e * e'`` transfers from ``x``, or from ``x_init`` on the duplicated
    second timestep (the Heun redo from the stashed first sample). A
    stateful core (PAB) gets the call index as its step. ``return_skips``
    also returns the realized skip bits ``bool[n+1, lanes]``.
    """
    n = schedule.num_steps
    batch = x_init.shape[0]
    skip_mask, n_lanes, lane_of_row, partial_lanes = _lane_setup(
        cache_cfg, n, guidance_scale, lanes, batch, combine_fn)
    ts = np.asarray(schedule.timesteps, np.float32)
    c_x, c_e = (np.asarray(a, np.float32) for a in (schedule.c_x, schedule.c_e))
    wts = np.asarray(schedule.eps_weights, np.float32)
    push = np.asarray(schedule.push_eps) != 0
    use_cur = np.asarray(schedule.use_cur) != 0

    x = x_init
    hist = [torch.zeros_like(x_init)] * 3           # e pushed last, then older
    carry = (None, None)
    for i in range(n):
        out, carry = _model_call(core, x, i, float(ts[i]), cond, carry, skip_mask[i],
                                    lane_of_row, partial_lanes, n_lanes)
        e = _cfg_combine(out, guidance_scale, batch, combine_fn, n_lanes, i).to(x.dtype)
        e_prime = float(wts[i, 0]) * e
        for w, h in zip(wts[i, 1:], hist):
            e_prime = e_prime + float(w) * h
        x = float(c_x[i]) * (x_init if use_cur[i] else x) + float(c_e[i]) * e_prime
        if push[i]:
            hist = [e] + hist[:-1]
    if return_skips:
        return x, skip_mask.copy()
    return x


@torch.inference_mode()
def sample_dpm_cogvideo(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    schedule,
    *,
    cache_cfg=None,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    combine_fn: Optional[Callable] = None,
    return_skips: bool = False,
):
    """DPM-Solver++ 2M on the CogVideoX alpha schedule (v-prediction,
    ``schedulers.ddim_cogvideo.CogVideoDPMSchedule``; the JAX
    ``sample_dpm_cogvideo``) with MagCache: per step the data prediction
    ``m = sa * x - sb * v`` and ``x <- c_x * x + c_m0 * m + c_m1 * m_prev``
    from host coefficients. ``return_skips`` also returns the realized skip
    bits ``bool[steps, lanes]``."""
    n = schedule.num_steps
    batch = x_init.shape[0]
    skip_mask, n_lanes, lane_of_row, partial_lanes = _lane_setup(
        cache_cfg, n, guidance_scale, lanes, batch, combine_fn)
    c_x, c_m0, c_m1, sa, sb = schedule.step_arrays()
    ts = np.asarray(schedule.timesteps, np.float32)

    x = x_init
    m_prev = torch.zeros_like(x_init)
    carry = (None, None)
    for i in range(n):
        out, carry = _model_call(core, x, i, float(ts[i]), cond, carry, skip_mask[i],
                                    lane_of_row, partial_lanes, n_lanes)
        v = _cfg_combine(out, guidance_scale, batch, combine_fn, n_lanes, i).to(x.dtype)
        m = float(sa[i]) * x - float(sb[i]) * v
        x = float(c_x[i]) * x + float(c_m0[i]) * m + float(c_m1[i]) * m_prev
        m_prev = m
    if return_skips:
        return x, skip_mask.copy()
    return x
