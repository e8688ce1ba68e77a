"""TaylorSeer, the feature-forecasting comparator cache (the third switch on
OmniGen2's path; ``magcache_tpu.core.taylorseer``).

At *fresh* steps the trunk runs and a stack of backward finite-difference
derivatives of its residual (``trunk(h) - h``) is updated; at every other
step the residual is forecast with the Taylor polynomial

    r(i_last + x) ~ sum_k  d_k * x^k / k!

and the trunk does not run. The fresh/forecast decision depends only on the
step index (interval sampling plus a warm-up), so the whole schedule is
computed on the host in numpy (``taylorseer_schedule``) and the loop
branches in Python on its bits. The derivative stack is f32 whatever the
trunk's dtype; a forecast step rounds ``h + r`` back to the hidden dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from magcache_tpu_torch.core.sampler import DiTCore, _cfg_combine, _stack_lanes

__all__ = ["TaylorSeerConfig", "taylorseer_schedule", "taylor_update", "taylor_forecast",
           "sample_euler_taylorseer"]


@dataclasses.dataclass(frozen=True)
class TaylorSeerConfig:
    """``interval`` = the published ``fresh_threshold`` (compute every N-th
    step), ``order`` = ``max_order`` (derivative depth), ``warmup`` =
    ``first_enhance`` (leading always-compute steps)."""

    num_steps: int
    interval: int = 4
    order: int = 2
    warmup: int = 3


def taylorseer_schedule(cfg: TaylorSeerConfig):
    """Host schedule ``(fresh, x_fc, upd, hist)``, each of length
    ``num_steps``:

    - ``fresh[i]``: compute the trunk at step i (``i < warmup`` or ``i %
      interval == 0``, the phase anchored at step 0);
    - ``x_fc[i]``: forecast distance ``i - last_fresh`` (f32, non-fresh steps);
    - ``upd[i]``: the finite-difference span since the previous fresh step
      (f32, fresh steps; 1 at the first);
    - ``hist[i]``: fresh steps strictly before i (int32; caps the usable
      derivative order).
    """
    n, w, iv = cfg.num_steps, cfg.warmup, cfg.interval
    fresh = np.array([i < w or i % iv == 0 for i in range(n)], bool)
    x_fc = np.zeros(n, np.float32)
    upd = np.ones(n, np.float32)
    hist = np.zeros(n, np.int32)
    last, seen = -1, 0
    for i in range(n):
        hist[i] = seen
        if fresh[i]:
            upd[i] = float(i - last) if last >= 0 else 1.0
            last = i
            seen += 1
        else:
            x_fc[i] = float(i - last)
    return fresh, x_fc, upd, hist


def taylor_update(derivs: torch.Tensor, y: torch.Tensor, ud: float, hs: int,
                  order: int) -> torch.Tensor:
    """The stack ``[order + 1, *y.shape]`` refreshed with a freshly computed
    feature ``y``: ``d_0 = y``, ``d_k = (d_{k-1}' - d_{k-1}) / ud``, kept only
    once ``hs >= k`` fresh features came before (else 0). The stack keeps
    its own dtype (f32)."""
    new = [y.to(derivs.dtype)]
    span = torch.tensor(ud, dtype=derivs.dtype)
    for k in range(1, order + 1):
        d_k = (new[k - 1] - derivs[k - 1]) / span.to(derivs.device)
        new.append(d_k if hs >= k else torch.zeros_like(d_k))
    return torch.stack(new)


def taylor_forecast(derivs: torch.Tensor, xf: float, order: int) -> torch.Tensor:
    """``sum_k derivs[k] * xf^k / k!`` at distance ``xf`` from the last fresh
    step, in the stack's dtype, as the JAX forecast rounds it: the powers of
    ``xf`` and their quotients by k! are taken in that dtype."""
    dt, dev = derivs.dtype, derivs.device
    xq = torch.tensor(xf, dtype=dt)
    y = derivs[0]
    pw = xq
    for k in range(1, order + 1):
        coeff = pw / torch.tensor(float(math.factorial(k)), dtype=dt)
        y = y + derivs[k] * coeff.to(dev)
        pw = pw * xq
    return y


@torch.inference_mode()
def sample_euler_taylorseer(
    core: DiTCore,
    x_init: torch.Tensor,
    cond,
    *,
    timesteps: np.ndarray,
    dts: np.ndarray,
    ts_cfg: TaylorSeerConfig,
    guidance_scale: Optional[float] = None,
    lanes: Optional[int] = None,
    combine_fn: Optional[Callable] = None,
    return_skips: bool = False,
):
    """Euler sampler with TaylorSeer forecasting on the trunk residual (the
    JAX ``sample_euler_taylorseer``).

    Every guidance lane keeps its own derivative stack (the lanes share the
    stacked leading axis, as MagCache's lane caches do) and all lanes follow
    the one interval schedule. ``combine_fn`` and ``guidance_scale`` as in
    ``sample_euler``; ``return_skips`` also returns ``bool[num_steps,
    lanes]``, True on the forecast steps. A stateful trunk is refused.
    """
    if core.init_state is not None:
        raise ValueError("the TaylorSeer sampler takes a stateless trunk")
    num_steps = len(timesteps)
    if ts_cfg.num_steps != num_steps:
        raise ValueError(f"TaylorSeer schedule of {ts_cfg.num_steps} steps for a "
                         f"sampler of {num_steps}")
    batch = x_init.shape[0]
    n_lanes = lanes if lanes is not None else (2 if guidance_scale is not None else 1)
    fresh, x_fc, upd, hist = taylorseer_schedule(ts_cfg)
    order = ts_cfg.order
    ts = np.asarray(timesteps, np.float32)
    dts = np.asarray(dts, np.float32)

    x, derivs = x_init, None
    for i in range(num_steps):
        x2 = _stack_lanes(x, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32, device=x2.device)
        hidden, ctx = core.prepare(x2, tvec, cond)
        if derivs is None:
            derivs = torch.zeros((order + 1,) + tuple(hidden.shape), dtype=torch.float32,
                                 device=hidden.device)
        if fresh[i]:
            h = core.trunk(hidden, ctx)
            derivs = taylor_update(derivs, h - hidden, float(upd[i]), int(hist[i]), order)
        else:
            fc = taylor_forecast(derivs, float(x_fc[i]), order)
            h = (hidden.to(fc.dtype) + fc).to(hidden.dtype)
        out = core.head(h, ctx)
        v = _cfg_combine(out, guidance_scale, batch, combine_fn, n_lanes, i)
        x = x + float(dts[i]) * v.to(x.dtype)
    if return_skips:
        return x, np.repeat(~fresh[:, None], n_lanes, axis=1)
    return x
