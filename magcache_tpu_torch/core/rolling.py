"""The rolling-cache MagCache policy: the eval-variant decision rule behind
the published Wan VBench and Open-Sora numbers (``magcache_tpu.core.
rolling``; reference ``Wan2.1_EVAL/wan_magcache.py:683-817`` and
``experiments/opensora.py:296-312``).

It differs from the release adapters' rule only in the decision schedule:
a counter over forwards (Wan: 2 a step, cond then uncond), the first
``skip_time`` forwards always computed, the ratio table read from forward
``cache_time`` on, per-lane ``sim *= ratio; steps += 1; err += |1 - sim|``
(Open-Sora without the abs), skip while ``err <= E and steps <= K`` (both
inclusive), reset on compute. The residual queue of the eval scripts has
depth 1, so the samplers' residual cache serves unchanged. The decision
depends only on the table and the counters, so the whole schedule is host
numpy, computed once (``RollingCacheConfig.skip_schedule``), and rides the
samplers' static skip mask.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np

from magcache_tpu_torch.data import eval_rolling_ratios

__all__ = ["RollingCacheConfig", "compute_rolling_schedule", "load_eval_ratios"]

_log = logging.getLogger(__name__)


def load_eval_ratios(key: str = "wan-t2v-50step") -> np.ndarray:
    """The published eval ratios ``key`` with ``**0.5`` applied (f64)."""
    return eval_rolling_ratios(key)


def compute_rolling_schedule(num_forwards: int, ratios: np.ndarray,
                             thresh: float, K: int, *,
                             cache_time: int = 10,
                             retention: float = 0.2,
                             lanes: int = 2,
                             use_abs: bool = True,
                             skip_time: Optional[int] = None) -> np.ndarray:
    """``bool[num_forwards]`` skip bits of the eval decision loop.

    Wan: ``lanes=2``, ``|1 - sim|``, the table from forward ``cache_time``
    (10), ``skip_time = int(num_forwards * retention)``. Open-Sora:
    ``lanes=1`` (the joint CFG batch), ``1 - sim``, ``cache_time=1``, an
    explicit ``skip_time``. A table whose length is not ``num_forwards -
    cache_time`` is nearest-index resampled per lane. Forwards before
    ``cache_time`` never skip (they have no recorded residual)."""
    need = num_forwards - cache_time
    r = np.asarray(ratios, np.float64)
    if lanes != 1 and cache_time % lanes:
        raise ValueError(f"cache_time {cache_time} must be a multiple of lanes {lanes}")
    if len(r) != need:
        if len(r) < lanes:
            raise ValueError(f"ratio table too short to resample per lane: "
                             f"{len(r)} < {lanes}")
        per = need // lanes + (1 if need % lanes else 0)
        src = r[:len(r) - (len(r) % lanes) or None].reshape(-1, lanes)
        idx = np.minimum((np.arange(per) * len(src)) // max(per, 1), len(src) - 1)
        r = src[idx].reshape(-1)[:need]
    skip = np.zeros(num_forwards, bool)
    if skip_time is None:
        skip_time = int(num_forwards * retention)
    skip_time = max(skip_time, cache_time)
    acc_sim = [1.0] * lanes
    acc_steps = [0] * lanes
    acc_err = [0.0] * lanes
    for t in range(skip_time, num_forwards):
        lane = t % lanes
        acc_sim[lane] *= r[t - cache_time]
        acc_steps[lane] += 1
        err = 1.0 - acc_sim[lane]
        acc_err[lane] += abs(err) if use_abs else err
        if acc_err[lane] <= thresh and acc_steps[lane] <= K:
            skip[t] = True
        else:
            acc_sim[lane] = 1.0
            acc_steps[lane] = 0
            acc_err[lane] = 0.0
    if not skip.any():
        # the eval scripts' defaults (0.015, K = -1) never skip: K is checked
        # after the increment. The published runs passed 0.12 and K 2 or 4.
        _log.warning("rolling cache schedule has ZERO skips (thresh=%s K=%s): the "
                     "eval defaults are inert; the published runs used "
                     "--magcache_thresh 0.12 --magcache_K 2 (or 4)", thresh, K)
    return skip


@dataclasses.dataclass(frozen=True)
class RollingCacheConfig:
    """A ``cache_cfg`` for the samplers: they read its ``skip_schedule()``
    (``core.sampler.lane_skip_masks``) in place of the MagCache schedule."""

    num_steps: int                       # forwards = scheduler steps * lanes
    thresh: float = 0.12
    K: int = 2
    lanes: int = 2
    cache_time: int = 10
    retention: float = 0.2
    use_abs: bool = True
    skip_time: Optional[int] = None
    ratios: Optional[Tuple[float, ...]] = None   # default: the Wan table

    def skip_schedule(self) -> np.ndarray:
        r = (np.asarray(self.ratios, np.float64) if self.ratios is not None
             else load_eval_ratios())
        return compute_rolling_schedule(
            self.num_steps, r, self.thresh, self.K, cache_time=self.cache_time,
            retention=self.retention, lanes=self.lanes, use_abs=self.use_abs,
            skip_time=self.skip_time)

    @staticmethod
    def opensora(num_steps: int, thresh: float = 0.12, K: int = 3,
                 skip_time: Optional[int] = None) -> "RollingCacheConfig":
        """The Open-Sora eval configuration (``experiments/opensora.py:
        411-440``): one lane over the joint CFG batch, ratio[t - 1], the
        signed error, skip_time 6 at 30 steps (retention 0.2)."""
        return RollingCacheConfig(
            num_steps=num_steps, thresh=thresh, K=K, lanes=1, cache_time=1,
            use_abs=False, skip_time=skip_time,
            ratios=tuple(load_eval_ratios("opensora-30step")))
