"""The MagCache decision algebra, host-side numpy.

MagCache (arXiv:2506.09045) skips diffusion-transformer trunk evaluations by
replaying a cached trunk residual while the error predicted from calibrated
per-step magnitude ratios stays under a budget. Per forward index ``cnt``
with lane ``l = cnt % lanes``::

    if gate(cnt):                             # retention gate: never skip early steps
        acc_ratio[l] *= mag_ratios[cnt]
        acc_steps[l] += 1
        acc_err[l]   += |1 - acc_ratio[l]|
        if acc_err[l] < E and acc_steps[l] <= K and extra_guards(cnt):
            skip = True                        # replay cached residual
        else:
            acc_{err,steps}[l] = 0; acc_ratio[l] = 1.0   # reset, force compute

The decision depends only on ``(cnt, mag_ratios, E, K, R)``, never on
activations, so the whole schedule is computed on the host before sampling
and the sampler's Python loop reads one precomputed bit per lane and step:
no device-to-host sync decides a skip.

Per-model quirk flags (same semantics and defaults as
``magcache_tpu.core.magcache``):

- retention gate rounding: Wan/Qwen ``cnt >= int(N*R)``; FLUX
  ``cnt >= int(R*N + 0.5)``;
- error-budget strictness: Wan/Qwen ``err < E``; FLUX/FramePack ``err <= E``;
- FLUX forces compute at the canonical 28-step index 11;
- FramePack adds ``|1 - mag_ratios[cnt]| <= 0.06`` and a ``cnt >= 1`` floor;
- Wan2.2 two-expert models re-gate retention around ``split_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["MagCacheConfig", "MagCacheState", "compute_skip_schedule",
           "dynamic_init", "dynamic_update", "nearest_interp", "prepare_mag_ratios"]


def nearest_interp(src_array: np.ndarray, target_length: int) -> np.ndarray:
    """Nearest-neighbour resample: index map ``round(arange(T)*(S-1)/(T-1))``;
    a target length of 1 returns the last element."""
    src_array = np.asarray(src_array)
    src_length = len(src_array)
    if target_length == 1:
        return src_array[-1:]
    scale = (src_length - 1) / (target_length - 1)
    mapped = np.round(np.arange(target_length) * scale).astype(int)
    return src_array[mapped]


def prepare_mag_ratios(
    raw_ratios: Sequence[float],
    num_steps: int,
    lanes: int = 1,
    pad: Optional[int] = None,
) -> np.ndarray:
    """Prepend ``[1.0] * pad`` (default ``lanes``) to the calibrated ratios,
    then, when the length differs from ``num_steps``, nearest-resample each
    CFG lane's subsequence independently and re-interleave."""
    pad = lanes if pad is None else pad
    ratios = np.concatenate([np.ones(pad), np.asarray(raw_ratios, dtype=np.float64)])
    if len(ratios) != num_steps:
        if lanes == 1:
            ratios = nearest_interp(ratios, num_steps)
        else:
            if num_steps % lanes:
                raise ValueError(f"num_steps {num_steps} is not a multiple "
                                 f"of lanes {lanes}")
            per_lane = num_steps // lanes
            cols = [nearest_interp(ratios[l::lanes], per_lane) for l in range(lanes)]
            ratios = np.stack(cols, axis=1).reshape(-1)
    return ratios.astype(np.float64)


@dataclasses.dataclass(frozen=True)
class MagCacheConfig:
    """Static configuration of one MagCache run: the E/K/R triple plus the
    per-model quirk flags (defaults = Wan2.1 semantics)."""

    num_steps: int                       # total forward count (steps * lanes)
    mag_ratios: Tuple[float, ...]        # len == num_steps, padded/resampled
    thresh: float = 0.12                 # E, accumulated-error budget
    max_consecutive_skips: int = 2       # K
    retention_ratio: float = 0.2         # R, fraction of early steps always computed
    lanes: int = 1                       # CFG cache lanes; lane of forward i is i % lanes

    gate_rounds: bool = False            # True: gate at int(R*N + 0.5) (FLUX)
    err_inclusive: bool = False          # True: skip while err <= E
    min_gate_step: int = 0               # FramePack: cnt >= 1 floor
    max_ratio_deviation: Optional[float] = None   # FramePack: |1-ratio[cnt]| <= 0.06
    forced_compute_canonical: Tuple[int, ...] = ()  # FLUX: canonical ids never skipped
    canonical_num_steps: Optional[int] = None       # FLUX: 28
    split_step: Optional[int] = None     # Wan2.2: expert boundary (forward indices)
    mode: str = "t2v"                    # Wan2.2 gating mode: "t2v" | "i2v" | "ti2v"

    def __post_init__(self):
        object.__setattr__(self, "mag_ratios", tuple(float(r) for r in self.mag_ratios))
        if len(self.mag_ratios) != self.num_steps:
            raise ValueError(
                f"mag_ratios length {len(self.mag_ratios)} != num_steps "
                f"{self.num_steps}; run prepare_mag_ratios() first")

    def gate_open(self, cnt: int) -> bool:
        """True when MagCache may consider skipping forward index ``cnt``."""
        n, r = self.num_steps, self.retention_ratio
        if self.split_step is not None:
            ss = self.split_step
            if self.mode == "i2v":
                if cnt < int(ss + (n - ss) * r):
                    return False
            else:  # t2v
                if cnt < int(ss * r) or (ss <= cnt <= (n - ss) * r + ss):
                    return False
        else:
            gate = int(n * r + 0.5) if self.gate_rounds else int(n * r)
            if cnt < gate:
                return False
        return cnt >= self.min_gate_step

    def forced_compute(self, cnt: int) -> bool:
        """FLUX-style canonical-step exclusion."""
        if not self.forced_compute_canonical:
            return False
        cn = self.canonical_num_steps
        canonical = int(np.round(cnt * ((cn - 1) / (self.num_steps - 1))))
        return canonical in self.forced_compute_canonical


def compute_skip_schedule(cfg: MagCacheConfig) -> np.ndarray:
    """Run the scalar recurrence on the host; returns ``bool[num_steps]``."""
    ratios = np.asarray(cfg.mag_ratios, dtype=np.float64)
    acc_ratio = np.ones(cfg.lanes)
    acc_err = np.zeros(cfg.lanes)
    acc_steps = np.zeros(cfg.lanes, dtype=np.int64)
    skip = np.zeros(cfg.num_steps, dtype=bool)
    for cnt in range(cfg.num_steps):
        lane = cnt % cfg.lanes
        if not cfg.gate_open(cnt):
            continue
        acc_ratio[lane] *= ratios[cnt]
        acc_steps[lane] += 1
        acc_err[lane] += abs(1.0 - acc_ratio[lane])
        if cfg.err_inclusive:
            ok = acc_err[lane] <= cfg.thresh
        else:
            ok = acc_err[lane] < cfg.thresh
        ok = ok and acc_steps[lane] <= cfg.max_consecutive_skips
        if cfg.max_ratio_deviation is not None:
            ok = ok and abs(1.0 - ratios[cnt]) <= cfg.max_ratio_deviation
        ok = ok and not cfg.forced_compute(cnt)
        if ok:
            skip[cnt] = True
        else:
            acc_ratio[lane] = 1.0
            acc_err[lane] = 0.0
            acc_steps[lane] = 0
    return skip


# --------------------------------------------------------------------------
# Per-forward mode: the same recurrence one forward at a time, carried in a
# state, for parity with the JAX package's in-graph path (``dynamic_update``
# there). The decision depends only on the config, so it runs on host
# scalars, in f32 as the JAX carry is.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MagCacheState:
    """Per-lane accumulators of the per-forward mode."""

    acc_ratio: np.ndarray   # f32[lanes]
    acc_err: np.ndarray     # f32[lanes]
    acc_steps: np.ndarray   # i32[lanes]


def dynamic_init(cfg: MagCacheConfig) -> MagCacheState:
    return MagCacheState(acc_ratio=np.ones(cfg.lanes, np.float32),
                         acc_err=np.zeros(cfg.lanes, np.float32),
                         acc_steps=np.zeros(cfg.lanes, np.int32))


def dynamic_update(state: MagCacheState, cnt: int,
                   cfg: MagCacheConfig) -> Tuple[bool, MagCacheState]:
    """One decision at forward index ``cnt``: ``(skip, new_state)``. Outside
    the retention gate the state passes through; a refused skip resets the
    lane."""
    if not cfg.gate_open(cnt):
        return False, state
    lane = cnt % cfg.lanes
    one = np.float32(1.0)
    ratio = np.float32(cfg.mag_ratios[cnt])
    acc_ratio, acc_err, acc_steps = (a.copy() for a in dataclasses.astuple(state))
    acc_ratio[lane] = acc_ratio[lane] * ratio
    acc_steps[lane] += 1
    acc_err[lane] = acc_err[lane] + np.abs(one - acc_ratio[lane])
    thresh = np.float32(cfg.thresh)
    ok = acc_err[lane] <= thresh if cfg.err_inclusive else acc_err[lane] < thresh
    ok = ok and acc_steps[lane] <= cfg.max_consecutive_skips
    if cfg.max_ratio_deviation is not None:
        ok = ok and np.abs(one - ratio) <= np.float32(cfg.max_ratio_deviation)
    ok = bool(ok and not cfg.forced_compute(cnt))
    if not ok:
        acc_ratio[lane], acc_err[lane], acc_steps[lane] = 1.0, 0.0, 0
    return ok, MagCacheState(acc_ratio, acc_err, acc_steps)
