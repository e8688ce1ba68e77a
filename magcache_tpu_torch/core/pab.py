"""Pyramid Attention Broadcast (PAB), host numpy (``magcache_tpu.core.pab``;
reference ``videosys/core/pab_mgr.py``).

PAB reuses attention outputs (spatial, temporal, cross) and MLP outputs
across adjacent diffusion steps inside a timestep window: a site reuses
when ``count % range != 0 and lo < timestep < hi`` (``pab_mgr.py:54-91``),
``count`` advancing once a step. Like MagCache the decision is a function
of the step index and the config only, so every decision is a host mask
computed once (``broadcast_masks``, ``mlp_skip_masks``); the cached outputs
live in the trunk's state (``DiTCore.init_state``), one slot per site kind
and block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["PABConfig", "broadcast_masks", "mlp_skip_masks",
           "OPEN_SORA_PAB", "LATTE_PAB",
           "COGVIDEOX_PAB", "VCHITECT_PAB", "OSP_V110_PAB", "OSP_V120_PAB",
           "OpenSoraPABConfig", "LattePABConfig", "CogVideoXPABConfig",
           "VchitectPABConfig", "OpenSoraPlanV110PABConfig",
           "OpenSoraPlanV120PABConfig"]


@dataclasses.dataclass(frozen=True)
class PABConfig:
    """Timestep window and stride per reuse kind (``pab_mgr.py:6-40``)."""

    spatial_broadcast: bool = False
    spatial_threshold: Tuple[int, int] = (0, 0)   # (lo, hi), exclusive
    spatial_range: int = 2

    temporal_broadcast: bool = False
    temporal_threshold: Tuple[int, int] = (0, 0)
    temporal_range: int = 2

    cross_broadcast: bool = False
    cross_threshold: Tuple[int, int] = (0, 0)
    cross_range: int = 2

    mlp_broadcast: bool = False
    mlp_threshold: Tuple[int, int] = (0, 0)
    mlp_range: int = 2

    # block-granular MLP gating (``pab_mgr.py:108-139``): tuples of
    # ``(anchor_timestep, (block_idx, ...), skip_count)``. At an anchor step
    # the listed blocks compute their MLP and save it; for the next
    # ``skip_count`` steps they replay it. None: ``mlp_broadcast`` uses the
    # all-blocks window and stride above.
    mlp_spatial_config: Optional[Tuple[Tuple[int, Tuple[int, ...], int], ...]] = None
    mlp_temporal_config: Optional[Tuple[Tuple[int, Tuple[int, ...], int], ...]] = None


# Open-Sora (videosys OpenSoraPABConfig): spatial/temporal 450-930, ranges
# 2/4; cross 450-930 range 6
OPEN_SORA_PAB = PABConfig(
    spatial_broadcast=True, spatial_threshold=(450, 930), spatial_range=2,
    temporal_broadcast=True, temporal_threshold=(450, 930), temporal_range=4,
    cross_broadcast=True, cross_threshold=(450, 930), cross_range=6,
)

# Latte and OSP-v110 also replay the MLP of their first blocks at given
# coarse timesteps (``pipeline_latte.py:47-61``,
# ``pipeline_open_sora_plan.py:54-85``)
_LATTE_MLP = tuple((t, (0, 1, 2, 3, 4), 2) for t in (720, 640, 560, 480, 400))
_OSP_V110_MLP = tuple((t, (0, 1, 2, 3, 4, 5, 6), 2) for t in range(738, 425, -24))

LATTE_PAB = PABConfig(        # videosys LattePABConfig, pipeline_latte.py:35
    spatial_broadcast=True, spatial_threshold=(100, 800), spatial_range=2,
    temporal_broadcast=True, temporal_threshold=(100, 800), temporal_range=3,
    cross_broadcast=True, cross_threshold=(100, 800), cross_range=6,
    mlp_broadcast=True, mlp_spatial_config=_LATTE_MLP,
    mlp_temporal_config=_LATTE_MLP,
)
COGVIDEOX_PAB = PABConfig(    # CogVideoXPABConfig, pipeline_cogvideox.py:34
    spatial_broadcast=True, spatial_threshold=(100, 850), spatial_range=2,
)
VCHITECT_PAB = PABConfig(     # VchitectPABConfig, pipeline_vchitect.py:32
    spatial_broadcast=True, spatial_threshold=(100, 800), spatial_range=2,
    temporal_broadcast=True, temporal_threshold=(100, 800), temporal_range=4,
    cross_broadcast=True, cross_threshold=(100, 800), cross_range=6,
)
OSP_V110_PAB = PABConfig(     # OpenSoraPlanV110PABConfig
    spatial_broadcast=True, spatial_threshold=(100, 850), spatial_range=2,
    temporal_broadcast=True, temporal_threshold=(100, 850), temporal_range=4,
    cross_broadcast=True, cross_threshold=(100, 850), cross_range=6,
    mlp_broadcast=True, mlp_spatial_config=_OSP_V110_MLP,
    mlp_temporal_config=_OSP_V110_MLP,
)
OSP_V120_PAB = PABConfig(     # OpenSoraPlanV120PABConfig
    spatial_broadcast=True, spatial_threshold=(100, 850), spatial_range=2,
    cross_broadcast=True, cross_threshold=(100, 850), cross_range=6,
)


def _preset_factory(preset: PABConfig):
    def factory(**overrides) -> PABConfig:
        return dataclasses.replace(preset, **overrides)
    return factory


# the reference's named constructors (``videosys/__init__.py``): a family's
# defaults, overridable field by field
OpenSoraPABConfig = _preset_factory(OPEN_SORA_PAB)
LattePABConfig = _preset_factory(LATTE_PAB)
CogVideoXPABConfig = _preset_factory(COGVIDEOX_PAB)
VchitectPABConfig = _preset_factory(VCHITECT_PAB)
OpenSoraPlanV110PABConfig = _preset_factory(OSP_V110_PAB)
OpenSoraPlanV120PABConfig = _preset_factory(OSP_V120_PAB)


def _mask(enabled, lo_hi, stride, timesteps) -> np.ndarray:
    lo, hi = lo_hi
    out = np.zeros(len(timesteps), bool)
    if enabled:
        for count, t in enumerate(timesteps):
            out[count] = count % stride != 0 and lo < t < hi
    return out


def broadcast_masks(cfg: PABConfig, timesteps: Sequence[float]) -> dict:
    """``bool[num_steps]`` reuse bits per kind (``spatial``, ``temporal``,
    ``cross``, ``mlp``) from the sampling timesteps, truncated by ``int``.
    ``mlp`` is the all-blocks rule; block-granular families use
    ``mlp_skip_masks``."""
    ts = [int(t) for t in timesteps]
    return {
        "spatial": _mask(cfg.spatial_broadcast, cfg.spatial_threshold,
                         cfg.spatial_range, ts),
        "temporal": _mask(cfg.temporal_broadcast, cfg.temporal_threshold,
                          cfg.temporal_range, ts),
        "cross": _mask(cfg.cross_broadcast, cfg.cross_threshold, cfg.cross_range, ts),
        "mlp": _mask(cfg.mlp_broadcast, cfg.mlp_threshold, cfg.mlp_range, ts),
    }


def _anchor_of(ts, t, config):
    """``PABManager._is_t_in_skip_config`` (``pab_mgr.py:94-106``): the first
    anchor (in config order) whose ``[anchor, anchor + skip_count]`` slice
    of the sampled timesteps holds ``t``, or None."""
    for key in config:
        if key not in ts:
            continue
        idx = ts.index(key)
        if t in ts[idx:idx + 1 + int(config[key]["skip_count"])]:
            return key
    return None


def mlp_skip_masks(cfg: PABConfig, timesteps: Sequence[float],
                   num_blocks: int, temporal: bool = False) -> dict:
    """Block-granular MLP masks ``{"reuse": bool[steps, blocks], "save":
    bool[steps, blocks]}`` (``pab_mgr.py:108-139``): at an anchor step a
    listed block computes and saves its MLP output; for the next
    ``skip_count`` steps it replays it; other blocks and steps compute
    without touching the cache. Without a block config: the all-blocks
    window and stride, every computed step saving."""
    ts = [int(t) for t in timesteps]
    n = len(ts)
    reuse = np.zeros((n, num_blocks), bool)
    save = np.zeros((n, num_blocks), bool)
    if not cfg.mlp_broadcast:
        return {"reuse": reuse, "save": save}
    conf = cfg.mlp_temporal_config if temporal else cfg.mlp_spatial_config
    if conf is None:
        m = _mask(True, cfg.mlp_threshold, cfg.mlp_range, ts)
        reuse[:] = m[:, None]
        save[:] = ~m[:, None]
        return {"reuse": reuse, "save": save}
    config = {int(t): {"block": tuple(blocks), "skip_count": int(sc)}
              for t, blocks, sc in conf}
    for i, t in enumerate(ts):
        anchor = _anchor_of(ts, t, config)
        for b in range(num_blocks):
            if t in config and b in config[t]["block"]:
                save[i, b] = True
            elif anchor is not None and b in config[anchor]["block"]:
                reuse[i, b] = True
    return {"reuse": reuse, "save": save}
