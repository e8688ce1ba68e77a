"""Per-model MagCache presets: default E/K/R triples, quirk flags and the key
of each model's calibrated ratios. The table and its sources are those of
``magcache_tpu.core.presets``."""

from __future__ import annotations

import dataclasses
from typing import Optional

from magcache_tpu_torch.core.magcache import MagCacheConfig, prepare_mag_ratios
from magcache_tpu_torch.data import get_calibrated_ratios, ratio_pad


@dataclasses.dataclass(frozen=True)
class MagCachePreset:
    ratio_key: str                 # key into data/calibrated_ratios.json
    thresh: float
    K: int
    retention_ratio: float
    lanes: int
    gate_rounds: bool = False
    err_inclusive: bool = False
    min_gate_step: int = 0
    max_ratio_deviation: Optional[float] = None
    forced_compute_canonical: tuple = ()
    canonical_num_steps: Optional[int] = None


PRESETS: dict[str, MagCachePreset] = {
    "wan2.1-t2v-1.3B": MagCachePreset("wan2.1-t2v-1.3B", 0.12, 2, 0.2, lanes=2),
    "wan2.1-t2v-14B": MagCachePreset("wan2.1-t2v-14B", 0.24, 6, 0.2, lanes=2),
    "wan2.1-i2v-480p": MagCachePreset("wan2.1-i2v-480p", 0.12, 4, 0.2, lanes=2),
    "wan2.1-i2v-720p": MagCachePreset("wan2.1-i2v-720p", 0.24, 6, 0.2, lanes=2),
    "wan2.1-vace-1.3B": MagCachePreset("wan2.1-vace-1.3B", 0.12, 2, 0.2, lanes=2),
    "wan2.1-vace-14B": MagCachePreset("wan2.1-vace-14B", 0.24, 6, 0.2, lanes=2),
    "wan2.2-t2v-A14B": MagCachePreset("wan2.2-t2v-A14B", 0.06, 2, 0.4, lanes=2),
    "wan2.2-i2v-A14B": MagCachePreset("wan2.2-i2v-A14B", 0.06, 2, 0.1, lanes=2),
    "wan2.2-ti2v-5B-t2v": MagCachePreset("wan2.2-ti2v-5B-t2v", 0.06, 2, 0.2, lanes=2),
    "wan2.2-ti2v-5B-i2v": MagCachePreset("wan2.2-ti2v-5B-i2v", 0.06, 2, 0.2, lanes=2),
    "hunyuanvideo-720p": MagCachePreset("hunyuanvideo-720p", 0.24, 6, 0.2, lanes=1),
    "hunyuanvideo-544p": MagCachePreset("hunyuanvideo-544p", 0.24, 6, 0.2, lanes=1),
    "flux-dev": MagCachePreset(
        "flux-dev", 0.24, 5, 0.1, lanes=1,
        gate_rounds=True, err_inclusive=True,
        forced_compute_canonical=(11,), canonical_num_steps=28,
    ),
    "flux-kontext-dev": MagCachePreset(
        "flux-kontext-dev", 0.05, 4, 0.2, lanes=1,
        gate_rounds=True, err_inclusive=True,
        forced_compute_canonical=(11,), canonical_num_steps=28,
    ),
    "qwen-image": MagCachePreset("qwen-image", 0.06, 2, 0.2, lanes=2),
    "qwen-image-edit": MagCachePreset("qwen-image-edit", 0.06, 2, 0.2, lanes=2),
    "framepack": MagCachePreset(
        "framepack", 0.10, 3, 0.2, lanes=1,
        err_inclusive=True, min_gate_step=1, max_ratio_deviation=0.06,
    ),
    "framepack-f1": MagCachePreset(
        "framepack-f1", 0.10, 3, 0.2, lanes=1,
        err_inclusive=True, min_gate_step=1, max_ratio_deviation=0.06,
    ),
    "omnigen2-t2i_cond": MagCachePreset("omnigen2-t2i_cond", 0.05, 3, 0.2, lanes=1),
    "omnigen2-t2i_uncond": MagCachePreset("omnigen2-t2i_uncond", 0.05, 3, 0.2, lanes=1),
    "omnigen2-edit_cond": MagCachePreset("omnigen2-edit_cond", 0.05, 3, 0.2, lanes=1),
    "omnigen2-edit_uncond": MagCachePreset("omnigen2-edit_uncond", 0.05, 3, 0.2, lanes=1),
    "omnigen2-edit_ref": MagCachePreset("omnigen2-edit_ref", 0.05, 3, 0.2, lanes=1),
    "opensora-v1.2": MagCachePreset("opensora-v1.2", 0.12, 3, 0.2, lanes=1),
}


def make_config(
    preset: str,
    sample_steps: int,
    *,
    thresh: Optional[float] = None,
    K: Optional[int] = None,
    retention_ratio: Optional[float] = None,
    split_step: Optional[int] = None,
    mode: str = "t2v",
    ratios=None,
) -> MagCacheConfig:
    """A ready-to-run MagCacheConfig for ``sample_steps`` scheduler steps
    (``num_steps = sample_steps * lanes``). ``ratios`` (an unpadded
    calibration-mode list) replaces the published table."""
    if preset not in PRESETS:
        # common shorthand: the "-dev" model-id suffix dropped
        if f"{preset}-dev" in PRESETS:
            preset = f"{preset}-dev"
        else:
            raise KeyError(
                f"unknown MagCache preset {preset!r}; known: {sorted(PRESETS)}")
    p = PRESETS[preset]
    num_steps = sample_steps * p.lanes
    if ratios is not None:
        ratios = prepare_mag_ratios(ratios, num_steps, lanes=p.lanes)
    else:
        ratios = prepare_mag_ratios(
            get_calibrated_ratios(p.ratio_key), num_steps, lanes=p.lanes,
            pad=ratio_pad(p.ratio_key),
        )
    return MagCacheConfig(
        num_steps=num_steps,
        mag_ratios=tuple(ratios),
        thresh=p.thresh if thresh is None else thresh,
        max_consecutive_skips=p.K if K is None else K,
        retention_ratio=p.retention_ratio if retention_ratio is None else retention_ratio,
        lanes=p.lanes,
        gate_rounds=p.gate_rounds,
        err_inclusive=p.err_inclusive,
        min_gate_step=p.min_gate_step,
        max_ratio_deviation=p.max_ratio_deviation,
        forced_compute_canonical=p.forced_compute_canonical,
        canonical_num_steps=p.canonical_num_steps,
        split_step=split_step,
        mode=mode,
    )
