"""Experiment runner: a golden full-compute run against cached runs, with a
similarity report (counterpart of ``magcache_tpu.eval.experiments``).

The reference's flow (``eval/magcache/experiments/opensora.py:375-455``,
``Wan2.1_EVAL/wan_magcache.py``): run a prompt list under each configuration,
save the outputs, then compare each accelerated run with the base run by
PSNR / SSIM / LPIPS and wall clock. Outputs are the latents as ``.npy``
(decoded videos when the pipeline has a VAE) and a JSON summary.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from magcache_tpu_torch.eval.compare import compare_videos
from magcache_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["run_experiment", "ExperimentResult"]


@dataclasses.dataclass
class ExperimentResult:
    name: str
    seconds_per_prompt: float
    metrics_vs_base: Dict[str, float]
    outputs: List[np.ndarray]


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_frames(latents: np.ndarray) -> np.ndarray:
    """Latents as ``[T, H, W, <=3]`` frames for the metrics, unnormalised:
    the pair shares one min-max in ``_norm_pair``, so a global magnitude
    drift shows. Real runs should compare decoded videos."""
    lat = np.asarray(latents)
    if lat.ndim == 5:            # [B, T, H, W, C]
        lat = lat[0]
    elif lat.ndim == 3:          # [B, S, C] image tokens
        lat = lat[0][None]
    return lat[..., :3].astype(np.float32)


def _norm_pair(a: np.ndarray, b: np.ndarray):
    lo = min(a.min(), b.min())
    hi = max(a.max(), b.max())
    sc = max(hi - lo, 1e-8)
    return ((a - lo) / sc).astype(np.float32), ((b - lo) / sc).astype(np.float32)


def run_experiment(
    make_pipeline,                    # (variant_name) -> pipeline
    prompts: Sequence[str],
    variants: Sequence[str] = ("base", "magcache"),
    seed: int = 42,
    out_dir: Optional[str] = None,
    metrics: Sequence[str] = ("psnr", "ssim"),
) -> Dict[str, ExperimentResult]:
    """Run each variant over the prompts (prompt ``i`` at ``seed + i``) and
    compare every variant with the first, the golden baseline.
    ``make_pipeline(variant)`` builds the pipeline of a variant."""
    results: Dict[str, ExperimentResult] = {}
    raw: Dict[str, List[np.ndarray]] = {}
    for variant in variants:
        pipe = make_pipeline(variant)
        outs, t0 = [], time.time()
        for i, prompt in enumerate(prompts):
            out = pipe.generate(prompt, seed=seed + i)
            outs.append(_host(out.video if out.video is not None else out.latents))
        dt = (time.time() - t0) / max(len(prompts), 1)
        raw[variant] = outs
        logger.info("variant %s: %.2fs/prompt", variant, dt)
        results[variant] = ExperimentResult(variant, dt, {}, outs)

    base = variants[0]
    for variant in variants[1:]:
        per = []
        for a, b in zip(raw[variant], raw[base]):
            fa, fb = _norm_pair(_to_frames(a), _to_frames(b))
            per.append(compare_videos(fa, fb, metrics=metrics))
        agg = {m: float(np.mean([p[m] for p in per])) for m in metrics}
        results[variant].metrics_vs_base = agg
        logger.info("variant %s vs %s: %s", variant, base, agg)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        for variant, outs in raw.items():
            for i, arr in enumerate(outs):
                np.save(os.path.join(out_dir, f"{variant}_{i}.npy"), arr)
        summary = {v: {"seconds_per_prompt": r.seconds_per_prompt,
                       "metrics_vs_base": r.metrics_vs_base}
                   for v, r in results.items()}
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return results
