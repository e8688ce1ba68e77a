"""Golden-reference comparison harness (counterpart of
``magcache_tpu.eval.compare``).

Walks paired directories of generated videos (a cached run and a
full-compute run, ``eval/magcache/common_metrics/{eval,batch_eval}.py``),
computes PSNR, SSIM and LPIPS per pair, averages them and writes a text
report. Videos are ``.npy`` arrays [T, H, W, 3] (uint8, or floats in [0, 1]).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from magcache_tpu_torch.eval.metrics import LPIPSModel, lpips_distance, psnr, ssim

__all__ = ["compare_videos", "compare_dirs", "write_report"]


def _load(path: str) -> np.ndarray:
    v = np.load(path)
    if v.dtype == np.uint8:
        v = v.astype(np.float32) / 255.0
    return v


def compare_videos(a: np.ndarray, b: np.ndarray,
                   lpips_model: Optional[LPIPSModel] = None,
                   metrics: Sequence[str] = ("psnr", "ssim", "lpips"),
                   device=None) -> Dict[str, float]:
    """PSNR and SSIM on the host (numpy, as the reference computes them);
    LPIPS on ``device`` (``lpips_distance``)."""
    out = {}
    if "psnr" in metrics:
        out["psnr"] = psnr(a, b)
    if "ssim" in metrics:
        out["ssim"] = ssim(a, b)
    if "lpips" in metrics:
        out["lpips"] = lpips_distance(a, b, model=lpips_model, device=device)
    return out


def compare_dirs(cached_dir: str, golden_dir: str,
                 lpips_model: Optional[LPIPSModel] = None,
                 metrics: Sequence[str] = ("psnr", "ssim", "lpips"),
                 device=None) -> Dict:
    """Pair the ``.npy`` files of the two directories by name and compare
    each pair; ``{"per_video", "mean", "count"}``."""
    names = sorted(set(os.listdir(cached_dir)) & set(os.listdir(golden_dir)))
    names = [n for n in names if n.endswith(".npy")]
    per_video: List[Dict[str, float]] = []
    for n in names:
        r = compare_videos(_load(os.path.join(cached_dir, n)),
                           _load(os.path.join(golden_dir, n)), lpips_model, metrics,
                           device)
        r["name"] = n
        per_video.append(r)
    agg = {m: float(np.mean([r[m] for r in per_video])) for m in metrics} \
        if per_video else {}
    return {"per_video": per_video, "mean": agg, "count": len(per_video)}


def write_report(result: Dict, path: str) -> str:
    """A comparison's results as text (``eval.py:140-150``)."""
    lines = [f"videos compared: {result['count']}"]
    for m, v in result.get("mean", {}).items():
        lines.append(f"mean {m}: {v:.4f}")
    for r in result.get("per_video", []):
        vals = "  ".join(f"{m}={r[m]:.4f}" for m in r if m != "name")
        lines.append(f"{r['name']}: {vals}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
