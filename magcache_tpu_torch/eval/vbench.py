"""VBench score aggregation (pure JSON math; counterpart of
``magcache_tpu.eval.vbench``).

Reproduces ``eval/magcache/vbench/cal_vbench.py:5-60``: 7 quality dims + 9
semantic dims, min-max normalized per dimension, dimension-weighted means,
total = (4*quality + 1*semantic) / 5.
"""

from __future__ import annotations

import json
from typing import Dict

SEMANTIC_WEIGHT = 1
QUALITY_WEIGHT = 4

QUALITY_LIST = [
    "subject consistency", "background consistency", "temporal flickering",
    "motion smoothness", "aesthetic quality", "imaging quality", "dynamic degree",
]

SEMANTIC_LIST = [
    "object class", "multiple objects", "human action", "color",
    "spatial relationship", "scene", "appearance style", "temporal style",
    "overall consistency",
]

NORMALIZE = {
    "subject consistency": (0.1462, 1.0),
    "background consistency": (0.2615, 1.0),
    "temporal flickering": (0.6293, 1.0),
    "motion smoothness": (0.706, 0.9975),
    "dynamic degree": (0.0, 1.0),
    "aesthetic quality": (0.0, 1.0),
    "imaging quality": (0.0, 1.0),
    "object class": (0.0, 1.0),
    "multiple objects": (0.0, 1.0),
    "human action": (0.0, 1.0),
    "color": (0.0, 1.0),
    "spatial relationship": (0.0, 1.0),
    "scene": (0.0, 0.8222),
    "appearance style": (0.0009, 0.2855),
    "temporal style": (0.0, 0.364),
    "overall consistency": (0.0, 0.364),
}

DIM_WEIGHT = {d: 1.0 for d in QUALITY_LIST + SEMANTIC_LIST}
DIM_WEIGHT["dynamic degree"] = 0.5


def aggregate_vbench(scores: Dict[str, float]) -> Dict[str, float]:
    """scores: raw per-dimension values -> normalized + weighted summary."""
    def norm(dim, v):
        lo, hi = NORMALIZE[dim]
        return (v - lo) / (hi - lo)

    def group(dims):
        num = sum(norm(d, scores[d]) * DIM_WEIGHT[d] for d in dims if d in scores)
        den = sum(DIM_WEIGHT[d] for d in dims if d in scores)
        return num / den if den else 0.0

    quality = group(QUALITY_LIST)
    semantic = group(SEMANTIC_LIST)
    total = ((quality * QUALITY_WEIGHT + semantic * SEMANTIC_WEIGHT)
             / (QUALITY_WEIGHT + SEMANTIC_WEIGHT))
    return {"total score": total, "quality score": quality,
            "semantic score": semantic}


def aggregate_vbench_json(path: str) -> Dict[str, float]:
    with open(path) as f:
        data = json.load(f)
    scores = {k: (v[0] if isinstance(v, (list, tuple)) else v)
              for k, v in data.items()}
    return aggregate_vbench(scores)
