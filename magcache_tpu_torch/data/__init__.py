"""Published calibration artifacts, read by path from the JAX package's data.

``magcache_tpu/data/calibrated_ratios.json`` is shared data, not code: the
port reads the file directly (importing ``magcache_tpu`` would pull in jax).
Same pad and ``sqrt`` rules as ``magcache_tpu/data/__init__.py``.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "magcache_tpu", "data")


@lru_cache(maxsize=1)
def _load() -> dict:
    with open(os.path.join(DATA_DIR, "calibrated_ratios.json")) as f:
        return json.load(f)


def available_ratio_keys() -> list[str]:
    return sorted(_load().keys())


def get_calibrated_ratios(key: str, *, padded: bool = False) -> np.ndarray:
    """The calibrated ratio array for ``key`` (f64). Entries flagged ``sqrt``
    get ``**0.5`` smoothing; ``padded=True`` prepends ``[1.0] * pad``."""
    entry = _load()[key]
    ratios = np.asarray(entry["ratios"], dtype=np.float64)
    if entry.get("sqrt"):
        ratios = ratios ** 0.5
    if padded and entry.get("pad"):
        ratios = np.concatenate([np.ones(entry["pad"]), ratios])
    return ratios


def ratio_pad(key: str) -> int:
    return int(_load()[key].get("pad") or 0)
