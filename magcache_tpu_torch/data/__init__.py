"""Published calibration artifacts, read by path from the JAX package's data.

``magcache_tpu/data/calibrated_ratios.json`` (the MagCache presets' ratios)
and ``eval_rolling_ratios.json`` (the eval scripts' rolling-policy tables)
are shared data, not code: the port reads the files directly (importing
``magcache_tpu`` would pull in jax). Same pad and ``sqrt`` rules as
``magcache_tpu/data/__init__.py`` and ``magcache_tpu/core/rolling.py``.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "magcache_tpu", "data")


@lru_cache(maxsize=2)
def _load(name: str = "calibrated_ratios.json") -> dict:
    with open(os.path.join(DATA_DIR, name)) as f:
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


def eval_rolling_ratios(key: str) -> np.ndarray:
    """The rolling policy's published per-forward ratio table ``key``
    (``wan-t2v-50step``, ``opensora-30step``), with the eval forward's
    ``**0.5`` applied at load (f64)."""
    return np.sqrt(np.asarray(_load("eval_rolling_ratios.json")[key], np.float64))
