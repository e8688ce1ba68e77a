"""Observability: step timing, the skip schedule up front, profiler traces
(counterpart of ``magcache_tpu.utils.trace``).

- ``StepTimer``: named wall-clock sections with a summary table;
- ``log_skip_schedule``: logs which forwards a static schedule elides,
  before the run (the reference prints skip events as they happen,
  ``wan_magcache.py:790``);
- ``profile_trace``: ``torch.profiler`` over the CPU and, when present, the
  card, exported as a Chrome trace (``chrome://tracing``, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np

from magcache_tpu_torch.core.magcache import MagCacheConfig, compute_skip_schedule
from magcache_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = ["StepTimer", "log_skip_schedule", "profile_trace"]


class StepTimer:
    """Accumulate named wall-clock sections; print a summary."""

    def __init__(self):
        self.sections: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> str:
        rows = []
        for name, vals in self.sections.items():
            v = np.asarray(vals)
            rows.append(f"{name:24s} n={len(v):3d} total={v.sum():8.2f}s "
                        f"mean={v.mean():7.3f}s p50={np.median(v):7.3f}s")
        return "\n".join(rows)

    def log_summary(self):
        for line in self.summary().splitlines():
            logger.info(line)


def log_skip_schedule(cfg: MagCacheConfig, name: str = "magcache") -> np.ndarray:
    """Log which forwards the schedule elides and return it."""
    sched = compute_skip_schedule(cfg)
    skipped = np.flatnonzero(sched)
    logger.info(
        "%s: skipping %d/%d forwards (E=%.3g K=%d R=%.2g) at cnt=%s",
        name, len(skipped), cfg.num_steps, cfg.thresh,
        cfg.max_consecutive_skips, cfg.retention_ratio, skipped.tolist())
    return sched


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA when
    a card is present) and write ``<log_dir>/trace.json``; a no-op when
    ``log_dir`` is None or empty. Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
