"""Rank-0-gated logging (counterpart of ``magcache_tpu.utils.logging``; the
reference gates on rank 0, ``videosys/utils/logging.py:15-29``)."""

from __future__ import annotations

import logging
import sys


def _is_primary() -> bool:
    """Rank 0 of an initialised ``torch.distributed`` process group, or any
    process outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def get_logger(name: str = "magcache_tpu_torch") -> logging.Logger:
    """A logger that writes INFO to stdout on the primary process and
    nothing elsewhere."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    if _is_primary():
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s] %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    else:
        logger.addHandler(logging.NullHandler())
    return logger
