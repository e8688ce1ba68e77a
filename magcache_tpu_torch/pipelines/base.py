"""Pipeline base: the ``Config -> Pipeline.generate()`` convention."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class PipelineOutput:
    latents: torch.Tensor                # f32 [B, F, H, W, C]; no VAE yet
    calibration: Optional[dict] = None   # calibration-mode artifacts
    timings: Optional[dict] = None
    skips: Optional[np.ndarray] = None   # realized skip bits [steps, lanes]


class BasePipeline:
    """``generate(...)`` is the single entry point; ``__call__`` aliases it."""

    def generate(self, prompt, **kwargs) -> PipelineOutput:
        raise NotImplementedError

    def __call__(self, *args, **kwargs) -> PipelineOutput:
        return self.generate(*args, **kwargs)


def calibration_dict(stats: np.ndarray) -> dict:
    """Flatten calibration stats ``[steps-1, lanes, 3]`` into the reference's
    printed lists (flat forward order, rounded to 5 decimals)."""
    flat = np.asarray(stats).reshape(-1, 3)
    return {
        "norm_ratio": [round(float(v), 5) for v in flat[:, 0]],
        "norm_std": [round(float(v), 5) for v in flat[:, 1]],
        "cos_dis": [round(float(v), 5) for v in flat[:, 2]],
    }
