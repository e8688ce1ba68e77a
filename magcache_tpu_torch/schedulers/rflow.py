"""RFLOW, the Open-Sora rectified-flow schedule (``magcache_tpu.schedulers.
rflow``): timesteps ``t_i = (1 - i/n) * T`` with the optional resolution and
duration transform ``t' = r*t / (1 + (r-1) t)``, and the Euler step size
``(t_i - t_{i+1}) / T`` (the last step integrates to zero). Host numpy only;
the sampler applies the update."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RFlowSchedule", "timestep_transform_ratio"]


def timestep_transform_ratio(height: int, width: int, num_frames: int,
                             base_resolution: int = 512 * 512,
                             base_num_frames: int = 1,
                             scale: float = 1.0) -> float:
    """``r = sqrt(HW / 512^2) * sqrt((frames // 17) * 5) * scale``; a single
    frame, or a clip shorter than one 17-frame micro-clip, counts as 1."""
    ratio_space = np.sqrt(height * width / base_resolution)
    frames = 1 if num_frames == 1 else (num_frames // 17) * 5
    frames = max(frames, 1)
    ratio_time = np.sqrt(frames / base_num_frames)
    return float(ratio_space * ratio_time * scale)


@dataclasses.dataclass(frozen=True)
class RFlowSchedule:
    timesteps: np.ndarray      # f32[num_steps], descending, in [0, T]
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, num_train_timesteps: int = 1000,
               use_discrete_timesteps: bool = False,
               use_timestep_transform: bool = False, height: int = 512,
               width: int = 512, num_frames: int = 1,
               transform_scale: float = 1.0) -> "RFlowSchedule":
        ts = np.array([(1.0 - i / num_steps) * num_train_timesteps
                       for i in range(num_steps)], dtype=np.float64)
        if use_discrete_timesteps:
            ts = np.round(ts)
        if use_timestep_transform:
            r = timestep_transform_ratio(height, width, num_frames,
                                         scale=transform_scale)
            t01 = ts / num_train_timesteps
            ts = (r * t01 / (1.0 + (r - 1.0) * t01)) * num_train_timesteps
        return RFlowSchedule(ts.astype(np.float32), num_train_timesteps)

    def dt(self, i: int) -> float:
        """``(t_i - t_{i+1}) / T``; the final step integrates to zero."""
        t = self.timesteps
        raw = t[i] - t[i + 1] if i < self.num_steps - 1 else t[i]
        return float(raw) / self.num_train_timesteps

    def dts(self) -> np.ndarray:
        """Every step's ``dt`` as f32, the update's precision."""
        return np.array([self.dt(i) for i in range(self.num_steps)], np.float32)
