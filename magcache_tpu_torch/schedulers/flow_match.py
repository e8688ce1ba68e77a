"""Flow-matching (rectified flow) sigma schedules with shift.

Wan samples UniPC on this sigma grid: ``linspace(sigma_max, sigma_min,
n+1)[:-1]``, static shift ``shift*s / (1 + (shift-1)*s)`` (or FLUX's dynamic
``mu`` shift on ``linspace(1, 1/n, n)``), terminal sigma appended,
``timesteps = sigmas * T``. All of it is host numpy, computed once per run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["FlowMatchSchedule"]


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """Precomputed sigma/timestep tables."""

    sigmas: np.ndarray      # f32[num_steps + 1], descending, terminal appended
    timesteps: np.ndarray   # f32[num_steps], what the model sees

    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(
        num_steps: int,
        *,
        shift: float = 1.0,
        mu: Optional[float] = None,
        sigma_max: float = 1.0,
        sigma_min: float = 0.0,
        num_train_timesteps: int = 1000,
        final_sigma_zero: bool = True,
        linspace_endpoint: bool = False,
    ) -> "FlowMatchSchedule":
        if linspace_endpoint:
            sigmas = np.linspace(sigma_max, sigma_max / num_steps, num_steps)
        else:
            sigmas = np.linspace(sigma_max, sigma_min, num_steps + 1)[:-1]
        if mu is not None:
            sigmas = np.exp(mu) / (np.exp(mu) + (1.0 / sigmas - 1.0))
        elif shift != 1.0:
            sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
        sigma_last = 0.0 if final_sigma_zero else float(sigmas[-1])
        sigmas = np.concatenate([sigmas, [sigma_last]]).astype(np.float32)
        timesteps = (sigmas[:-1] * num_train_timesteps).astype(np.float32)
        return FlowMatchSchedule(sigmas, timesteps, num_train_timesteps)

    def boundary_step(self, boundary: float) -> int:
        """The Wan2.2 MoE's expert switch: the number of steps with ``t >=
        boundary * T``, which the high-noise expert runs."""
        return int((self.timesteps >= boundary * self.num_train_timesteps).sum())

    @staticmethod
    def flux_mu(seq_len: int, base_len: int = 256, max_len: int = 4096,
                base_shift: float = 0.5, max_shift: float = 1.15) -> float:
        """FLUX's resolution-dependent mu, linear in the image token count."""
        m = (max_shift - base_shift) / (max_len - base_len)
        return seq_len * m + (base_shift - base_len * m)
