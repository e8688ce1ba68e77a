"""Epsilon-prediction DDIM with eta = 0 (diffusers ``DDIMScheduler``), the
schedule of ``magcache_tpu.schedulers.ddim_eps``: linear betas 1e-4..0.02
over 1,000 training steps, "leading" timestep spacing (``arange(n) *
(1000 // n)``, descending, plus ``steps_offset``) and ``set_alpha_to_one``.

With eta = 0 and no sample clipping the step is linear in (x, eps)::

    x_prev = sqrt(a_prev / a_t) x + (sqrt(1 - a_prev) - sqrt(a_prev / a_t)
             sqrt(1 - a_t)) eps

so ``sample_euler`` runs it with ``x_coeffs = c_x`` and ``dts = c_eps``.
Host numpy only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DDIMEpsSchedule"]


@dataclasses.dataclass(frozen=True)
class DDIMEpsSchedule:
    timesteps: np.ndarray          # i64[num_steps], descending
    alphas_cumprod: np.ndarray     # f64[num_train_timesteps]
    num_train_timesteps: int = 1000
    final_alpha: float = 1.0       # alpha of the step after the last

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, num_train_timesteps: int = 1000,
               beta_start: float = 0.0001, beta_end: float = 0.02,
               beta_schedule: str = "linear", steps_offset: int = 0,
               set_alpha_to_one: bool = True) -> "DDIMEpsSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        else:
            raise ValueError(f"unsupported beta_schedule {beta_schedule!r}")
        acp = np.cumprod(1.0 - betas)
        step = num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * step).round()[::-1].astype(np.int64) + steps_offset
        final_alpha = 1.0 if set_alpha_to_one else float(acp[0])
        return DDIMEpsSchedule(ts, acp, num_train_timesteps, final_alpha)

    def step_arrays(self):
        """``(c_x, c_eps)`` f32[num_steps]: ``x_prev = c_x * x + c_eps * eps``,
        computed in f64."""
        a_t = self.alphas_cumprod[self.timesteps]
        a_prev = np.append(self.alphas_cumprod[self.timesteps[1:]], self.final_alpha)
        c_x = np.sqrt(a_prev / a_t)
        c_e = np.sqrt(1 - a_prev) - c_x * np.sqrt(1 - a_t)
        return c_x.astype(np.float32), c_e.astype(np.float32)
