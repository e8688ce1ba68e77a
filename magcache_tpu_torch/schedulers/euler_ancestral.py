"""Euler-Ancestral schedule on DDPM betas (Open-Sora-Plan v1.2's sampler), the
``magcache_tpu.schedulers.euler_ancestral`` schedule, host numpy only.

The reference's OSP pipeline denoises with diffusers'
``EulerAncestralDiscreteScheduler`` (v1.2 branch of
``videosys/pipelines/open_sora_plan/pipeline_open_sora_plan.py:302-306``;
v1.0/1.1 use PNDM). Semantics reproduced as host-precomputed arrays for the
linear-update sampler (``core.sampler.sample_euler``):

k-sigma space over DDPM alphas: ``sigma_t = sqrt((1 - abar_t)/abar_t)``,
model input scaled by ``1/sqrt(sigma^2 + 1)`` (``scale_model_input``), and the
ancestral split per step::

    sigma_up   = sqrt(s2^2 * (s1^2 - s2^2) / s1^2)
    sigma_down = sqrt(s2^2 - sigma_up^2)
    x <- x + (sigma_down - s1) * eps + sigma_up * z

which maps onto the sampler's ``x + dt*v + ns*z`` with ``dt = sigma_down - s1``
and ``ns = sigma_up`` (epsilon prediction). Initial latents scale by
``init_noise_sigma = sigma_max``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EulerAncestralSchedule"]


@dataclasses.dataclass(frozen=True)
class EulerAncestralSchedule:
    timesteps: np.ndarray      # f32[n] train-timestep values fed to the model
    sigmas: np.ndarray         # f32[n+1] (terminal 0)
    dts: np.ndarray            # f32[n] = sigma_down - sigma
    noise_scales: np.ndarray   # f32[n] = sigma_up
    in_scales: np.ndarray      # f32[n] = 1/sqrt(sigma^2+1)
    init_noise_sigma: float

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, train_steps: int = 1000,
               beta_start: float = 0.0001, beta_end: float = 0.02,
               beta_schedule: str = "linear") -> "EulerAncestralSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, train_steps,
                                dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                train_steps, dtype=np.float64) ** 2
        else:
            raise ValueError(beta_schedule)
        abar = np.cumprod(1.0 - betas)
        sig_all = np.sqrt((1.0 - abar) / abar)

        # diffusers linspace timestep spacing: high -> low
        ts = np.linspace(0, train_steps - 1, num_steps, dtype=np.float64)[::-1]
        sigmas = np.interp(ts, np.arange(train_steps), sig_all)
        sigmas = np.concatenate([sigmas, [0.0]])

        s1, s2 = sigmas[:-1], sigmas[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            sigma_up = np.where(
                s1 > 0, np.sqrt(np.maximum(s2 ** 2 * (s1 ** 2 - s2 ** 2), 0.0)
                                / np.maximum(s1 ** 2, 1e-20)), 0.0)
        sigma_down = np.sqrt(np.maximum(s2 ** 2 - sigma_up ** 2, 0.0))
        return EulerAncestralSchedule(
            timesteps=ts.astype(np.float32),
            sigmas=sigmas.astype(np.float32),
            dts=(sigma_down - s1).astype(np.float32),
            noise_scales=sigma_up.astype(np.float32),
            in_scales=(1.0 / np.sqrt(sigmas[:-1] ** 2 + 1.0)).astype(np.float32),
            init_noise_sigma=float(sigmas[0]),
        )
