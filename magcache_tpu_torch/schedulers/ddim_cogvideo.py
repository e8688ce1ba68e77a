"""CogVideoX DDIM / DPM schedulers (v-prediction, zero-terminal-SNR).

Behavioral spec from ``videosys/schedulers/scheduling_ddim_cogvideox.py`` and
``scheduling_dpm_cogvideox.py``: scaled-linear betas
(``linspace(sqrt(b0), sqrt(b1))^2``), alphas_cumprod rescaled so the terminal
SNR is exactly zero, v-prediction parameterization, and (DDIM) the
eta=0 deterministic update. All per-step scalars are host-precomputed (the
``magcache_tpu.schedulers.ddim_cogvideo`` schedules, host numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["CogVideoDDIMSchedule", "CogVideoDPMSchedule"]


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift+scale sqrt(alphas_cumprod) so the last step has zero SNR
    (Lin et al. 2024; scheduling_ddim_cogvideox.py rescale)."""
    s = np.sqrt(alphas_cumprod)
    s0, sT = s[0].copy(), s[-1].copy()
    s = s - sT                      # terminal -> 0
    s = s * s0 / (s0 - sT)          # keep the first step value
    return s ** 2


@dataclasses.dataclass(frozen=True)
class CogVideoDDIMSchedule:
    timesteps: np.ndarray          # i32[num_steps], descending
    alphas_cumprod: np.ndarray     # f64[T]
    num_train_timesteps: int = 1000
    final_alpha: float = 1.0

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               snr_shift_scale: float = 3.0) -> "CogVideoDDIMSchedule":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps) ** 2
        acp = np.cumprod(1.0 - betas)
        # CogVideoX SNR shift (scheduling_ddim_cogvideox: snr_shift_scale)
        acp = acp / (snr_shift_scale + (1 - snr_shift_scale) * acp)
        acp = _rescale_zero_terminal_snr(acp)
        step = num_train_timesteps // num_steps
        ts = (np.arange(0, num_steps) * step).round()[::-1].astype(np.int64)
        return CogVideoDDIMSchedule(ts, acp, num_train_timesteps)

    def coeffs(self, i: int) -> Tuple[float, float, float, float]:
        """(a_t, a_prev, x0_from_x, x0_from_v) scalars for step i.

        v-pred: x0 = sqrt(a_t) x - sqrt(1-a_t) v;
        DDIM eta=0: x_prev = sqrt(a_prev) x0 + sqrt(1-a_prev) eps,
        eps = (x - sqrt(a_t) x0) / sqrt(1-a_t).
        """
        t = int(self.timesteps[i])
        a_t = float(self.alphas_cumprod[t])
        if i + 1 < self.num_steps:
            a_prev = float(self.alphas_cumprod[int(self.timesteps[i + 1])])
        else:
            a_prev = self.final_alpha
        return a_t, a_prev, np.sqrt(a_t), np.sqrt(1 - a_t)

    def step_arrays(self):
        """Per-step update as x_prev = c_x * x + c_v * v (host precomputed).

        Derivation: x0 = sa x - sb v; eps = sb x + sa v (v-pred identities);
        x_prev = sqrt(a_p) x0 + sqrt(1-a_p) eps
               = (sqrt(a_p) sa + sqrt(1-a_p) sb) x
                 + (sqrt(1-a_p) sa - sqrt(a_p) sb) v.
        """
        c_x = np.zeros(self.num_steps)
        c_v = np.zeros(self.num_steps)
        for i in range(self.num_steps):
            a_t, a_prev, sa, sb = self.coeffs(i)
            c_x[i] = np.sqrt(a_prev) * sa + np.sqrt(1 - a_prev) * sb
            c_v[i] = np.sqrt(1 - a_prev) * sa - np.sqrt(a_prev) * sb
        return c_x.astype(np.float32), c_v.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class CogVideoDPMSchedule:
    """DPM-Solver++ 2M over the CogVideoX alpha schedule (v-prediction,
    zero-terminal-SNR) — ``scheduling_dpm_cogvideox.py`` equivalent.

    Data-prediction 2M update at step i -> i+1 (abar = sqrt(acp),
    sbar = sqrt(1-acp), lam = log(abar/sbar), h = lam_next - lam,
    r = h_prev / h, phi = e^{-h} - 1):

        D  = (1 + 1/(2r)) m_i - 1/(2r) m_{i-1}
        x' = (sbar_next / sbar) x - abar_next phi D

    All coefficients are static; the device step is a linear combination of
    (x, m_i, m_{i-1}), with m = abar x - sbar v.
    """

    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, **kw) -> "CogVideoDPMSchedule":
        base = CogVideoDDIMSchedule.create(num_steps, **kw)
        return CogVideoDPMSchedule(base.timesteps, base.alphas_cumprod,
                                   base.num_train_timesteps)

    def _abar_sbar_lam(self, i: int):
        t = int(self.timesteps[i])
        a = float(np.clip(self.alphas_cumprod[t], 1e-12, 1 - 1e-12))
        ab, sb = np.sqrt(a), np.sqrt(1 - a)
        return ab, sb, np.log(ab / sb)

    def step_arrays(self):
        """(c_x, c_m0, c_m1, sa, sb): x' = c_x x + c_m0 m_i + c_m1 m_{i-1},
        m = sa x - sb v. The terminal step targets acp=1 (clean sample)."""
        n = self.num_steps
        c_x = np.zeros(n); c_m0 = np.zeros(n); c_m1 = np.zeros(n)
        sa = np.zeros(n); sb = np.zeros(n)
        lams = [self._abar_sbar_lam(i) for i in range(n)]
        for i in range(n):
            ab_t, sb_t, lam_t = lams[i]
            sa[i], sb[i] = ab_t, sb_t
            if i + 1 < n:
                ab_n, sb_n, lam_n = lams[i + 1]
            else:
                ab_n, sb_n, lam_n = 1.0, 1e-6, np.log(1.0 / 1e-6)
            h = lam_n - lam_t
            phi = np.expm1(-h)
            if i == 0:
                w0, w1 = 1.0, 0.0          # first step: order 1
            else:
                h_prev = lam_t - lams[i - 1][2]
                r = h_prev / h
                w0, w1 = 1.0 + 1.0 / (2 * r), -1.0 / (2 * r)
            c_x[i] = sb_n / sb_t
            c_m0[i] = -ab_n * phi * w0
            c_m1[i] = -ab_n * phi * w1
        return (c_x.astype(np.float32), c_m0.astype(np.float32),
                c_m1.astype(np.float32), sa.astype(np.float32),
                sb.astype(np.float32))
