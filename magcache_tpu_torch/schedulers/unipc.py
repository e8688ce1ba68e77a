"""Flow-matching UniPC multistep solver (predictor-corrector, bh2).

UniPC (Zhao et al., arXiv:2302.04867) in the rectified-flow parameterization
Wan uses:

  x_sigma = (1 - sigma) x0 + sigma eps,   alpha = 1 - sigma,
  lambda = log(alpha / sigma),            the model predicts v = eps - x0,
  data prediction m = x - sigma v.

The sigma grid is static, so every Vandermonde solve and scalar coefficient
is computed on the host in float64, once per run. The sampler casts the
tables to float32 and the device update is a fixed linear combination of
carried model outputs. Same math as ``magcache_tpu.schedulers.unipc``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["UniPCSchedule"]


def _phis(h: float, kmax: int) -> list:
    """phi_1..phi_kmax at z = -h: phi_1(z) = (e^z - 1)/z,
    phi_{k+1}(z) = (phi_k(z) - 1/k!)/z."""
    z = -h
    phis = [math.expm1(z) / z]
    fact = 1.0
    for k in range(1, kmax):
        fact *= k
        phis.append((phis[-1] - 1.0 / fact) / z)
    return phis


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    """Precomputed UniPC coefficients over a FlowMatch sigma grid."""

    sigmas: np.ndarray          # f32[n+1]
    timesteps: np.ndarray       # f32[n]
    order: int = 2
    lower_order_final: bool = True
    use_corrector: bool = True
    num_train_timesteps: int = 1000
    # the corrector is skipped for steps whose lambda jump exceeds this (at
    # the clamped grid ends its polynomial assumption fails)
    max_corrector_h: float = 3.0

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)

    @staticmethod
    def create(num_steps: int, *, shift: float = 1.0, order: int = 2,
               use_corrector: bool = True, **kw) -> "UniPCSchedule":
        from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

        base = FlowMatchSchedule.create(num_steps, shift=shift, **kw)
        return UniPCSchedule(base.sigmas, base.timesteps, order=order,
                             use_corrector=use_corrector)

    def _lam(self, i: int) -> float:
        s = float(self.sigmas[i])
        s = min(max(s, 1e-6), 1.0 - 1e-6)
        return math.log((1.0 - s) / s)

    def _step_order(self, i: int) -> int:
        """Order ramps 1, 2, ..., order and is capped near the final steps
        when ``lower_order_final``."""
        o = min(self.order, i + 1)
        if self.lower_order_final:
            o = min(o, self.num_steps - i)
        return max(1, o)

    def _rhos(self, i: int, order: int, corrector: bool) -> np.ndarray:
        h = self._lam(i + 1) - self._lam(i)
        rks = [(self._lam(i - l) - self._lam(i)) / h for l in range(1, order)]
        if corrector:
            rks.append(1.0)
        if not rks:
            return np.zeros((0,))
        k = len(rks)
        phis = _phis(h, k + 1)
        b_h = math.expm1(-h)  # bh2: B(h) = e^{-h} - 1
        R = np.array([[r ** p for r in rks] for p in range(k)])
        b = np.array(
            [(-h) * phis[p + 1] * math.factorial(p + 1) / b_h for p in range(k)]
        )
        return np.linalg.solve(R, b)

    def predictor_coeffs(self, i: int):
        """(c_x, c_m0, weights, prev_offsets) of
        ``x_{i+1} = c_x x_i + c_m0 m_i + sum_l w_l m_{i-l}``."""
        order = self._step_order(i)
        h = self._lam(i + 1) - self._lam(i)
        s_next, s_cur = float(self.sigmas[i + 1]), float(self.sigmas[i])
        alpha_next = 1.0 - s_next
        c_x = s_next / max(s_cur, 1e-9)
        phi1 = math.expm1(-h)
        c_m0 = -alpha_next * phi1
        b_h = phi1
        w, offsets = [], []
        if order > 1:
            rhos = self._rhos(i, order, corrector=False)
            for l in range(1, order):
                r_l = (self._lam(i - l) - self._lam(i)) / h
                w_l = -alpha_next * b_h * float(rhos[l - 1]) / r_l
                w.append(w_l)
                offsets.append(l)
                c_m0 -= w_l
        return c_x, c_m0, tuple(w), tuple(offsets)

    def corrector_coeffs(self, i: int):
        """Coefficients of the corrector of step i-1 -> i, applied once the
        model output m_i at the predicted x_i is known:
        ``x_i^c = c_x x_{i-1} + c_m0 m_{i-1} + sum_l w_l m_prev + w_t m_i``."""
        j = i - 1
        order = self._step_order(j)
        h = self._lam(j + 1) - self._lam(j)
        s_next, s_cur = float(self.sigmas[j + 1]), float(self.sigmas[j])
        alpha_next = 1.0 - s_next
        c_x = s_next / max(s_cur, 1e-9)
        phi1 = math.expm1(-h)
        c_m0 = -alpha_next * phi1
        b_h = phi1
        rhos = self._rhos(j, order, corrector=True)
        w, offsets = [], []
        for l in range(1, order):
            r_l = (self._lam(j - l) - self._lam(j)) / h
            w_l = -alpha_next * b_h * float(rhos[l - 1]) / r_l
            w.append(w_l)
            offsets.append(l)
            c_m0 -= w_l
        w_t = -alpha_next * b_h * float(rhos[-1])  # D_t = m_i - m_j, r_t = 1
        c_m0 -= w_t
        return c_x, c_m0, tuple(w), tuple(offsets), w_t

    def corrector_ok(self, i: int) -> bool:
        """Whether the corrector runs at step i (correcting i-1 -> i)."""
        if not self.use_corrector or i == 0:
            return False
        h = self._lam(i) - self._lam(i - 1)
        return h <= self.max_corrector_h
