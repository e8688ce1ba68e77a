"""DPM-Solver++(2M) on flow-matching sigmas, as host-precomputed per-step
coefficients (``magcache_tpu.schedulers.dpm_flow``; Wan's second solver).

With alpha = 1 - sigma, lambda = log(alpha/sigma) and the data prediction
``x0 = x - sigma * v``, step i (sigma_t -> sigma_s, h_i = lambda_s -
lambda_t) is

    x <- c_x * x + c_d * D,    D = a * x0_i + b * x0_{i-1}
    c_x = sigma_s / sigma_t,   c_d = alpha_s - sigma_s * alpha_t / sigma_t
    a = 1 + 1/(2 r_i),  b = -1/(2 r_i),  r_i = h_{i-1} / h_i

and first order (a = 1, b = 0) on the first step (sigma_0 = 1 makes h_0
infinite), wherever h is not finite, and on the last step to sigma = 0
(``lower_order_final``: c_x = 0, c_d = 1 give x = x0). Host numpy in f64,
rounded to f32 once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["dpmpp_2m_flow_coeffs"]


def dpmpp_2m_flow_coeffs(sigmas: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-step DPM++(2M) coefficients for a decreasing flow sigma ladder
    ``sigmas`` ``[n+1]`` (sigma_n may be 0): f32 arrays of length n,
    ``sigma_t``, ``a``, ``b``, ``c_x`` and ``c_d``."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    alpha = 1.0 - sig
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sig)      # +-inf at sigma = 0 / 1
    h = lam[1:] - lam[:-1]
    c_x = sig[1:] / sig[:-1]
    c_d = alpha[1:] - sig[1:] * alpha[:-1] / sig[:-1]
    a = np.ones(n)
    b = np.zeros(n)
    for i in range(1, n):
        hi, hp = h[i], h[i - 1]
        if not np.isfinite(hi) or not np.isfinite(hp) or hi == 0.0:
            continue                           # first order
        if i == n - 1 and sig[-1] == 0.0:
            continue                           # lower_order_final
        r = hp / hi
        a[i] = 1.0 + 1.0 / (2.0 * r)
        b[i] = -1.0 / (2.0 * r)
    return {"sigma_t": sig[:-1].astype(np.float32), "a": a.astype(np.float32),
            "b": b.astype(np.float32), "c_x": c_x.astype(np.float32),
            "c_d": c_d.astype(np.float32)}
