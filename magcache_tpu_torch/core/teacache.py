"""TeaCache, the activation-gated comparator cache (``magcache_tpu.core.
teacache``; reference ``eval/magcache/experiments/opensora.py:34-227`` and
``Wan2.1_EVAL/wan_teacache.py:533-590``).

Each step computes a signal from the step's embeddings (the modulated input
of the first block; Wan: its time embedding ``e`` or the 6-way ``e0``),
accumulates the polynomial-rescaled relative L1 distance to the previous
step's signal, and skips the trunk while the accumulator stays under the
threshold, resetting on compute; the window edges always compute. Unlike
MagCache the decision depends on activations: the samplers take it through
``dynamic_skip`` (``TeaCacheLanes``), whose step decision reads the
per-lane distances to the host, a few floats a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from magcache_tpu_torch.core.sampler import DiTCore, _cfg_combine, _stack_lanes

__all__ = ["TeaCacheConfig", "sample_euler_teacache", "OPEN_SORA_TEA_COEFFS",
           "TeaCacheLanes", "wan_teacache_settings", "WAN_TEA_COEFFS",
           "FRAMEPACK_TEA_COEFFS", "FRAMEPACK_TEA_THRESH", "default_tea_signal"]

# rescale polynomial fitted for Open-Sora (opensora.py:100)
OPEN_SORA_TEA_COEFFS = (2.17546007e2, -1.18329252e2, 2.68662585e1,
                        -4.59364272e-2, 4.84426240e-2)

# the published Wan rescale polynomials, keyed (model_key, use_ret_steps)
# (``wan_teacache.py:913-928`` for t2v, ``:1025-1038`` for i2v)
WAN_TEA_COEFFS = {
    ("t2v-1.3B", True): (-5.21862437e4, 9.23041404e3, -5.28275948e2,
                         1.36987616e1, -4.99875664e-2),
    ("t2v-14B", True): (-3.03318725e5, 4.90537029e4, -2.65530556e3,
                        5.87365115e1, -3.15583525e-1),
    ("t2v-1.3B", False): (2.39676752e3, -1.31110545e3, 2.01331979e2,
                          -8.29855975e0, 1.37887774e-1),
    ("t2v-14B", False): (-5784.54975374, 5449.50911966, -1811.16591783,
                         256.27178429, -13.02252404),
    ("i2v-480P", True): (2.57151496e5, -3.54229917e4, 1.40286849e3,
                         -1.35890334e1, 1.32517977e-1),
    ("i2v-720P", True): (8.10705460e3, 2.13393892e3, -3.72934672e2,
                         1.66203073e1, -4.17769401e-2),
    ("i2v-480P", False): (-3.02331670e2, 2.23948934e2, -5.25463970e1,
                          5.87348440e0, -2.01973289e-1),
    ("i2v-720P", False): (-114.36346466, 65.26524496, -18.82220707,
                          4.91518089, -0.23412683),
}

# FramePack's packed-HunyuanVideo polynomial and default threshold (the
# public FramePack release's constants; one lane, CFG-distilled)
FRAMEPACK_TEA_COEFFS = (7.33226126e2, -4.01131952e2, 6.75869174e1,
                        -3.14987800e0, 9.61237896e-2)
FRAMEPACK_TEA_THRESH = 0.15


def wan_teacache_settings(model_key: str, sample_steps: int, use_ret_steps: bool):
    """``(coefficients, ret_steps, cutoff_steps)``, the window in forward
    counts (2 a scheduler step). ``use_ret_steps``: the ``e0`` signal, ret
    10*2 for t2v and 5*2 for i2v, no cutoff; else the ``e`` signal, ret 1*2,
    cutoff 2n-2 (``wan_teacache.py:913-928``)."""
    coeffs = WAN_TEA_COEFFS[(model_key, use_ret_steps)]
    if use_ret_steps:
        return coeffs, (10 if model_key.startswith("t2v") else 5) * 2, sample_steps * 2
    return coeffs, 2, sample_steps * 2 - 2


def _polyval(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Horner in f32, as ``jnp.polyval``: ``y = y * x + c`` from the
    highest power down."""
    y = np.zeros_like(x)
    for c in coeffs:
        y = y * x + c
    return y


def _rel_l1(sig: torch.Tensor, prev: torch.Tensor, groups: int) -> np.ndarray:
    """``mean|sig - prev| / max(mean|prev|, 1e-8)`` per group of rows, on
    the host as f32 ``[groups]`` (one small device-to-host copy)."""
    s = sig.reshape(groups, -1)
    p = prev.reshape(groups, -1)
    num = (s - p).abs().mean(1)
    den = p.abs().mean(1).clamp_min(1e-8)
    return (num / den).float().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class TeaCacheLanes:
    """Per-lane TeaCache for the samplers' ``dynamic_skip``: each CFG lane
    keeps its own previous signal, accumulator and residual and decides on
    its own (the Wan eval's even/odd design, ``wan_teacache.py:533-590``).
    The forced window (forward index < ``ret_steps`` or >= ``cutoff_steps``)
    is static (``forced_mask``). ``signal_fn(hidden, ctx) -> [rows, ...]``
    (Wan: ``ctx["e0"]`` with ret steps, else ``ctx["e"]``)."""

    thresh: float
    coefficients: Tuple[float, ...]
    ret_steps: int                      # forward counts (2 a step)
    cutoff_steps: int
    lanes: int = 2
    signal_fn: Optional[Callable] = None

    def forced_mask(self, num_steps: int) -> np.ndarray:
        """``bool[num_steps, lanes]``: True always computes."""
        fwd = np.arange(num_steps)[:, None] * self.lanes + np.arange(self.lanes)
        return (fwd < self.ret_steps) | (fwd >= self.cutoff_steps)

    def init_state(self, sig: torch.Tensor) -> tuple:
        """``(prev_signal, acc f32[lanes])`` at zero: step 0 is in the forced
        window (ret_steps >= 2), so its distance to zeros is never used."""
        return torch.zeros_like(sig), np.zeros(self.lanes, np.float32)

    def decide(self, hidden, ctx, state, forced_bits: np.ndarray):
        """``(skip bool[lanes], new_state)``: a lane skips when it is not
        forced and its accumulated distance stays under the threshold;
        otherwise its accumulator resets to 0 (``wan_teacache.py:538-564``)."""
        prev, acc = state
        sig = self.signal_fn(hidden, ctx)
        rel = _rel_l1(sig, prev, self.lanes)
        acc_try = acc + _polyval(np.asarray(self.coefficients, np.float32), rel)
        skip = ~np.asarray(forced_bits, bool) & (acc_try < np.float32(self.thresh))
        return skip, (sig, np.where(skip, acc_try, np.float32(0.0)).astype(np.float32))


@dataclasses.dataclass(frozen=True)
class TeaCacheConfig:
    rel_l1_thresh: float = 0.2
    coefficients: Tuple[float, ...] = OPEN_SORA_TEA_COEFFS


def default_tea_signal(core: DiTCore):
    """The trunk input itself as the signal (a model with AdaLN-first blocks
    passes its own modulated-input extractor for reference parity)."""
    return lambda hidden, ctx: hidden


@torch.inference_mode()
def sample_euler_teacache(core: DiTCore, x_init: torch.Tensor, cond, *,
                          timesteps: np.ndarray, dts: np.ndarray,
                          tea_cfg: TeaCacheConfig,
                          signal_fn: Optional[Callable] = None,
                          guidance_scale: Optional[float] = None) -> torch.Tensor:
    """Euler sampler with TeaCache over one cache lane for the whole stacked
    batch (the reference's joint-CFG use): the first and last steps always
    compute (``opensora.py:96-98``)."""
    signal_fn = signal_fn or default_tea_signal(core)
    n_lanes = 2 if guidance_scale is not None else 1
    batch = x_init.shape[0]
    num_steps = len(timesteps)
    coeffs = np.asarray(tea_cfg.coefficients, np.float32)
    ts = np.asarray(timesteps, np.float32)
    dts = np.asarray(dts, np.float32)
    x = x_init
    cache = prev = None
    acc = np.float32(0.0)
    for i in range(num_steps):
        x2 = _stack_lanes(x, n_lanes)
        tvec = torch.full((x2.shape[0],), float(ts[i]), dtype=torch.float32,
                          device=x2.device)
        hidden, ctx = core.prepare(x2, tvec, cond)
        mod = signal_fn(hidden, ctx)
        if cache is None:
            cache, prev = torch.zeros_like(hidden), torch.zeros_like(mod)
        acc_try = acc + _polyval(coeffs, _rel_l1(mod, prev, 1))[0]
        force = i == 0 or i == num_steps - 1
        skip = not force and bool(acc_try < np.float32(tea_cfg.rel_l1_thresh))
        acc = acc_try if skip else np.float32(0.0)
        if skip:
            h_out = hidden + cache
        else:
            h_out = core.trunk(hidden, ctx)
            cache = h_out - hidden
        prev = mod
        out = core.head(h_out, ctx)
        x = x + float(dts[i]) * _cfg_combine(out, guidance_scale, batch).to(x.dtype)
    return x
