"""The port's host math against the JAX package's: skip schedules, ratio
installation, calibration data, FlowMatch and UniPC coefficients.

All of it is numpy on both sides, so schedules must be bit-identical and the
f64 UniPC coefficients equal to 1e-12 (the same float64 operations in the
same order; the margin only absorbs a last-bit difference of libm).
"""

import numpy as np
import pytest

from magcache_tpu.core import magcache as jmag
from magcache_tpu.core import presets as jpresets
from magcache_tpu.data import get_calibrated_ratios as j_ratios
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JFlow
from magcache_tpu.schedulers.unipc import UniPCSchedule as JUniPC
from magcache_tpu_torch.core import magcache as tmag
from magcache_tpu_torch.core import presets as tpresets
from magcache_tpu_torch.data import available_ratio_keys
from magcache_tpu_torch.data import get_calibrated_ratios as t_ratios
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule as TFlow
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule as TUniPC

STEP_COUNTS = (4, 10, 20, 28, 50, 75)


@pytest.mark.parametrize("preset", sorted(jpresets.PRESETS))
def test_skip_schedule_bit_identical(preset):
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    for steps in STEP_COUNTS:
        for kw in ({}, {"thresh": 0.24, "K": 6}, {"retention_ratio": 0.1}):
            jc = jpresets.make_config(preset, steps, **kw)
            tc = tpresets.make_config(preset, steps, **kw)
            assert tc.mag_ratios == jc.mag_ratios
            np.testing.assert_array_equal(tmag.compute_skip_schedule(tc),
                                          jmag.compute_skip_schedule(jc))


@pytest.mark.parametrize("E,K,want", [(0.12, 2, 50), (0.12, 4, 58), (0.24, 6, 64)])
def test_wan13b_reference_skip_counts(E, K, want):
    cfg = tpresets.make_config("wan2.1-t2v-1.3B", 50, thresh=E, K=K,
                               retention_ratio=0.2)
    assert int(tmag.compute_skip_schedule(cfg).sum()) == want


@pytest.mark.parametrize("split,mode", [(None, "t2v"), (40, "t2v"), (40, "i2v")])
def test_quirk_flags_match(split, mode):
    rng = np.random.default_rng(0)
    ratios = 1.0 + 0.02 * rng.standard_normal(100)
    for kw in ({}, {"gate_rounds": True, "err_inclusive": True,
                    "forced_compute_canonical": (11,), "canonical_num_steps": 28},
               {"min_gate_step": 1, "max_ratio_deviation": 0.06}):
        args = dict(num_steps=100, mag_ratios=tuple(ratios), thresh=0.1,
                    max_consecutive_skips=3, lanes=2, split_step=split,
                    mode=mode, **kw)
        np.testing.assert_array_equal(
            tmag.compute_skip_schedule(tmag.MagCacheConfig(**args)),
            jmag.compute_skip_schedule(jmag.MagCacheConfig(**args)))


def test_ratio_installation_and_data_match():
    for key in available_ratio_keys():
        for padded in (False, True):
            np.testing.assert_array_equal(t_ratios(key, padded=padded),
                                          j_ratios(key, padded=padded))
    raw = t_ratios("wan2.1-t2v-1.3B")
    for n in (1, 7, 50, 100, 150):
        np.testing.assert_array_equal(tmag.nearest_interp(raw, n),
                                      jmag.nearest_interp(raw, n))
    for lanes, steps in ((1, 33), (2, 40), (2, 100)):
        np.testing.assert_array_equal(
            tmag.prepare_mag_ratios(raw, steps, lanes=lanes),
            jmag.prepare_mag_ratios(raw, steps, lanes=lanes))


def test_unknown_preset_fails_with_key_list():
    with pytest.raises(KeyError, match="known"):
        tpresets.make_config("no-such-model", 10)
    assert tpresets.make_config("flux", 28).thresh == 0.24   # "-dev" shorthand


@pytest.mark.parametrize("steps,shift", [(4, 5.0), (20, 5.0), (50, 5.0), (50, 8.0)])
def test_unipc_coefficients_match(steps, shift):
    j, t = JUniPC.create(steps, shift=shift), TUniPC.create(steps, shift=shift)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for i in range(steps):
        jp, tp = j.predictor_coeffs(i), t.predictor_coeffs(i)
        np.testing.assert_allclose(tp[:2], jp[:2], rtol=0, atol=1e-12)
        np.testing.assert_allclose(tp[2], jp[2], rtol=0, atol=1e-12)
        assert tp[3] == jp[3]
        assert t.corrector_ok(i) == j.corrector_ok(i)
        if j.corrector_ok(i):
            jc, tc = j.corrector_coeffs(i), t.corrector_coeffs(i)
            np.testing.assert_allclose(
                np.r_[tc[0], tc[1], tc[2], tc[4]],
                np.r_[jc[0], jc[1], jc[2], jc[4]], rtol=0, atol=1e-12)


def test_flow_match_shift_and_mu_match():
    for kw in ({"shift": 3.0}, {"mu": 0.8}, {"linspace_endpoint": True},
               {"final_sigma_zero": False}):
        j, t = JFlow.create(12, **kw), TFlow.create(12, **kw)
        np.testing.assert_array_equal(t.sigmas, j.sigmas)
        np.testing.assert_array_equal(t.timesteps, j.timesteps)
