"""The port's UniPC sampler, MagCache cache branches and calibration
against the JAX package's, in f32 at ``WanConfig.tiny()``, with the same
weights (converted by ``wan_params_from_numpy``) and the same numpy inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.calibration import calibration_stats as j_stats
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import wan as jwan
from magcache_tpu.models.text import MockTextEncoder as JMock
from magcache_tpu.schedulers.unipc import UniPCSchedule as JUniPC
from magcache_tpu_torch.core import sampler as tsampler
from magcache_tpu_torch.core.calibration import calibration_stats
from magcache_tpu_torch.core.presets import make_config as t_make_config
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.schedulers.unipc import UniPCSchedule as TUniPC

# 4 steps: 0 full, 1 all-skip, 2 cond-only skip, 3 uncond-only skip
MASK = np.array([[0, 0], [1, 1], [1, 0], [0, 1]], bool)


def _sampler_setup(grid=(2, 4, 4)):
    cfg = twan.WanConfig.tiny()
    params = jwan.init_wan_params(jax.random.PRNGKey(5), jwan.WanConfig.tiny())
    model = twan.WanModel(cfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"))
    rng = np.random.default_rng(6)
    f, h, w = grid
    x = rng.standard_normal((1, f, 2 * h, 2 * w, cfg.in_channels)).astype(np.float32)
    ctx = JMock(cfg.text_len, cfg.text_dim, scale=0.5)(["a cat", "blurry"])
    return (jwan.make_wan_core(jwan.WanConfig.tiny(), grid), params,
            twan.make_wan_core(model, grid), x, np.array(ctx))


def test_sample_unipc_with_partial_lane_skips_matches_jax():
    jcore, params, tcore, x, ctx = _sampler_setup()
    n = len(MASK)
    jsch, tsch = JUniPC.create(n, shift=5.0), TUniPC.create(n, shift=5.0)
    want, jskips = jsampler.sample_unipc(
        jcore, params, jnp.asarray(x), {"context": jnp.asarray(ctx)}, jsch,
        cache_cfg=j_make_config("wan2.1-t2v-1.3B", n), guidance_scale=5.0,
        skip_mask_override=jnp.asarray(MASK), return_skips=True)
    got, tskips = tsampler.sample_unipc(
        tcore, torch.from_numpy(x), {"context": torch.from_numpy(ctx)}, tsch,
        cache_cfg=t_make_config("wan2.1-t2v-1.3B", n), guidance_scale=5.0,
        skip_mask_override=MASK, return_skips=True)
    np.testing.assert_array_equal(tskips, np.asarray(jskips))
    # f32, 4 UniPC steps through a 2-block trunk: summation order only,
    # compounded over the steps -> 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_sample_unipc_schedule_and_full_compute_match_jax():
    jcore, params, tcore, x, ctx = _sampler_setup()
    n = 10
    jsch, tsch = JUniPC.create(n, shift=5.0), TUniPC.create(n, shift=5.0)
    for use_cache in (False, True):
        jc = j_make_config("wan2.1-t2v-1.3B", n) if use_cache else None
        tc = t_make_config("wan2.1-t2v-1.3B", n) if use_cache else None
        want = jsampler.sample_unipc(jcore, params, jnp.asarray(x),
                                     {"context": jnp.asarray(ctx)}, jsch,
                                     cache_cfg=jc, guidance_scale=5.0)
        got, skips = tsampler.sample_unipc(
            tcore, torch.from_numpy(x), {"context": torch.from_numpy(ctx)}, tsch,
            cache_cfg=tc, guidance_scale=5.0, return_skips=True)
        assert int(skips.sum()) == (10 if use_cache else 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_partial_lane_step_runs_half_batch_trunk():
    _, _, tcore, x, ctx = _sampler_setup()
    seen = []

    def spy(h, c):
        seen.append(h.shape[0])
        return tcore.trunk(h, c)

    spy_core = dataclasses.replace(tcore, trunk=spy)
    tsampler.sample_unipc(spy_core, torch.from_numpy(x),
                          {"context": torch.from_numpy(ctx)},
                          TUniPC.create(len(MASK), shift=5.0),
                          cache_cfg=t_make_config("wan2.1-t2v-1.3B", len(MASK)),
                          guidance_scale=5.0, skip_mask_override=MASK)
    assert seen == [2, 1, 1]      # full, (all-skip: none), cond-only, uncond-only


def test_calibrate_unipc_matches_jax():
    jcore, params, tcore, x, ctx = _sampler_setup()
    n = 5
    jsch, tsch = JUniPC.create(n, shift=5.0), TUniPC.create(n, shift=5.0)
    jx, jstats = jsampler.calibrate_unipc(jcore, params, jnp.asarray(x),
                                          {"context": jnp.asarray(ctx)}, jsch,
                                          lanes=2, guidance_scale=5.0)
    tx, tstats = tsampler.calibrate_unipc(tcore, torch.from_numpy(x),
                                          {"context": torch.from_numpy(ctx)}, tsch,
                                          lanes=2, guidance_scale=5.0)
    assert tstats.shape == (n - 1, 2, 3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4, rtol=1e-4)
    # ratios of f32 norms; cos distances near 0 need an absolute floor
    np.testing.assert_allclose(tstats, np.asarray(jstats), atol=1e-5, rtol=1e-4)


def test_calibration_stats_matches_jax():
    rng = np.random.default_rng(9)
    r, p = (rng.standard_normal((2, 40, 16)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        calibration_stats(torch.from_numpy(r), torch.from_numpy(p)).numpy(),
        np.asarray(j_stats(jnp.asarray(r), jnp.asarray(p))), atol=1e-6, rtol=1e-5)
