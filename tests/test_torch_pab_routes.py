"""Pyramid Attention Broadcast on the routes and inputs the port added it
to, against the JAX package on the CPU: STDiT3 under PAB on its "grouped"
and "vpu" routes through ``sample_euler`` (with and without a MagCache
skip), STDiT3 under PAB with masked frames on all three routes through
``sample_rflow_masked`` (the JAX re-noise draws fed in), and Latte under PAB
on "grouped" and "vpu" through DDIM's ``sample_euler``, over enough steps
that every site both reuses and refreshes.

The JAX side runs its unpacked composition (``MAGCACHE_STDIT3_PACKED=0``;
``MAGCACHE_TINY_ATTN`` names the route, which off the TPU takes the
reference) or, for the packed route with masked frames, its packed path
with the Pallas kernels in interpret mode. f32 on both sides, the same
weights and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import pab as jpab
from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import latte as JL
from magcache_tpu.models import stdit3 as JS
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.core.presets import make_config as t_make_config
from magcache_tpu_torch.core.sampler import sample_euler, sample_rflow_masked
from magcache_tpu_torch.models import latte as TL
from magcache_tpu_torch.models import stdit3 as TS
from magcache_tpu_torch.schedulers.ddim_eps import DDIMEpsSchedule
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule
from tests.test_torch_latte import _latents_close
from tests.test_torch_latte import _models as latte_models
from tests.test_torch_opensora_masked import CAP, NARROW, PIPE_TOL, _jax_noise, _models
from tests.test_torch_pab import J_SMALL_PAB, SMALL_PAB, _os_combine

GRID, PIXELS = (3, 3, 5), (48, 80)


def _np(a):
    return np.asarray(a, np.float32)


def _os_inputs(seed):
    rng = np.random.default_rng(seed)
    t_len, h, w = GRID
    z = rng.standard_normal((1, t_len, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    return z, y


def _jax_env(monkeypatch, route):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret" if route == "packed" else "0")
    if route != "packed":
        monkeypatch.setenv("MAGCACHE_TINY_ATTN", route)


# ------------------------------------------------------------------ STDiT3
@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("route", ["grouped", "vpu"])
def test_stdit3_pab_unpacked_routes_match_jax(route, cached, monkeypatch):
    """6 RFLOW steps under ``SMALL_PAB`` (every site reuses); with
    ``cached`` step 2 skips the trunk, so step 3 reuses what step 1 cached."""
    _jax_env(monkeypatch, route)
    steps = 6
    sch = RFlowSchedule.create(steps)
    jcfg, params, model = _models()
    jcore = JS.make_stdit3_core(jcfg, GRID, CAP, pab=J_SMALL_PAB, timesteps=sch.timesteps,
                                pixel_size=PIXELS)
    tcore = TS.make_stdit3_core(model, GRID, route=route, pab=SMALL_PAB,
                                timesteps=sch.timesteps, pixel_size=PIXELS)
    z, y = _os_inputs(4)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2, combine_fn=_os_combine(7.0, 4))
    tkw, jkw = dict(kw), dict(kw)
    if cached:
        mask = np.array([[0], [0], [1], [0], [1], [0]], bool)
        tkw.update(cache_cfg=t_make_config("opensora-v1.2", steps), skip_mask_override=mask)
        jkw.update(cache_cfg=j_make_config("opensora-v1.2", steps),
                   skip_mask_override=jnp.asarray(mask))
    want = jax.jit(lambda p, z_, c: jsampler.sample_euler(jcore, p, z_, c, **jkw))(
        params, jnp.asarray(z), {"y": jnp.asarray(y)})
    got = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)}, **tkw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=PIPE_TOL, rtol=PIPE_TOL)
    masks = tpab.broadcast_masks(SMALL_PAB, sch.timesteps)
    assert all(masks[k].any() for k in ("spatial", "temporal", "cross", "mlp"))


@pytest.mark.parametrize("route", TS.ROUTES)
def test_stdit3_pab_masked_frames_match_jax(route, monkeypatch):
    """A frozen first frame and an edit ratio (re-noised mid-run, the JAX
    draws fed in) under ``SMALL_PAB`` with a MagCache schedule, through
    both masked samplers."""
    _jax_env(monkeypatch, route)
    steps = 6
    jcfg, params, model = _models(seed=2)
    sch = RFlowSchedule.create(steps, use_timestep_transform=True, height=48, width=80,
                               num_frames=9)
    jcore = JS.make_stdit3_core(jcfg, GRID, CAP, pab=J_SMALL_PAB, timesteps=sch.timesteps,
                                pixel_size=PIXELS)
    tcore = TS.make_stdit3_core(model, GRID, route=route, pab=SMALL_PAB,
                                timesteps=sch.timesteps, pixel_size=PIXELS)
    z, y = _os_inputs(3)
    fps = np.full((2,), 24.0, np.float32)
    mask = np.array([[0.0, 0.5, 1.0]], np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2, combine_fn=_os_combine(7.0, 4),
              num_train_timesteps=sch.num_train_timesteps, return_skips=True)
    ecfg = dict(thresh=0.24, K=3)
    want = jax.jit(lambda p, z_, c, m: jsampler.sample_rflow_masked(
        jcore, p, z_, c, mask=m, noise_key=key,
        cache_cfg=j_make_config("opensora-v1.2", steps, **ecfg), **kw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y), "fps": jnp.asarray(fps)},
            jnp.asarray(mask))
    got = sample_rflow_masked(
        tcore, torch.from_numpy(z), {"y": torch.from_numpy(y), "fps": torch.from_numpy(fps)},
        mask=mask, noise_fn=_jax_noise(key),
        cache_cfg=t_make_config("opensora-v1.2", steps, **ecfg), **kw)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=PIPE_TOL, rtol=PIPE_TOL)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy()[0, 0], z[0, 0])


# ------------------------------------------------------------------- Latte
# DDIM over 8 steps (t = 875, 750, ..., 0): every site's window open, and
# the MLPs of both blocks anchored at t = 750
LATTE_SMALL = dict(spatial_threshold=(0, 1000), temporal_threshold=(0, 1000),
                   cross_threshold=(0, 1000),
                   mlp_spatial_config=((750, (0, 1), 2),),
                   mlp_temporal_config=((750, (0, 1), 2),))


@pytest.mark.parametrize("route", ["grouped", "vpu"])
def test_latte_pab_unpacked_routes_match_jax(route, monkeypatch):
    _jax_env(monkeypatch, route)
    steps, grid = 8, (4, 3, 5)
    jcfg, params, model = latte_models("float32", seed=3)
    sch = DDIMEpsSchedule.create(steps)
    ts = sch.timesteps.astype(np.float32)
    tpc, jpc = tpab.LattePABConfig(**LATTE_SMALL), jpab.LattePABConfig(**LATTE_SMALL)
    jcore = JL.make_latte_core(jcfg, grid, CAP, pab=jpc, timesteps=ts)
    tcore = TL.make_latte_core(model, grid, CAP, route=route, pab=tpc, timesteps=ts)
    c_x, c_eps = sch.step_arrays()
    rng = np.random.default_rng(5)
    z = rng.standard_normal((1, 4, 6, 10, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, 24)).astype(np.float32)
    kw = dict(timesteps=ts, dts=c_eps, x_coeffs=c_x, lanes=2,
              combine_fn=_os_combine(7.5, 4))
    want = jax.jit(lambda p, z_, c: jsampler.sample_euler(jcore, p, z_, c, **kw))(
        params, jnp.asarray(z), {"y": jnp.asarray(y)})
    got = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)}, **kw)
    _latents_close(got.numpy(), _np(want))
    masks = TL.latte_pab_masks(tpc, ts, 2)
    assert all(masks[k].any() for k in ("spatial", "temporal", "cross", "mlp_sp_reuse",
                                        "mlp_tp_save"))
