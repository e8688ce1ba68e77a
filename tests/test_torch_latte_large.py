"""Latte at frames of more than 2,048 tokens against the JAX package on the
CPU: a 96 x 96 latent grid (48 x 48 = 2,304 tokens a frame, as 768 x 768
pixels give) through the forward on every route and through a PAB run on
the packed route, where the port takes the JAX unfused block (K3,
``attention()``, K5r over groups of T, no K6-K8). The JAX side runs its
unpacked composition (``MAGCACHE_STDIT3_PACKED=0``), the same math in f32,
as the STDiT3 case above 2,048 tokens does in ``tests/test_torch_pab.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import pab as jpab
from magcache_tpu.core import sampler as jsampler
from magcache_tpu.models import latte as J
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.core.sampler import sample_euler
from magcache_tpu_torch.models import latte as T
from magcache_tpu_torch.models.stdit3 import MAX_GROUP_TOKENS
from magcache_tpu_torch.schedulers.ddim_eps import DDIMEpsSchedule
from tests.test_torch_latte import CAP, F32_TOL, _latents_close, _models
from tests.test_torch_pab_routes import LATTE_SMALL
from tests.test_torch_pab import _os_combine

# 2 frames of 48 x 48 patches
GRID = (2, 48, 48)


def _np(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def models():
    return _models("float32", seed=4, depth=1, out_channels=8)


@pytest.mark.parametrize("route", T.ROUTES)
def test_forward_above_2048_tokens_matches_jax(route, models, monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    jcfg, params, model = models
    assert GRID[1] * GRID[2] > MAX_GROUP_TOKENS
    jcore = J.make_latte_core(jcfg, GRID, CAP)
    tcore = T.make_latte_core(model, GRID, CAP, route=route)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2, 96, 96, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, 24)).astype(np.float32)
    t = np.array([600.0, 600.0], np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"y": jnp.asarray(y)})
    want = _np(jax.jit(jcore.head)(params, jax.jit(jcore.trunk)(params, hj, cj), cj))
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)})
    got = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_pab_above_2048_tokens_matches_jax(models, monkeypatch):
    """4 DDIM steps (t = 750, 500, 250, 0) with every window open and the
    MLP anchors at 750: the packed PAB block at 2,304 tokens a frame."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    jcfg, params, model = models
    sch = DDIMEpsSchedule.create(4)
    ts = sch.timesteps.astype(np.float32)
    jcore = J.make_latte_core(jcfg, GRID, CAP, pab=jpab.LattePABConfig(**LATTE_SMALL),
                              timesteps=ts)
    tcore = T.make_latte_core(model, GRID, CAP, pab=tpab.LattePABConfig(**LATTE_SMALL),
                              timesteps=ts)
    c_x, c_eps = sch.step_arrays()
    rng = np.random.default_rng(7)
    z = rng.standard_normal((1, 2, 96, 96, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, 24)).astype(np.float32)
    kw = dict(timesteps=ts, dts=c_eps, x_coeffs=c_x, lanes=2, combine_fn=_os_combine(7.5, 4))
    want = jax.jit(lambda p, z_, c: jsampler.sample_euler(jcore, p, z_, c, **kw))(
        params, jnp.asarray(z), {"y": jnp.asarray(y)})
    got = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)}, **kw)
    _latents_close(got.numpy(), _np(want))
    masks = T.latte_pab_masks(tpab.LattePABConfig(**LATTE_SMALL), ts, 1)
    assert masks["spatial"].any() and masks["cross"].any()
