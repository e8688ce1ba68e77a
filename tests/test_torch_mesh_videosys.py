"""STDiT3, Latte and Open-Sora-Plan v1.2 on the (dp, sp, tp) grid on the CPU,
in f32, at tiny widths (4 heads), on local ranks (threads of this process).

- the STDiT3 and Latte forwards on the packed route (spatial blocks on a
  frames shard, temporal ones on a tokens shard, the ``sharded_*``
  wrappers) and on the unpacked composition (Ulysses over each frame) at dp
  2 x sp 2 x tp 2, sp 2 and tp 2, and at a grid whose 3 frames and 15
  tokens a frame divide by neither dp x sp nor sp;
- OSP v1.2 (its unpacked blocks under a plan, on either route) at the
  same grids;
- each against one rank, and against the JAX forward: one grid of each
  family under ``use_mesh`` with ``shard_params`` (the packed kernels in
  interpret mode, as ``tests/test_packed_mesh.py`` runs them), the others
  against the JAX single-device forward;
- masked frames and PAB under a plan against one rank;
- the refusals, naming the counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import latte as jlatte
from magcache_tpu.models import open_sora_plan as josp
from magcache_tpu.models import stdit3 as jstdit3
from magcache_tpu.parallel.mesh import MeshPlan as JMeshPlan, build_mesh, shard_params, use_mesh
from magcache_tpu_torch.core.pab import LATTE_PAB, OPEN_SORA_PAB
from magcache_tpu_torch.models import latte as tlatte
from magcache_tpu_torch.models import open_sora_plan as tosp
from magcache_tpu_torch.models import stdit3 as tstdit3
from magcache_tpu_torch.models.convert import (latte_params_from_numpy, osp_params_from_numpy,
                                               stdit3_params_from_numpy)
from magcache_tpu_torch.parallel.mesh import run_local_ranks

TOL = 2e-4                   # f32: the shards, slices and collectives reorder sums
CAP = 4
EVEN, UNEVEN = (4, 4, 4), (3, 3, 5)
GRIDS = [(2, 2, 2), (1, 2, 1), (1, 1, 2)]
FAMILIES = {
    "stdit3": (jstdit3, tstdit3, "STDiT3Config", "STDiT3Model", stdit3_params_from_numpy,
               dict(hidden=64, heads=4, depth=2, caption_dim=24, freq_dim=32,
                    caption_max_len=4)),
    "latte": (jlatte, tlatte, "LatteConfig", "LatteModel", latte_params_from_numpy,
              dict(hidden=64, heads=4, depth=2, caption_dim=24, time_embed_dim=32)),
    "osp": (josp, tosp, "OpenSoraPlanConfig", "OSPModel", osp_params_from_numpy,
            dict(hidden=96, heads=4, depth=2, caption_dim=24, time_embed_dim=32)),
}


def _init(name, jcfg):
    jmod = FAMILIES[name][0]
    init = {"stdit3": "init_stdit3_params", "latte": "init_latte_params",
            "osp": "init_osp_params"}[name]
    return getattr(jmod, init)(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    name = request.param
    jmod, tmod, cfg_name, model_name, convert, kw = FAMILIES[name]
    jcfg, tcfg = getattr(jmod, cfg_name)(**kw), getattr(tmod, cfg_name)(**kw)
    params = _init(name, jcfg)
    model = getattr(tmod, model_name)(tcfg, "cpu")
    model.load_state_dict(convert(jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return name, jcfg, params, model.requires_grad_(False)


def _inputs(cfg, grid, seed=3):
    rng = np.random.default_rng(seed)
    t, h, w = grid
    x = rng.normal(size=(2, t, 2 * h, 2 * w, cfg.in_channels)).astype(np.float32)
    cond = {"y": rng.normal(size=(2, CAP, cfg.caption_dim)).astype(np.float32)}
    return x, np.full((2,), 400.0, np.float32), cond


def _core(name, model, grid, **kw):
    if name == "stdit3":
        return tstdit3.make_stdit3_core(model, grid, **kw)
    if name == "latte":
        return tlatte.make_latte_core(model, grid, CAP, **kw)
    return tosp.make_osp_core(model, grid, CAP, **kw)


def _forward(core, x, t, cond, state=None):
    h, ctx = core.prepare(torch.from_numpy(x), torch.from_numpy(t),
                          {k: torch.from_numpy(v) for k, v in cond.items()})
    if state is None:
        return core.head(core.trunk(h, ctx), ctx)
    out, _ = core.trunk(h, ctx, core.init_state(h, ctx), state)
    return core.head(out, ctx)


def _on_grid(axes, fn):
    """Every rank's output of ``fn(plan)``; they are the same bits."""
    dp, sp, tp = axes
    outs = run_local_ranks(sp, fn, dp=dp, tp=tp, timeout=60.0)
    for r, out in enumerate(outs[1:], 1):
        assert torch.equal(out, outs[0]), f"rank {r} differs from rank 0"
    return outs[0].numpy()


def _jax_forward(name, jcfg, params, x, t, cond, mesh_axes=None, monkeypatch=None):
    jmod = FAMILIES[name][0]
    grid = (x.shape[1], x.shape[2] // 2, x.shape[3] // 2)
    core = (jmod.make_stdit3_core(jcfg, grid, CAP) if name == "stdit3" else
            jmod.make_latte_core(jcfg, grid, CAP) if name == "latte" else
            jmod.make_osp_core(jcfg, grid, CAP))

    def fwd(p, xx, tt, cc):
        h, ctx = core.prepare(p, xx, tt, cc)
        return core.head(p, core.trunk(p, h, ctx), ctx)

    args = (jnp.asarray(x), jnp.asarray(t), {k: jnp.asarray(v) for k, v in cond.items()})
    if mesh_axes is None:
        monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
        return np.asarray(jax.jit(fwd)(params, *args))
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret")
    mesh = build_mesh(*mesh_axes)
    with use_mesh(JMeshPlan(mesh)):
        return np.asarray(jax.jit(fwd)(shard_params(params, mesh), *args))


@pytest.fixture(scope="module")
def jax_refs():
    return {}


def _ref(jax_refs, family, geometry, monkeypatch):
    """The JAX forward of a family at a geometry: EVEN under use_mesh of
    dp 2 x sp 2 x tp 2 (OSP: sp 2 x tp 2), UNEVEN on one device."""
    name, jcfg, params, model = family
    key = (name, geometry)
    if key not in jax_refs:
        x, t, cond = _inputs(model.cfg, geometry)
        axes = None if geometry == UNEVEN else (1, 2, 2) if name == "osp" else (2, 2, 2)
        jax_refs[key] = _jax_forward(name, jcfg, params, x, t, cond, axes, monkeypatch)
    return jax_refs[key]


CASES = [(g, EVEN) for g in GRIDS] + [((2, 2, 2), UNEVEN)]


@pytest.mark.parametrize("route", ["packed", "unpacked"])
@pytest.mark.parametrize("axes,geometry", CASES,
                         ids=[f"dp{d}-sp{s}-tp{t}-{'x'.join(map(str, g))}"
                              for (d, s, t), g in CASES])
def test_forward_on_the_grid_matches_one_rank_and_jax(family, jax_refs, axes, geometry,
                                                      route, monkeypatch):
    name, _, _, model = family
    x, t, cond = _inputs(model.cfg, geometry)
    one = _forward(_core(name, model, geometry), x, t, cond).numpy()
    got = _on_grid(axes, lambda plan: _forward(
        _core(name, model, geometry, route=route, plan=plan), x, t, cond))
    assert got.shape == one.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, one, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _ref(jax_refs, family, geometry, monkeypatch),
                               atol=TOL, rtol=TOL)


def test_masked_frames_and_pab_on_the_grid_match_one_rank(family):
    name, _, _, model = family
    x, t, cond = _inputs(model.cfg, UNEVEN)
    steps = np.linspace(999.0, 10.0, 30)
    pab = {"stdit3": OPEN_SORA_PAB, "latte": LATTE_PAB, "osp": None}[name]
    if name == "stdit3":     # frame 0 at the t = 0 modulation
        cond = dict(cond, x_mask=np.array([[False, True, True]] * 2))
    if name == "osp":
        from magcache_tpu_torch.core.pab import OSP_V120_PAB as pab
        steps = np.linspace(999.0, 10.0, 150)
    kw = dict(pab=pab, timesteps=steps)
    for step in (0, 12):     # full compute, then a step that replays slots
        def run(plan=None):
            core = _core(name, model, UNEVEN, plan=plan, **kw)
            h, ctx = core.prepare(torch.from_numpy(x), torch.from_numpy(t),
                                  {k: torch.from_numpy(np.asarray(v)) for k, v in cond.items()})
            state = core.init_state(h, ctx)
            out, state = core.trunk(h, ctx, state, 0)
            out, _ = core.trunk(h, ctx, state, step)
            return core.head(out, ctx)

        one = run().numpy()
        got = _on_grid((2, 2, 2) if name != "osp" else (1, 2, 2), run)
        np.testing.assert_allclose(got, one, atol=TOL, rtol=TOL)


def test_refusals_name_the_counts(family):
    name, _, _, model = family
    for axes, route, msg in (((1, 1, 3), "packed", r"tp = 3: \w+'s 4 heads do not divide"),
                             ((1, 4, 2), "unpacked", r"sp 4 x tp 2: \w+'s 4 heads over 8 "
                                                     r"ranks leave 0.5 a rank"),
                             ((1, 2, 1), "grouped", r'route="unpacked"'),
                             ((1, 2, 1), "vpu", r'route="unpacked"')):
        if name == "osp" and route in ("grouped", "vpu"):
            msg = "route must be one of"
        if name == "osp" and route == "unpacked":
            route = "packed"
        with pytest.raises(ValueError, match=msg):
            run_local_ranks(axes[1], lambda plan: _core(name, model, EVEN, route=route,
                                                        plan=plan),
                            dp=axes[0], tp=axes[2], timeout=60.0)
