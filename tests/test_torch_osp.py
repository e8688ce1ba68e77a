"""The port's Open-Sora-Plan slice against the JAX package on the CPU: the
Euler-Ancestral and PNDM schedules (bit-equal), ``sample_euler`` with the
model-input scaling and ancestral noise (JAX's draws fed in through
``noise_fn``), ``sample_pndm``, the v1.2 core on both routes and under PAB
(the JAX core's packed path with its Pallas kernels in interpret mode, and
its unpacked path), v1.1's Latte trunk at T = 17 latent frames under
``OSP_V110_PAB``, both pipelines (v1.2 calibration included) and the CLI.

Both sides get the same weights (``init_osp_params`` / ``init_latte_params``
converted by ``osp_params_from_numpy`` / ``latte_params_from_numpy``) and
the same numpy inputs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import pab as jpab
from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.magcache import MagCacheConfig as JMagCacheConfig
from magcache_tpu.models import latte as JL
from magcache_tpu.models import open_sora_plan as J
from magcache_tpu.pipelines import open_sora_plan as jpipe
from magcache_tpu.schedulers.euler_ancestral import EulerAncestralSchedule as JEA
from magcache_tpu.schedulers.pndm import PNDMSchedule as JPNDM
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.core.magcache import MagCacheConfig, compute_skip_schedule
from magcache_tpu_torch.core.sampler import sample_euler, sample_pndm
from magcache_tpu_torch.models import latte as TL
from magcache_tpu_torch.models import open_sora_plan as T
from magcache_tpu_torch.models.convert import latte_params_from_numpy, osp_params_from_numpy
from magcache_tpu_torch.pipelines import open_sora_plan as tpipe
from magcache_tpu_torch.schedulers.euler_ancestral import EulerAncestralSchedule
from magcache_tpu_torch.schedulers.pndm import PNDMSchedule
from tests.test_torch_latte import _latents_close

# f32 on both sides: GEMM and reduction order only
F32_TOL = 2e-5
# bf16: JAX rounds at other places around the unfused ops
BF16_REL_L2 = 2e-2

# head dim 72 as published (three RoPE3D thirds of 24); T = 3, 3 x 5 patches
NARROW = dict(hidden=144, heads=2, depth=2, caption_dim=24, time_embed_dim=32)
GRID, CAP = (3, 3, 5), 5
# every site's window opened, strides 2 and 3 over the sampler's steps
SMALL_PAB = dict(spatial_broadcast=True, spatial_threshold=(0, 1000), spatial_range=2,
                 cross_broadcast=True, cross_threshold=(0, 1000), cross_range=3,
                 mlp_broadcast=True, mlp_threshold=(0, 1000), mlp_range=2)


def _np(a):
    return np.array(a, np.float32)


def _models(dtype, seed=0, **kw):
    cfg_kw = dict(NARROW, dtype=dtype, **kw)
    jcfg, tcfg = J.OpenSoraPlanConfig(**cfg_kw), T.OpenSoraPlanConfig(**cfg_kw)
    params = J.init_osp_params(jax.random.PRNGKey(seed), jcfg)
    model = T.OSPModel(tcfg, "cpu")
    model.load_state_dict(osp_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return jcfg, params, model


def _inputs(rows=2, seed=1):
    rng = np.random.default_rng(seed)
    t, h, w = GRID
    x = rng.standard_normal((rows, t, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((rows, CAP, NARROW["caption_dim"])).astype(np.float32)
    return x, y, np.array([700.0, 700.0][:rows], np.float32)


def _jax_noise(key):
    """``noise_fn`` giving the JAX sampler's ancestral draws."""
    return lambda i, shape: torch.from_numpy(_np(
        jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32)))


def _combine(g, c=4):
    return lambda chunks: chunks[1][..., :c] + g * (chunks[0][..., :c] - chunks[1][..., :c])


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("steps,kw", [(150, {}), (30, {}), (7, {}),
                                      (20, dict(beta_schedule="scaled_linear"))])
def test_euler_ancestral_schedule_bit_equal_to_jax(steps, kw):
    t, j = EulerAncestralSchedule.create(steps, **kw), JEA.create(steps, **kw)
    for name in ("timesteps", "sigmas", "dts", "noise_scales", "in_scales"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert t.init_noise_sigma == j.init_noise_sigma and t.num_steps == steps
    assert t.noise_scales[-1] == 0 and t.sigmas[-1] == 0


@pytest.mark.parametrize("steps,kw", [(150, {}), (20, {}), (50, {}),
                                      (10, dict(beta_schedule="linear"))])
def test_pndm_schedule_bit_equal_to_jax(steps, kw):
    t, j = PNDMSchedule.create(steps, **kw), JPNDM.create(steps, **kw)
    for name in ("timesteps", "c_x", "c_e", "eps_weights", "push_eps", "use_cur"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert t.num_steps == steps + 1
    # the duplicated second timestep redoes the first transfer (Heun)
    assert t.timesteps[1] == t.timesteps[2] and t.use_cur[1] == 1 and t.push_eps[1] == 0


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("mode", ["full", "magcache", "calibrate"])
def test_sample_euler_ancestral_matches_jax(mode, monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    steps = 5
    jcfg, params, model = _models("float32", seed=2)
    jcore = J.make_osp_core(jcfg, GRID, CAP)
    tcore = T.make_osp_core(model, GRID, CAP, route="unpacked")
    sch = EulerAncestralSchedule.create(steps)
    rng = np.random.default_rng(3)
    z = (rng.standard_normal((1, 3, 6, 10, 4)) * sch.init_noise_sigma).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(11)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts, in_scales=sch.in_scales,
              noise_scales=sch.noise_scales, lanes=2)
    jkw = dict(kw)
    if mode == "magcache":
        cfg = dict(num_steps=2 * steps, mag_ratios=tuple(np.linspace(1.0, 0.97, 2 * steps)),
                   thresh=0.2, max_consecutive_skips=2, retention_ratio=0.2, lanes=2)
        kw.update(cache_cfg=MagCacheConfig(**cfg), return_skips=True)
        jkw.update(cache_cfg=JMagCacheConfig(**cfg), return_skips=True)
    elif mode == "calibrate":
        kw.update(calibrate=True)
        jkw.update(calibrate=True)
    jout = jax.jit(lambda p, z_, c: jsampler.sample_euler(
        jcore, p, z_, c, combine_fn=_combine(7.5), noise_key=key, **jkw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y)})
    tout = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)},
                        combine_fn=_combine(7.5), noise_fn=_jax_noise(key), **kw)
    if mode == "full":
        jout, tout = (jout,), (tout,)
    _latents_close(tout[0].numpy(), _np(jout[0]))
    if mode == "magcache":
        np.testing.assert_array_equal(tout[1], np.asarray(jout[1]))
        np.testing.assert_array_equal(tout[1], compute_skip_schedule(
            kw["cache_cfg"]).reshape(steps, 2))
        assert tout[1].any() and not tout[1].all(1).all()
    elif mode == "calibrate":
        assert tout[1].shape == (steps - 1, 2, 3)
        np.testing.assert_allclose(tout[1], np.asarray(jout[1]), atol=1e-4, rtol=1e-4)


def test_sample_euler_noise_arguments():
    # noise_key is the JAX noise source: it raises naming its replacement
    with pytest.raises(NotImplementedError, match="noise_fn"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     noise_key=0)
    with pytest.raises(ValueError, match="noise_fn"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     noise_scales=np.ones(2))
    with pytest.raises(ValueError, match="dpm_coeffs"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     in_scales=np.ones(2),
                     dpm_coeffs=dict.fromkeys(("sigma_t", "a", "b", "c_x", "c_d"),
                                              np.ones(2)))


def test_step_indexed_combine_gets_the_step():
    # a two-argument combine_fn receives the step index, as in JAX
    seen = []

    def core_fn():
        from magcache_tpu_torch.core.sampler import DiTCore
        return DiTCore(lambda x, t, c: (x, {}), lambda h, c: h, lambda h, c: h)

    def combine(chunks, step_idx):
        seen.append(step_idx)
        return chunks[0] - chunks[1]

    out = sample_euler(core_fn(), torch.ones(1, 2), {}, timesteps=np.arange(3.0),
                       dts=np.ones(3), lanes=2, combine_fn=combine)
    assert seen == [0, 1, 2] and torch.equal(out, torch.ones(1, 2))
    sch = PNDMSchedule.create(3)
    seen.clear()
    sample_pndm(core_fn(), torch.ones(1, 2), {}, sch, lanes=2, combine_fn=combine)
    assert seen == list(range(4))


def _latte_models(T_frames=17, seed=4):
    cfg_kw = dict(hidden=144, heads=2, depth=2, caption_dim=24, time_embed_dim=32,
                  out_channels=8, dtype="float32")
    jcfg, tcfg = JL.LatteConfig(**cfg_kw), TL.LatteConfig(**cfg_kw)
    params = JL.init_latte_params(jax.random.PRNGKey(seed), jcfg)
    model = TL.LatteModel(tcfg, "cpu")
    model.load_state_dict(latte_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                                  "cpu"))
    return jcfg, params, model


# v1.1's trunk: 17 latent frames (one more than the card's stream route takes)
V110_GRID = (17, 1, 2)


@pytest.mark.parametrize("cached,pab", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_sample_pndm_on_the_v110_trunk_matches_jax(cached, pab, monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret")
    jcfg, params, model = _latte_models()
    sch = PNDMSchedule.create(4)
    n = sch.num_steps
    jpcfg = tpcfg = None
    if pab:
        # OSP_V110_PAB's windows over 5 PNDM calls, and an MLP anchor at the
        # duplicated timestep 500 on blocks 0 and 1
        anchors = ((500, (0, 1), 2),)
        kw = dict(spatial_threshold=(0, 1000), temporal_threshold=(0, 1000),
                  cross_threshold=(0, 1000), mlp_spatial_config=anchors,
                  mlp_temporal_config=anchors)
        tpcfg = dataclasses.replace(tpab.OSP_V110_PAB, **kw)
        jpcfg = dataclasses.replace(jpab.OSP_V110_PAB, **kw)
        masks = TL.latte_pab_masks(tpcfg, sch.timesteps, 2)
        assert masks["spatial"].any() and masks["mlp_sp_reuse"].any()
    jcore = JL.make_latte_core(jcfg, V110_GRID, CAP, pab=jpcfg, timesteps=sch.timesteps)
    tcore = TL.make_latte_core(model, V110_GRID, CAP, pab=tpcfg, timesteps=sch.timesteps)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((1, 17, 2, 4, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, 24)).astype(np.float32)
    kw = {}
    if cached:
        cfg = dict(num_steps=2 * n, mag_ratios=tuple(np.linspace(1.0, 0.96, 2 * n)),
                   thresh=0.25, max_consecutive_skips=2, retention_ratio=0.2, lanes=2)
        kw = dict(cache_cfg=MagCacheConfig(**cfg))
        jkw = dict(cache_cfg=JMagCacheConfig(**cfg))
    else:
        jkw = {}
    jsch = JPNDM.create(4)
    jout = jax.jit(lambda p, z_, c: jsampler.sample_pndm(
        jcore, p, z_, c, jsch, lanes=2, combine_fn=_combine(7.5), **jkw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y)})
    tout, skips = sample_pndm(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)}, sch,
                              lanes=2, combine_fn=_combine(7.5), return_skips=True, **kw)
    _latents_close(tout.numpy(), _np(jout))
    if cached:
        np.testing.assert_array_equal(skips, compute_skip_schedule(
            kw["cache_cfg"]).reshape(n, 2))
        assert skips.any()
    else:
        assert not skips.any()


# ---------------------------------------------------------------- the v1.2 core
def test_converter_carries_every_parameter_with_jax_dtypes():
    jp = J.init_osp_params(jax.random.PRNGKey(0), J.OpenSoraPlanConfig(**NARROW,
                                                                         dtype="bfloat16"))
    tcfg = T.OpenSoraPlanConfig(**NARROW, dtype="bfloat16")
    sd = T.OSPModel(tcfg, "cpu").state_dict()
    conv = osp_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("patch_embed.weight", "blocks.0.qkv.weight", "blocks.1.cross_kv.bias"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("caption.in.weight", "time.out.bias", "adaln_single.weight",
              "blocks.0.scale_shift", "final_mod", "final_out.weight"):
        assert sd[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["blocks.1.ff1.weight"].float().numpy(),
                                  _np(jp["blocks"]["ff1"]["w"][1]).T)


def test_osp_v120_is_the_jax_geometry_and_rope_tables_match():
    cfg = T.OSP_V120
    assert (cfg.hidden, cfg.heads, cfg.head_dim, cfg.depth, cfg.caption_dim, cfg.patch,
            cfg.time_embed_dim, cfg.eps, cfg.c_out) == (1152, 16, 72, 28, 4096, (1, 2, 2),
                                                       256, 1e-6, 8)
    m = T.OSPModel(cfg, "meta")
    assert 0.6e9 < sum(p.numel() for p in m.parameters()) < 0.7e9
    for grid in ((24, 30, 40), (3, 3, 5)):
        got = T.osp_rope_tables(cfg, grid)
        want = J.osp_rope_tables(J.OpenSoraPlanConfig(), grid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="RoPE3D"):
        T.osp_rope_tables(T.OpenSoraPlanConfig(hidden=64, heads=1), (1, 1, 1))


@pytest.mark.parametrize("route,dtype", [("packed", "float32"), ("packed", "bfloat16"),
                                         ("unpacked", "float32"), ("unpacked", "bfloat16")])
def test_osp_core_matches_jax(route, dtype, monkeypatch):
    # packed: the JAX core's packed path with K1 and K6-K8 in interpret mode;
    # unpacked: its off-TPU composition
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret" if route == "packed" else "0")
    jcfg, params, model = _models(dtype, out_channels=8)
    jcore = J.make_osp_core(jcfg, GRID, CAP)
    tcore = T.make_osp_core(model, GRID, CAP, route=route)
    x, y, t = _inputs()
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"y": jnp.asarray(y)})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"y": torch.from_numpy(y)})
    assert ht.dtype == model.cfg.torch_dtype and ht.shape == (2, 45, 144)
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == x.shape and np.isfinite(ot).all()
    for got, want in ((_np(ht.float()), _np(hj)), (trt, _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


@pytest.mark.parametrize("jax_path,route,cached", [("interpret", "packed", False),
                                                    ("0", "unpacked", True)])
def test_osp_pab_sampler_matches_jax(jax_path, route, cached, monkeypatch):
    """PAB over 6 Euler-Ancestral steps: every site reuses and refreshes;
    the PAB block is the unpacked one whichever route the core was made on."""
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", jax_path)
    steps = 6
    jcfg, params, model = _models("float32", seed=6)
    sch = EulerAncestralSchedule.create(steps)
    tp, jp = tpab.PABConfig(**SMALL_PAB), jpab.PABConfig(**SMALL_PAB)
    masks = tpab.broadcast_masks(tp, sch.timesteps)
    assert all(masks[k].any() and not masks[k].all() for k in ("spatial", "cross", "mlp"))
    jcore = J.make_osp_core(jcfg, GRID, CAP, pab=jp, timesteps=sch.timesteps)
    tcore = T.make_osp_core(model, GRID, CAP, route=route, pab=tp, timesteps=sch.timesteps)
    rng = np.random.default_rng(7)
    z = (rng.standard_normal((1, 3, 6, 10, 4)) * sch.init_noise_sigma).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    key = jax.random.PRNGKey(12)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts, in_scales=sch.in_scales,
              noise_scales=sch.noise_scales, lanes=2)
    jkw = dict(kw)
    if cached:
        cfg = dict(num_steps=2 * steps, mag_ratios=tuple(np.linspace(1.0, 0.97, 2 * steps)),
                   thresh=0.2, max_consecutive_skips=2, retention_ratio=0.2, lanes=2)
        kw["cache_cfg"], jkw["cache_cfg"] = MagCacheConfig(**cfg), JMagCacheConfig(**cfg)
    jout = jax.jit(lambda p, z_, c: jsampler.sample_euler(
        jcore, p, z_, c, combine_fn=_combine(7.5), noise_key=key, **jkw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y)})
    hidden, ctx = tcore.prepare(torch.from_numpy(z).repeat(2, 1, 1, 1, 1),
                                torch.full((2,), 999.0), {"y": torch.from_numpy(y)})
    state = tcore.init_state(hidden, ctx)
    assert sorted(state) == ["attn", "cross", "mlp"]
    v120 = T.make_osp_core(model, GRID, CAP, pab=tpab.OSP_V120_PAB,
                           timesteps=EulerAncestralSchedule.create(150).timesteps)
    assert sorted(v120.init_state(hidden, ctx)) == ["attn", "cross"]   # 2 of 3 slots
    tout = sample_euler(tcore, torch.from_numpy(z), {"y": torch.from_numpy(y)},
                        combine_fn=_combine(7.5), noise_fn=_jax_noise(key), **kw)
    _latents_close(tout.numpy(), _np(jout))


def test_osp_routes_and_plan_raise():
    _, _, model = _models("float32")
    with pytest.raises(ValueError, match="route"):
        T.make_osp_core(model, GRID, CAP, route="grouped")
    # a plan runs the unpacked blocks on the rank's shards
    # (tests/test_torch_mesh_videosys.py); the grouped route takes none
    with pytest.raises(ValueError, match="route"):
        T.make_osp_core(model, GRID, CAP, route="grouped", plan=object())
    with pytest.raises(ValueError, match="timesteps"):
        T.make_osp_core(model, GRID, CAP, pab=tpab.OSP_V120_PAB)


# ---------------------------------------------------------------- pipelines
def _pipeline_pair(route="unpacked", **kw):
    base = dict(tiny=True, num_frames=5, height=32, width=48, num_inference_steps=6,
                caption_len=6, dtype="float32")
    base.update(kw)
    j = jpipe.OpenSoraPlanPipeline(jpipe.OpenSoraPlanPipelineConfig(**base))
    tcfg = tpipe.OpenSoraPlanPipelineConfig(route=route, **base)
    mcfg = tcfg.model_config()
    if tcfg.version == "v110":
        model = TL.LatteModel(mcfg, "cpu")
        model.load_state_dict(latte_params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                      mcfg, "cpu"))
    else:
        model = T.OSPModel(mcfg, "cpu")
        model.load_state_dict(osp_params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                    mcfg, "cpu"))
    return j, tpipe.OpenSoraPlanPipeline(tcfg, "cpu", model=model)


def _feed_jax_noise(jp, tp, seed, monkeypatch):
    """The JAX request's initial and ancestral draws, fed to the port."""
    k_init, k_anc = jax.random.split(j_set_seed(seed))
    z = _np(jax.random.normal(k_init, (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    monkeypatch.setattr(tp, "_noise_fn", lambda gen: _jax_noise(k_anc))


@pytest.mark.parametrize("version,route,kw", [
    ("v120", "packed", dict(use_magcache=True, magcache_thresh=0.3,
                            num_inference_steps=4)),
    ("v120", "unpacked", dict(magcache_calibration=True)),
    ("v120", "unpacked", dict(enable_pab=True, pab_threshold=(0, 1000))),
    ("v110", "packed", dict(use_magcache=True, magcache_thresh=0.3)),
    ("v110", "packed", dict(enable_pab=True, pab_threshold=(0, 1000)))])
def test_pipeline_latents_match_jax(version, route, kw, monkeypatch):
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret" if route == "packed" else "0")
    jp, tp = _pipeline_pair(route, version=version, **kw)
    assert tp.latent_shape == jp.latent_shape == (2, 4, 6, 4) and tp.grid == jp.grid
    _feed_jax_noise(jp, tp, 5, monkeypatch)
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    calls = tp.schedule.num_steps
    assert calls == kw.get("num_inference_steps", 6) + (version == "v110")
    if "magcache_calibration" in kw:
        assert got.skips is None
        for name, vals in got.calibration.items():
            assert len(vals) == 2 * (calls - 1)
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        want_bits = (compute_skip_schedule(tp._cache_cfg()).reshape(calls, 2)
                     if kw.get("use_magcache") else np.zeros((calls, 1), bool))
        np.testing.assert_array_equal(got.skips, want_bits)
        assert got.skips.any() == bool(kw.get("use_magcache"))


def test_pipeline_defaults_follow_jax():
    for version in ("v110", "v120"):
        t = tpipe.OpenSoraPlanPipelineConfig(version=version)
        j = jpipe.OpenSoraPlanPipelineConfig(version=version)
        for f in ("num_frames", "height", "width", "num_inference_steps", "guidance_scale",
                  "caption_len", "clean_caption", "pab_threshold", "magcache_thresh",
                  "magcache_K", "retention_ratio"):
            assert getattr(t, f) == getattr(j, f), f
        tm, jm = t.model_config(), j.model_config()
        assert (tm.hidden, tm.heads, tm.depth, tm.c_out) == (jm.hidden, jm.heads, jm.depth,
                                                            jm.c_out)
        assert dataclasses.asdict(t.pab()) == dataclasses.asdict(
            tpab.OSP_V110_PAB if version == "v110" else tpab.OSP_V120_PAB)


def test_v110_calibration_raises_and_v120_calibration_installs(monkeypatch):
    _, tp = _pipeline_pair("packed", version="v110", magcache_calibration=True)
    with pytest.raises(ValueError, match="PNDM"):
        tp.generate("a cat")
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "0")
    jp, tp = _pipeline_pair(magcache_calibration=True)
    ratios = tuple(tp.generate("a cat", seed=2).calibration["norm_ratio"])
    assert len(ratios) == 10 and np.isfinite(ratios).all()
    jp, tp = _pipeline_pair(use_magcache=True, magcache_ratios=ratios, magcache_thresh=0.3)
    _feed_jax_noise(jp, tp, 2, monkeypatch)
    got, want = tp.generate("a cat", seed=2), jp.generate("a cat", seed=2)
    _latents_close(got.latents.numpy(), _np(want.latents))
    np.testing.assert_array_equal(got.skips, compute_skip_schedule(
        jp._cache_cfg()).reshape(6, 2))


# ---------------------------------------------------------------- CLI
def test_cli_open_sora_plan_tiny(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--task", "open-sora-plan", "--tiny", "--device", "cpu", "--dtype", "float32",
              "--magcache_calibration", "--sample_steps", "8", "--route", "unpacked",
              "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 14 and all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--task", "open-sora-plan", "--tiny", "--device", "cpu", "--use_magcache",
              "--mag_ratios_json", cal + "_mag_ratio.json", "--sample_steps", "8",
              "--enable_pab", "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 2, 4, 4, 4) and np.isfinite(lat).all()
    assert "of 16 lane-forwards (cond + uncond per step)" in capsys.readouterr().out
    cli.main(["--task", "open-sora-plan", "--tiny", "--device", "cpu", "--osp_version",
              "v110", "--sample_steps", "4", "--no_text_preprocessing", "--save_file", out])
    assert "skipped 0 of 10 lane-forwards" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="v110"):
        cli.main(["--task", "open-sora-plan", "--tiny", "--device", "cpu", "--osp_version",
                  "v110", "--magcache_calibration"])
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "latte", "--tiny", "--device", "cpu", "--route", "unpacked"])
