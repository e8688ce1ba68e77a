"""The port's Wan solvers and static cache policies against the JAX package:
DPM-Solver++(2M) coefficients, the rolling policy's schedules, MagCache's
per-forward mode, ``sample_euler``'s dpm++ and ``post_step``
updates, and the Wan pipeline's dpm++, Euler and rolling requests and dpm++
calibration, in f32 with the same weights and noise, plus their CLI flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import magcache as jmag
from magcache_tpu.core import rolling as jroll
from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.presets import PRESETS as J_PRESETS
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu.schedulers.dpm_flow import dpmpp_2m_flow_coeffs as j_dpm
from magcache_tpu.schedulers.flow_match import FlowMatchSchedule as JFlow
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import magcache as tmag
from magcache_tpu_torch.core import rolling as troll
from magcache_tpu_torch.core import sampler as tsampler
from magcache_tpu_torch.core.presets import make_config as t_make_config
from magcache_tpu_torch.models.convert import wan_params_from_numpy
from magcache_tpu_torch.pipelines import wan as tpipe
from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs as t_dpm
from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule as TFlow
from tests.test_torch_sampler import _sampler_setup

# f32 on both sides, a 2-block trunk over the steps: summation order only
# (the tolerance of tests/test_torch_sampler.py)
TOL = 1e-4


@pytest.mark.parametrize("steps,shift,final_zero", [(6, 5.0, True), (20, 5.0, True),
                                                    (50, 8.0, True), (10, 1.0, False)])
def test_dpmpp_coeffs_bit_equal_to_jax(steps, shift, final_zero):
    sig = TFlow.create(steps, shift=shift, final_sigma_zero=final_zero).sigmas
    np.testing.assert_array_equal(sig, JFlow.create(steps, shift=shift,
                                                    final_sigma_zero=final_zero).sigmas)
    got, want = t_dpm(sig), j_dpm(sig)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kw", [dict(num_steps=100, thresh=0.12, K=2),
                                dict(num_steps=100, thresh=0.12, K=4),
                                dict(num_steps=100, thresh=0.015, K=-1),  # inert
                                dict(num_steps=40, thresh=0.2, K=2),  # resampled
                                dict(num_steps=20, thresh=0.12, K=2, retention=0.5)])
def test_rolling_wan_schedule_bit_equal_to_jax(kw):
    got = troll.RollingCacheConfig(**kw).skip_schedule()
    np.testing.assert_array_equal(got, jroll.RollingCacheConfig(**kw).skip_schedule())
    np.testing.assert_array_equal(troll.load_eval_ratios(), jroll.load_eval_ratios())
    assert got.any() == (kw.get("K") != -1)


@pytest.mark.parametrize("steps,kw", [(30, {}), (30, dict(K=2, thresh=0.2)),
                                      (20, {}), (6, dict(skip_time=2))])
def test_rolling_opensora_schedule_bit_equal_to_jax(steps, kw):
    got = troll.RollingCacheConfig.opensora(steps, **kw).skip_schedule()
    np.testing.assert_array_equal(
        got, jroll.RollingCacheConfig.opensora(steps, **kw).skip_schedule())
    assert got.any()


@pytest.mark.parametrize("key", sorted(k for k in J_PRESETS if k.startswith("wan")))
def test_dynamic_update_replays_the_static_schedule(key):
    for steps in (20, 50):
        cfg = t_make_config(key, steps)
        jcfg = j_make_config(key, steps)
        st, jst = tmag.dynamic_init(cfg), jmag.dynamic_init(jcfg)
        bits, jbits = [], []
        for cnt in range(cfg.num_steps):
            b, st = tmag.dynamic_update(st, cnt, cfg)
            jb, jst = jmag.dynamic_update(jst, jnp.int32(cnt), jcfg)
            bits.append(b)
            jbits.append(bool(jb))
        np.testing.assert_array_equal(bits, tmag.compute_skip_schedule(cfg))
        np.testing.assert_array_equal(bits, jbits)
        np.testing.assert_array_equal(st.acc_ratio, np.asarray(jst.acc_ratio))


@pytest.mark.parametrize("mode", ["dpm", "post_step"])
def test_sample_euler_updates_match_jax(mode):
    jcore, params, tcore, x, ctx = _sampler_setup()
    n = 5
    sch = TFlow.create(n, shift=5.0)
    kw = dict(timesteps=sch.timesteps, dts=np.diff(sch.sigmas), guidance_scale=5.0)
    tkw, jkw = dict(kw), dict(kw)
    if mode == "dpm":
        tkw["dpm_coeffs"] = jkw["dpm_coeffs"] = t_dpm(sch.sigmas)
        tkw["cache_cfg"] = t_make_config("wan2.1-t2v-1.3B", n)
        jkw["cache_cfg"] = j_make_config("wan2.1-t2v-1.3B", n)
        mask = np.array([[0, 0], [1, 1], [1, 0], [0, 1], [0, 0]], bool)
        tkw["skip_mask_override"], jkw["skip_mask_override"] = mask, jnp.asarray(mask)
    else:
        tkw["post_step"] = lambda v: torch.cat([torch.zeros_like(v[:, :1]), v[:, 1:]], 1)
        jkw["post_step"] = lambda v: jnp.concatenate([jnp.zeros_like(v[:, :1]), v[:, 1:]], 1)
    want = jsampler.sample_euler(jcore, params, jnp.asarray(x),
                                 {"context": jnp.asarray(ctx)}, **jkw)
    got = tsampler.sample_euler(tcore, torch.from_numpy(x),
                                {"context": torch.from_numpy(ctx)}, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    if mode == "post_step":
        assert not got[:, 0].any()
    with pytest.raises(ValueError, match="dpm_coeffs"):
        tsampler.sample_euler(tcore, torch.from_numpy(x), {}, dpm_coeffs=t_dpm(sch.sigmas),
                              x_coeffs=np.ones(n), **kw)


def test_sample_unipc_post_step_matches_jax():
    jcore, params, tcore, x, ctx = _sampler_setup()
    from magcache_tpu.schedulers.unipc import UniPCSchedule as JUniPC
    from magcache_tpu_torch.schedulers.unipc import UniPCSchedule as TUniPC

    want = jsampler.sample_unipc(
        jcore, params, jnp.asarray(x), {"context": jnp.asarray(ctx)}, JUniPC.create(4, shift=5.0),
        guidance_scale=5.0, post_step=lambda v: v.at[:, 0].set(0.5))
    got = tsampler.sample_unipc(
        tcore, torch.from_numpy(x), {"context": torch.from_numpy(ctx)},
        TUniPC.create(4, shift=5.0), guidance_scale=5.0,
        post_step=lambda v: torch.cat([torch.full_like(v[:, :1], 0.5), v[:, 1:]], 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------- pipeline
STEPS = 10


def _wan_pair(**kw):
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=STEPS,
                sample_shift=5.0, guide_scale=5.0, dtype="float32")
    base.update(kw)
    j = jpipe.WanPipeline(jpipe.WanPipelineConfig(**base))
    j.record_skips = True
    tcfg = tpipe.WanPipelineConfig(**base)
    model = tpipe.WanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(wan_params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                tcfg.model_config(), "cpu"))
    return j, tpipe.WanPipeline(tcfg, "cpu", model=model)


def run_wan_pair(monkeypatch, seed=3, **kw):
    """The JAX and the port's Wan pipelines on one tiny config, the port fed
    JAX's noise: ``(jax_out, port_out, port_pipeline)``."""
    jp, tp = _wan_pair(**kw)
    z = np.asarray(jax.random.normal(j_set_seed(seed), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z.copy()))
    return jp.generate("a red boat", seed=seed), tp.generate("a red boat", seed=seed), tp


@pytest.mark.parametrize("kw", [
    dict(sample_solver="dpm++"),
    dict(sample_solver="dpm++", use_magcache=True, magcache_thresh=0.3, magcache_K=3),
    dict(sample_solver="euler", use_magcache=True, magcache_thresh=0.3, magcache_K=3),
    dict(cache_policy="rolling", use_magcache=True, magcache_thresh=0.12, magcache_K=2),
    dict(cache_policy="rolling", sample_solver="dpm++", use_magcache=True,
         magcache_thresh=0.12, magcache_K=2),
])
def test_wan_solvers_and_rolling_match_jax(kw, monkeypatch):
    want, got, tp = run_wan_pair(monkeypatch, **kw)
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(got.skips.reshape(-1), np.asarray(want.skips).reshape(-1))
    if "use_magcache" in kw:
        assert got.skips.any()
        np.testing.assert_array_equal(got.skips, tp.skip_mask_for())
    if kw.get("cache_policy") == "rolling":
        np.testing.assert_array_equal(got.skips.reshape(-1), troll.compute_rolling_schedule(
            2 * STEPS, troll.load_eval_ratios(), 0.12, 2))


@pytest.mark.parametrize("solver", ["dpm++", "euler"])
def test_wan_calibration_on_the_solver_trajectory_matches_jax(solver, monkeypatch):
    want, got, tp = run_wan_pair(monkeypatch, sample_solver=solver,
                                 magcache_calibration=True)
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=TOL, rtol=TOL)
    assert len(got.calibration["norm_ratio"]) == 2 * (STEPS - 1)
    for name, vals in got.calibration.items():
        np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    # the recorded ratios install as the run's MagCache ratios
    cfg = tpipe.WanPipelineConfig(tiny=True, sample_steps=STEPS, sample_solver=solver,
                                  use_magcache=True,
                                  mag_ratios_override=tuple(got.calibration["norm_ratio"]))
    cal = tpipe.WanPipeline(cfg, "cpu", model=tp.model)._cache_cfg()
    assert len(cal.mag_ratios) == 2 * STEPS and cal.mag_ratios[2:] == tuple(
        got.calibration["norm_ratio"])


def test_wan_refusals():
    with pytest.raises(ValueError, match="sample_solver"):
        tpipe.WanPipelineConfig(sample_solver="heun")
    with pytest.raises(ValueError, match="cache_policy"):
        tpipe.WanPipelineConfig(cache_policy="lru")
    # both run under sequence parallelism (tests/test_torch_sp_wan_tasks.py)
    assert tpipe.WanPipelineConfig(sample_solver="dpm++", sp=2).sp == 2
    assert tpipe.WanPipelineConfig(cache_policy="rolling", sp=2).sp == 2


@pytest.mark.parametrize("flags,want_skips", [
    (["--sample_solver", "dpm++"], 0),
    (["--sample_solver", "euler", "--use_magcache", "--magcache_thresh", "0.3"], None),
    (["--cache_policy", "rolling", "--use_magcache", "--magcache_thresh", "0.12",
      "--magcache_K", "2"], 8),
])
def test_cli_solver_and_policy_flags(flags, want_skips, tmp_path, capsys):
    out = str(tmp_path / "out")
    cli.main(["--tiny", "--device", "cpu", "--sample_steps", str(STEPS),
              "--save_file", out] + flags)
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 3, 4, 8, 16) and np.isfinite(lat).all()
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("skipped")][-1]
    skipped = int(line.split()[1])
    assert skipped > 0 if want_skips is None else skipped == want_skips
