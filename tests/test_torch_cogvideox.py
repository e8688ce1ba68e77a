"""The port's CogVideoX slice against the JAX package on the CPU: the DDIM and
DPM schedules (bit-equal), ``sample_dpm_cogvideo``, the weight converter,
the core with and without PAB, the pipeline (full compute, MagCache,
dynamic CFG through the step-indexed ``combine_fn``, calibration, skip-mask
overrides, PAB) and the CLI.

Both sides get the same weights (``init_cogvideox_params`` converted by
``cogvideox_params_from_numpy``) and the same numpy inputs.
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
from magcache_tpu.models import cogvideox as J
from magcache_tpu.pipelines import cogvideox as jpipe
from magcache_tpu.schedulers import ddim_cogvideo as jsched
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core import pab as tpab
from magcache_tpu_torch.core.magcache import MagCacheConfig, compute_skip_schedule
from magcache_tpu_torch.core.sampler import sample_dpm_cogvideo
from magcache_tpu_torch.models import cogvideox as T
from magcache_tpu_torch.models.convert import cogvideox_params_from_numpy
from magcache_tpu_torch.pipelines import cogvideox as tpipe
from magcache_tpu_torch.schedulers import ddim_cogvideo as tsched
from tests.test_torch_latte import _latents_close

# f32 on both sides: GEMM and reduction order only
F32_TOL = 2e-5
# bf16: JAX rounds at other places around the unfused ops
BF16_REL_L2 = 2e-2

# head dim 64 as published (RoPE axes 16 / 24 / 24); 2 frames of 3 x 4 patches
NARROW = dict(hidden=128, heads=2, layers=2, text_dim=24, time_embed_dim=32)
GRID, TXT = (2, 3, 4), 5
# the joint attention and the FFN each reuse and refresh within 6 steps
SMALL_PAB = dict(spatial_broadcast=True, spatial_threshold=(0, 1000), spatial_range=2,
                 mlp_broadcast=True, mlp_threshold=(0, 1000), mlp_range=3)


def _np(a):
    return np.array(a, np.float32)


def _models(dtype, seed=0):
    cfg_kw = dict(NARROW, dtype=dtype)
    jcfg, tcfg = J.CogVideoXConfig(**cfg_kw), T.CogVideoXConfig(**cfg_kw)
    params = J.init_cogvideox_params(jax.random.PRNGKey(seed), jcfg)
    # the norms' affines away from 1 / 0, so the converter's mapping shows
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, params)
    for name in ("ln1_w", "ln2_b", "q_norm_w", "k_norm_b"):
        tree["blocks"][name] = (tree["blocks"][name]
                                + 0.1 * rng.standard_normal(tree["blocks"][name].shape)
                                ).astype(np.float32)
    tree["norm_out_w"] = (tree["norm_out_w"] + 0.1 * rng.standard_normal(128)).astype(
        np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    model = T.CogVideoXModel(tcfg, "cpu")
    model.load_state_dict(cogvideox_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, params, model


def _inputs(rows=2, seed=1):
    rng = np.random.default_rng(seed)
    t, h, w = GRID
    x = rng.standard_normal((rows, t, 2 * h, 2 * w, 16)).astype(np.float32)
    txt = rng.standard_normal((rows, TXT, NARROW["text_dim"])).astype(np.float32)
    return x, txt, np.array([600.0, 600.0][:rows], np.float32)


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("steps", [50, 20, 7])
def test_ddim_and_dpm_schedules_bit_equal_to_jax(steps):
    t, j = tsched.CogVideoDDIMSchedule.create(steps), jsched.CogVideoDDIMSchedule.create(steps)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    np.testing.assert_array_equal(t.alphas_cumprod, j.alphas_cumprod)
    for got, want in zip(t.step_arrays(), j.step_arrays()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert t.alphas_cumprod[-1] == 0.0       # zero terminal SNR
    t, j = tsched.CogVideoDPMSchedule.create(steps), jsched.CogVideoDPMSchedule.create(steps)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for got, want in zip(t.step_arrays(), j.step_arrays()):
        np.testing.assert_array_equal(got, want)
    acp = np.cumprod(1 - np.linspace(0.01, 0.1, 30))
    np.testing.assert_array_equal(tsched._rescale_zero_terminal_snr(acp),
                                  jsched._rescale_zero_terminal_snr(acp))


# ---------------------------------------------------------------- model
def test_converter_carries_every_parameter_with_jax_dtypes():
    cfg = T.CogVideoXConfig(**NARROW, dtype="bfloat16")
    jp = J.init_cogvideox_params(jax.random.PRNGKey(0),
                                 J.CogVideoXConfig(**NARROW, dtype="bfloat16"))
    sd = T.CogVideoXModel(cfg, "cpu").state_dict()
    conv = cogvideox_params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("patch_embed.weight", "text_proj.bias", "blocks.0.mod1.weight",
              "blocks.1.qkv.weight", "blocks.0.ff2.bias"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("time.in.weight", "blocks.0.ln1_w", "blocks.1.q_norm_b", "norm_final_w",
              "final_mod.weight", "final_out.bias"):
        assert sd[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["blocks.1.ff1.weight"].float().numpy(),
                                  _np(jp["blocks"]["ff1"]["w"][1]).T)


def test_cogvideox_5b_is_the_jax_geometry():
    cfg = T.COGVIDEOX_5B
    j = J.CogVideoXConfig()
    for f in dataclasses.fields(j):
        if f.name != "remat":
            assert getattr(cfg, f.name) == getattr(j, f.name), f.name
    assert (cfg.head_dim, cfg.cond_dim) == (64, 3072)
    m = T.CogVideoXModel(cfg, "meta")
    n = sum(p.numel() for p in m.parameters())
    assert 9.4e9 < n < 9.6e9           # the LayerNormZero linears read 3,072 wide
    for grid in ((13, 30, 45), GRID):
        for g, w in zip(T.cogvideo_rope_tables(cfg, grid), J.cogvideo_rope_tables(j, grid)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cogvideox_core_matches_jax(dtype):
    jcfg, params, model = _models(dtype)
    jcore = J.make_cogvideox_core(jcfg, TXT, GRID)
    tcore = T.make_cogvideox_core(model, TXT, GRID)
    x, txt, t = _inputs()
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"txt": jnp.asarray(txt)})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"txt": torch.from_numpy(txt)})
    assert ht.dtype == model.cfg.torch_dtype and ht.shape == (2, 24, 128)
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == x.shape and np.isfinite(ot).all()
    for got, want in ((_np(ht.float()), _np(hj)), (_np(ct["txt"].float()), _np(cj["txt"])),
                      (trt, _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def _combine(g):
    return lambda chunks: chunks[1] + g * (chunks[0] - chunks[1])


@pytest.mark.parametrize("sampler,pab,cached", [("ddim", True, False), ("ddim", True, True),
                                                ("dpm", False, False), ("dpm", False, True)])
def test_samplers_and_pab_match_jax(sampler, pab, cached):
    """CogVideoX's DDIM (``sample_euler`` with ``x_coeffs``) under PAB, and
    ``sample_dpm_cogvideo``, each with and without a cache schedule."""
    steps = 6
    jcfg, params, model = _models("float32", seed=3)
    ddim = tsched.CogVideoDDIMSchedule.create(steps)
    ts = ddim.timesteps.astype(np.float32)
    tp = jp = None
    if pab:
        tp, jp = tpab.PABConfig(**SMALL_PAB), jpab.PABConfig(**SMALL_PAB)
        masks = tpab.broadcast_masks(tp, ts)
        assert all(masks[k].any() and not masks[k].all() for k in ("spatial", "mlp"))
    jcore = J.make_cogvideox_core(jcfg, TXT, GRID, pab=jp, timesteps=ts)
    tcore = T.make_cogvideox_core(model, TXT, GRID, pab=tp, timesteps=ts)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((1, 2, 6, 8, 16)).astype(np.float32)
    txt = rng.standard_normal((2, TXT, NARROW["text_dim"])).astype(np.float32)
    kw, jkw = dict(lanes=2), dict(lanes=2)
    if cached:
        cfg = dict(num_steps=steps, mag_ratios=tuple(np.linspace(1.0, 0.96, steps)),
                   thresh=0.2, max_consecutive_skips=2, retention_ratio=0.2)
        kw["cache_cfg"], jkw["cache_cfg"] = MagCacheConfig(**cfg), JMagCacheConfig(**cfg)
    jcond, tcond = {"txt": jnp.asarray(txt)}, {"txt": torch.from_numpy(txt)}
    if sampler == "ddim":
        c_x, c_v = ddim.step_arrays()
        kw.update(timesteps=ts, dts=c_v, x_coeffs=c_x)
        jkw.update(timesteps=ts, dts=c_v, x_coeffs=c_x)
        jout = jax.jit(lambda p, z_, c: jsampler.sample_euler(
            jcore, p, z_, c, combine_fn=_combine(6.0), **jkw))(params, jnp.asarray(z), jcond)
        from magcache_tpu_torch.core.sampler import sample_euler
        tout, skips = sample_euler(tcore, torch.from_numpy(z), tcond, combine_fn=_combine(6.0),
                                   return_skips=True, **kw)
    else:
        jsch = jsched.CogVideoDPMSchedule.create(steps)
        jout = jax.jit(lambda p, z_, c: jsampler.sample_dpm_cogvideo(
            jcore, p, z_, c, jsch, combine_fn=_combine(6.0), **jkw))(
                params, jnp.asarray(z), jcond)
        tout, skips = sample_dpm_cogvideo(tcore, torch.from_numpy(z), tcond,
                                          tsched.CogVideoDPMSchedule.create(steps),
                                          combine_fn=_combine(6.0), return_skips=True, **kw)
    _latents_close(tout.numpy(), _np(jout))
    if cached:
        np.testing.assert_array_equal(skips, compute_skip_schedule(
            kw["cache_cfg"]).reshape(steps, 1))
        assert skips.any()


def test_pab_state_holds_only_the_slots_a_mask_reads():
    _, _, model = _models("float32")
    ts = tsched.CogVideoDDIMSchedule.create(50).timesteps.astype(np.float32)
    core = T.make_cogvideox_core(model, TXT, GRID, pab=tpab.COGVIDEOX_PAB, timesteps=ts)
    x, txt, t = _inputs()
    hidden, ctx = core.prepare(torch.from_numpy(x), torch.from_numpy(t),
                               {"txt": torch.from_numpy(txt)})
    state = core.init_state(hidden, ctx)
    assert list(state) == ["attn"] and state["attn"].shape == (2, 2, TXT + 24, 128)
    with pytest.raises(ValueError, match="timesteps"):
        T.make_cogvideox_core(model, TXT, GRID, pab=tpab.COGVIDEOX_PAB)


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(**kw):
    base = dict(tiny=True, num_frames=5, height=32, width=48, num_inference_steps=6,
                txt_len=7, dtype="float32")
    base.update(kw)
    j = jpipe.CogVideoXPipeline(jpipe.CogVideoXPipelineConfig(**base))
    tcfg = tpipe.CogVideoXPipelineConfig(**base)
    model = T.CogVideoXModel(tcfg.model_config(), "cpu")
    model.load_state_dict(cogvideox_params_from_numpy(jax.tree.map(np.asarray, j.params),
                                                      tcfg.model_config(), "cpu"))
    return j, tpipe.CogVideoXPipeline(tcfg, "cpu", model=model)


RATIOS = tuple(np.linspace(1.0, 0.95, 5))


@pytest.mark.parametrize("kw", [dict(use_magcache=True, magcache_ratios=RATIOS),
                                dict(use_dynamic_cfg=True, use_magcache=True,
                                     magcache_ratios=RATIOS),
                                dict(magcache_calibration=True),
                                dict(enable_pab=True, pab_config=tpab.PABConfig(**SMALL_PAB))])
def test_pipeline_latents_match_jax(kw, monkeypatch):
    jkw = dict(kw)
    if "pab_config" in kw:
        jkw["pab_config"] = jpab.PABConfig(**SMALL_PAB)
    jp = jpipe.CogVideoXPipeline(jpipe.CogVideoXPipelineConfig(
        tiny=True, num_frames=5, height=32, width=48, num_inference_steps=6, txt_len=7,
        dtype="float32", **jkw))
    tcfg = tpipe.CogVideoXPipelineConfig(tiny=True, num_frames=5, height=32, width=48,
                                         num_inference_steps=6, txt_len=7, dtype="float32",
                                         **kw)
    model = T.CogVideoXModel(tcfg.model_config(), "cpu")
    model.load_state_dict(cogvideox_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                      tcfg.model_config(), "cpu"))
    tp = tpipe.CogVideoXPipeline(tcfg, "cpu", model=model)
    assert tp.latent_shape == jp.latent_shape == (2, 4, 6, 16) and tp.grid == jp.grid
    z = _np(jax.random.normal(j_set_seed(5), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    _latents_close(got.latents.numpy(), _np(want.latents))
    if "magcache_calibration" in kw:
        assert got.skips is None
        for name, vals in got.calibration.items():
            assert len(vals) == 5
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        np.testing.assert_array_equal(got.skips, tp.skip_mask_for(
            use_magcache=bool(kw.get("use_magcache"))))
        assert got.skips.any() == bool(kw.get("use_magcache"))


def test_dynamic_cfg_ramp_follows_the_reference_formula():
    _, tp = _pipeline_pair(use_dynamic_cfg=True, num_inference_steps=50, guidance_scale=6.0)
    gs = tp.guidance_scales()
    ts = tp.schedule.timesteps
    assert gs.dtype == np.float32 and len(gs) == 50
    # the reference's quirk: t is the timestep's value, not the step index
    np.testing.assert_allclose(gs, 1 + 6.0 * (1 - np.cos(np.pi * ((50 - ts) / 50.0) ** 5)) / 2,
                               rtol=1e-6)
    assert gs[0] == pytest.approx(1 + 6.0 * (1 - np.cos(np.pi * (-930 / 50) ** 5)) / 2,
                                  rel=1e-5)


def test_skip_mask_for_and_override_follow_jax(monkeypatch):
    jp, tp = _pipeline_pair(num_inference_steps=8, magcache_ratios=tuple(
        np.linspace(1.0, 0.9, 7)))
    for e, k, r in ((None, None, None), (0.06, 2, 0.1), (0.3, 4, 0.3)):
        np.testing.assert_array_equal(tp.skip_mask_for(e, k, r), jp.skip_mask_for(e, k, r))
    np.testing.assert_array_equal(tp.skip_mask_for(use_magcache=False),
                                  np.zeros((8, 1), bool))
    mask = tp.skip_mask_for(0.3, 4, 0.2)
    assert mask.any()
    z = _np(jax.random.normal(j_set_seed(1), (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    got = tp.generate("a cat", seed=1, skip_override=mask)
    want = jp.generate("a cat", seed=1, skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)
    _latents_close(got.latents.numpy(), _np(want.latents))
    # a dynamic-CFG or calibration request with an override raises ValueError
    for kw in (dict(use_dynamic_cfg=True), dict(magcache_calibration=True)):
        tp.config = dataclasses.replace(tp.config, **kw)
        with pytest.raises(ValueError, match="skip_override"):
            tp.generate("a cat", skip_override=mask)


# ---------------------------------------------------------------- CLI
def test_cli_cogvideox_tiny(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--task", "cogvideox", "--tiny", "--device", "cpu", "--dtype", "float32",
              "--magcache_calibration", "--sample_steps", "8", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 7 and all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--task", "cogvideox", "--tiny", "--device", "cpu", "--use_magcache",
              "--mag_ratios_json", cal + "_mag_ratio.json", "--sample_steps", "8",
              "--use_dynamic_cfg", "--enable_pab", "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 2, 4, 4, 16) and np.isfinite(lat).all()
    text = capsys.readouterr().out
    assert "of 8 forwards (cond + uncond as one joint batch per step)" in text
    assert "mode=magcache+pab" in text
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "latte", "--tiny", "--device", "cpu", "--use_dynamic_cfg"])
