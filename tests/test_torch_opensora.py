"""The port's Open-Sora 1.2 slice against the JAX package on the CPU: RFLOW,
the opensora-v1.2 skip schedule, the t2v conditioning helpers, STDiT3 (the
packed-path block through K5-K8's plain versions against the JAX core with
its Pallas kernels in interpret mode), the weight converter, ``sample_euler``
with MagCache and calibration, the pipeline and the CLI route.

Both sides get the same weights (``init_stdit3_params`` converted by
``stdit3_params_from_numpy``) and the same numpy inputs.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core import sampler as jsampler
from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import stdit3 as J
from magcache_tpu.pipelines import open_sora as jpipe
from magcache_tpu.pipelines import open_sora_cond as joc
from magcache_tpu.schedulers.rflow import RFlowSchedule as JRFlow
from magcache_tpu.utils.misc import set_seed as j_set_seed
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.pab import OPEN_SORA_PAB
from magcache_tpu_torch.core.sampler import lane_skip_masks, sample_euler
from magcache_tpu_torch.models import stdit3 as T
from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
from magcache_tpu_torch.pipelines import open_sora as tpipe
from magcache_tpu_torch.pipelines import open_sora_cond as toc
from magcache_tpu_torch.schedulers.rflow import RFlowSchedule

# f32 on both sides: GEMM and reduction order only (measured ~3e-6 at |h| < 9)
F32_TOL = 2e-5
# bf16: JAX rounds at other places around the unfused ops (the temporal qkv
# bias add, K6's normaliser taken from bf16-rounded p): rel L2 measured 5e-3
BF16_REL_L2 = 2e-2

# head dim 72 as published; S = 15 is not a multiple of 16, T = 3 frames
NARROW = dict(hidden=144, heads=2, depth=2, caption_dim=24, freq_dim=32,
              caption_max_len=5)
GRID, PIXELS, CAP = (3, 3, 5), (48, 80), 5


def _models(dtype, seed=0, **kw):
    cfg_kw = dict(NARROW, dtype=dtype, **kw)
    jcfg, tcfg = J.STDiT3Config(**cfg_kw), T.STDiT3Config(**cfg_kw)
    params = J.init_stdit3_params(jax.random.PRNGKey(seed), jcfg)
    model = T.STDiT3Model(tcfg, "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"))
    return jcfg, params, model


def _np(a):
    return np.array(a, np.float32)


# ---------------------------------------------------------------- RFLOW
@pytest.mark.parametrize("kw", [
    dict(use_timestep_transform=True, height=480, width=854, num_frames=51),
    dict(use_timestep_transform=True, height=720, width=1280, num_frames=102),
    dict(use_timestep_transform=True, height=32, width=32, num_frames=8),
    dict(use_discrete_timesteps=True)])
def test_rflow_schedule_bit_equal_to_jax(kw):
    t, j = RFlowSchedule.create(30, **kw), JRFlow.create(30, **kw)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert t.timesteps.dtype == np.float32
    np.testing.assert_array_equal(
        t.dts(), np.array([j.dt(i) for i in range(30)], np.float32))


@pytest.mark.parametrize("steps,E,K,R", [(30, None, None, None), (30, 0.24, 4, 0.1),
                                         (50, None, None, None), (10, 0.06, 2, 0.2)])
def test_opensora_skip_schedule_bit_equal_to_jax(steps, E, K, R):
    kw = dict(thresh=E, K=K, retention_ratio=R)
    got = compute_skip_schedule(make_config("opensora-v1.2", steps, **kw))
    want = np.asarray(j_schedule(j_make_config("opensora-v1.2", steps, **kw)))
    np.testing.assert_array_equal(got, want)
    if steps == 30 and E is None:
        assert got.sum() == 18
        assert np.flatnonzero(got).tolist() == [6, 7, 8, 10, 11, 12, 14, 15, 16,
                                                18, 19, 20, 22, 23, 24, 26, 27, 28]


# ---------------------------------------------------------------- conditioning
PROMPTS = ["A cat plays piano. <b>Bold</b> &amp; https://example.com/x #12",
           "|0|a red boat at dawn|2|the boat sails away",
           "Ünïcödé quotes “like” this — and an id ab12345 IMG_001.jpg",
           'a dog {"reference_path": "x.npy", "mask_strategy": "0"}']


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompt_helpers_match_jax(prompt):
    got = toc.extract_json_from_prompts([prompt], [""], [""])
    assert got == joc.extract_json_from_prompts([prompt], [""], [""])
    p = got[0][0]
    segs, idxs = toc.split_prompt(p)
    assert (segs, idxs) == joc.split_prompt(p)
    for kw in (dict(aes=6.5), dict(aes=6.5, flow=4.0, camera_motion="pan left")):
        assert toc.append_score_to_prompts(segs, **kw) == joc.append_score_to_prompts(segs, **kw)
    for use in (True, False):
        assert [toc.text_preprocessing(s, use) for s in segs] == \
            [joc.text_preprocessing(s, use) for s in segs]
    merged = toc.merge_prompt(segs, idxs)
    assert merged == joc.merge_prompt(segs, idxs)
    for loop in range(3):
        assert toc.extract_prompts_loop([merged], loop) == joc.extract_prompts_loop([merged], loop)


def test_buckets_and_frame_counts_match_jax():
    for res, ar in (("480p", "9:16"), ("720p", "16:9"), ("240p", "1:1"), ("480p", "3:4")):
        assert toc.get_image_size(res, ar) == joc.get_image_size(res, ar)
    for n in ("2s", "4x", 51, 8, 17, 1, 102):
        assert toc.get_num_frames(n) == joc.get_num_frames(n)
        assert toc.get_latent_t(toc.get_num_frames(n)) == joc.get_latent_t(joc.get_num_frames(n))
    assert toc.get_image_size("480p", "9:16") == (480, 854)
    assert toc.get_latent_t(51) == 15


# ---------------------------------------------------------------- STDiT3
def _inputs(rows=2, seed=1):
    rng = np.random.default_rng(seed)
    t, h, w = GRID
    x = rng.standard_normal((rows, t, 2 * h, 2 * w, 4)).astype(np.float32)
    y = rng.standard_normal((rows, CAP, NARROW["caption_dim"])).astype(np.float32)
    return x, y, np.array([800.0, 800.0][:rows], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stdit3_forward_matches_jax_packed_kernels(dtype, monkeypatch):
    # the JAX core takes its packed path (K5-K8 in interpret mode) on the CPU
    monkeypatch.setenv("MAGCACHE_STDIT3_PACKED", "interpret")
    jcfg, params, model = _models(dtype)
    jcore = J.make_stdit3_core(jcfg, GRID, CAP, pixel_size=PIXELS)
    tcore = T.make_stdit3_core(model, GRID, pixel_size=PIXELS)
    x, y, t = _inputs()
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {"y": jnp.asarray(y)})
    trj = jax.jit(jcore.trunk)(params, hj, cj)
    oj = jax.jit(jcore.head)(params, trj, cj)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {"y": torch.from_numpy(y)})
    assert ht.dtype == model.cfg.torch_dtype and ht.shape == (2, 45, 144)
    for key in ("t6", "te", "y"):
        np.testing.assert_allclose(ct[key].float().numpy(), _np(cj[key]),
                                   atol=F32_TOL, rtol=F32_TOL)
    # the port's trunk on JAX's embeddings isolates the blocks
    feed = {k: torch.from_numpy(_np(v)).to(ct[k].dtype) for k, v in cj.items()}
    trt = tcore.trunk(torch.from_numpy(_np(hj)).to(ht.dtype), feed).float().numpy()
    ot = tcore.head(tcore.trunk(ht, ct), ct).numpy()
    assert ot.shape == (2, 3, 6, 10, 8) and np.isfinite(ot).all()
    for got, want in ((trt, _np(trj)), (ot, _np(oj))):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def test_converter_carries_every_parameter_with_jax_dtypes():
    jp = J.init_stdit3_params(jax.random.PRNGKey(0),
                              J.STDiT3Config(**NARROW, dtype="bfloat16"))
    tcfg = T.STDiT3Config(**NARROW, dtype="bfloat16")
    sd = T.STDiT3Model(tcfg, "cpu").state_dict()
    conv = stdit3_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("spatial.0.qkv.weight", "temporal.1.mlp2.bias", "spatial.1.cross_kv.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("patch_embed.weight", "t_block.weight", "y_null", "final.out.weight",
              "temporal.0.scale_shift", "spatial.1.q_norm"):
        assert sd[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["spatial.1.qkv.weight"].float().numpy(),
                                  _np(jp["spatial"]["qkv"]["w"][1]).T)


def test_pos_embed_and_random_init_follow_jax():
    for args in ((144, 3, 5), (144, 30, 53, 1.6, 40), (64, 4, 4, 0.5)):
        np.testing.assert_array_equal(T.pos_embed_2d(*args), J._pos_embed_2d(*args))
    cfg = T.STDiT3Config(**NARROW)
    m = T.STDiT3Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert not m.spatial[0].qkv.bias.any() and (m.temporal[1].k_norm == 1).all()
    std = float(m.spatial[0].mlp2.weight.detach().std())
    assert abs(std - (4 * 144) ** -0.5) < 0.1 * (4 * 144) ** -0.5


def test_unported_stdit3_paths_raise():
    _, _, model = _models("float32")
    # PAB is ported on the packed route; the unpacked routes raise under it
    for route in ("grouped", "vpu"):
        with pytest.raises(NotImplementedError, match="PAB"):
            T.make_stdit3_core(model, GRID, route=route, pab=OPEN_SORA_PAB,
                               timesteps=np.ones(2))
    assert T.make_stdit3_core(model, GRID, pab=OPEN_SORA_PAB,
                              timesteps=np.ones(2)).init_state is not None
    x, y, t = _inputs()
    # qk_norm=False is ported (the row max, not the JAX packed path's fixed
    # shift): the packed route against the JAX core's unpacked composition
    # (its default off the TPU)
    jcfg, params, plain = _models("float32", qk_norm=False)
    jcore = J.make_stdit3_core(jcfg, GRID, CAP, pixel_size=PIXELS)
    hj, cj = jcore.prepare(params, jnp.asarray(x), jnp.asarray(t), {"y": jnp.asarray(y)})
    want = _np(jcore.head(params, jcore.trunk(params, hj, cj), cj))
    tcore = T.make_stdit3_core(plain, GRID, pixel_size=PIXELS)
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t), {"y": torch.from_numpy(y)})
    np.testing.assert_allclose(tcore.head(tcore.trunk(ht, ct), ct).numpy(), want,
                               atol=F32_TOL, rtol=F32_TOL)
    # frames above 2,048 tokens (K1q) and masked frames are ported
    core = T.make_stdit3_core(model, GRID)
    _, ctx = core.prepare(torch.from_numpy(x), torch.from_numpy(t),
                          {"y": torch.from_numpy(y),
                           "x_mask": torch.ones(2, 3, dtype=torch.bool)})
    assert {"t6_zero", "te_zero", "x_mask"} <= ctx.keys()
    T.make_stdit3_core(model, (2, 46, 46))


# ---------------------------------------------------------------- sampler
def _combine(g, c):
    return lambda chunks: chunks[1][..., :c] + g * (chunks[0][..., :c] - chunks[1][..., :c])


@pytest.mark.parametrize("mode", ["magcache", "calibrate", "override"])
def test_sample_euler_matches_jax(mode):
    steps = 10
    jcfg, params, model = _models("float32", seed=2)
    jcore = J.make_stdit3_core(jcfg, GRID, CAP, pixel_size=PIXELS)
    tcore = T.make_stdit3_core(model, GRID, pixel_size=PIXELS)
    sch = RFlowSchedule.create(steps, use_timestep_transform=True, height=48,
                               width=80, num_frames=9)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 3, 6, 10, 4)).astype(np.float32)
    y = rng.standard_normal((2, CAP, NARROW["caption_dim"])).astype(np.float32)
    fps = np.full((2,), 24.0, np.float32)
    kw = dict(timesteps=sch.timesteps, dts=sch.dts(), lanes=2)
    override = np.zeros((steps, 1), bool)
    override[[2, 3, 5, 8]] = True
    if mode == "calibrate":
        kw.update(calibrate=True, calibrate_lanes=1)
    else:
        kw.update(cache_cfg=make_config("opensora-v1.2", steps, thresh=0.24, K=3),
                  return_skips=True)
    jkw = dict(kw, cache_cfg=(j_make_config("opensora-v1.2", steps, thresh=0.24, K=3)
                              if "cache_cfg" in kw else None))
    if mode == "override":
        kw["skip_mask_override"] = override
        jkw["skip_mask_override"] = jnp.asarray(override)
    jout = jax.jit(lambda p, z_, c: jsampler.sample_euler(
        jcore, p, z_, c, combine_fn=_combine(7.0, 4), **jkw))(
            params, jnp.asarray(z), {"y": jnp.asarray(y), "fps": jnp.asarray(fps)})
    tout = sample_euler(tcore, torch.from_numpy(z),
                        {"y": torch.from_numpy(y), "fps": torch.from_numpy(fps)},
                        combine_fn=_combine(7.0, 4), **kw)
    np.testing.assert_allclose(tout[0].numpy(), _np(jout[0]), atol=1e-4, rtol=1e-4)
    if mode == "calibrate":
        assert tout[1].shape == (steps - 1, 1, 3)
        np.testing.assert_allclose(tout[1], np.asarray(jout[1]), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_array_equal(tout[1], np.asarray(jout[1]))
        want = override if mode == "override" else compute_skip_schedule(
            kw["cache_cfg"]).reshape(steps, 1)
        np.testing.assert_array_equal(tout[1], want)
        assert tout[1].any()


def test_sample_euler_unported_options_raise():
    # x_coeffs (DDIM-eps) and ancestral noise are ported: noise_scales comes
    # with a noise_fn, and the JAX noise_key raises naming it
    with pytest.raises(ValueError, match="noise_fn"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     noise_scales=np.ones(2))
    with pytest.raises(NotImplementedError, match="noise_key.*noise_fn"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     noise_key=0)
    # post_step and dpm_coeffs are ported; dpm++ replaces the linear update
    with pytest.raises(ValueError, match="dpm_coeffs"):
        sample_euler(None, torch.zeros(1), {}, timesteps=np.ones(2), dts=np.ones(2),
                     x_coeffs=np.ones(2), post_step=lambda x: x,
                     dpm_coeffs=dict.fromkeys(("sigma_t", "a", "b", "c_x", "c_d"),
                                              np.ones(2)))


# ---------------------------------------------------------------- pipeline
def _pipeline_pair(**kw):
    base = dict(tiny=True, num_frames=8, height=32, width=32, num_sampling_steps=6,
                caption_len=6, dtype="float32")
    base.update(kw)
    jcfg = jpipe.OpenSoraPipelineConfig(**base)
    j = jpipe.OpenSoraPipeline(jcfg)
    tcfg = tpipe.OpenSoraPipelineConfig(**base)
    model = T.STDiT3Model(tcfg.model_config(), "cpu")
    model.load_state_dict(stdit3_params_from_numpy(
        jax.tree.map(np.asarray, j.params), tcfg.model_config(), "cpu"))
    return j, tpipe.OpenSoraPipeline(tcfg, "cpu", model=model)


@pytest.mark.parametrize("kw", [dict(use_magcache=True),
                                dict(use_magcache=True, magcache_thresh=0.5, magcache_K=2),
                                dict(magcache_calibration=True)])
def test_pipeline_latents_match_jax(kw, monkeypatch):
    jp, tp = _pipeline_pair(**kw)
    key = j_set_seed(5)
    _, zkey, _ = jax.random.split(key, 3)
    z = _np(jax.random.normal(zkey, (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda seed: torch.from_numpy(z))
    assert tp.latent_shape == jp.latent_shape == (2, 4, 4, 4)
    want = jp.generate("a red boat at dawn", seed=5)
    got = tp.generate("a red boat at dawn", seed=5)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents),
                               atol=1e-4, rtol=1e-4)
    if "magcache_calibration" in kw:
        for name, vals in got.calibration.items():
            np.testing.assert_allclose(vals, want.calibration[name], atol=2e-5)
    else:
        np.testing.assert_array_equal(
            got.skips, compute_skip_schedule(tp._cache_cfg()).reshape(6, 1))


def test_pipeline_unported_paths_raise():
    # the rolling policy and PAB are ported (PAB on the packed route only)
    with pytest.raises(ValueError, match="cache_policy"):
        tpipe.OpenSoraPipelineConfig(cache_policy="lru")
    for route in ("grouped", "vpu"):
        with pytest.raises(NotImplementedError, match="PAB"):
            tpipe.OpenSoraPipeline(tpipe.OpenSoraPipelineConfig(
                tiny=True, num_frames=8, height=32, width=32, num_sampling_steps=2,
                caption_len=6, enable_pab=True, route=route), "cpu")
    cfg = tpipe.OpenSoraPipelineConfig(tiny=True, num_frames=8, height=32, width=32,
                                       num_sampling_steps=2, caption_len=6,
                                       resolution=None)
    pipe = tpipe.OpenSoraPipeline(cfg, "cpu")
    # loops, mask strategies and .npy references run without a VAE; image
    # and video references are encoded by the pipeline's VAE
    # (test_torch_vae_temporal.py), and without one they raise
    for refs in ("x.png", "clip.mp4;x.npy"):
        with pytest.raises(ValueError, match="VAE"):
            pipe.generate("a boat", ms="0,0,0,0,1", refs=refs)
    assert tpipe.OpenSoraPipelineConfig(resolution="480p", aspect_ratio="9:16",
                                        num_frames="2s").width == 854


def test_cli_open_sora_tiny_route(tmp_path, capsys):
    cal = str(tmp_path / "cal")
    cli.main(["--task", "open-sora", "--tiny", "--device", "cpu",
              "--magcache_calibration", "--sample_steps", "8", "--save_file", cal])
    ratios = json.load(open(cal + "_mag_ratio.json"))
    assert len(ratios) == 7 and all(np.isfinite(ratios))
    out = str(tmp_path / "gen")
    cli.main(["--task", "open-sora", "--tiny", "--device", "cpu", "--use_magcache",
              "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 2, 4, 4, 4) and np.isfinite(lat).all()
    text = capsys.readouterr().out
    assert "skipped 18 of 30 forwards" in text
    assert "skipped steps [6, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20, 22, 23, 24, 26, 27, 28]" in text
    # every family is ported: a name outside them exits naming the prefixes
    with pytest.raises(SystemExit, match="matches no model family"):
        cli.main(["--task", "omnigen3", "--device", "cpu"])


@pytest.fixture(scope="module")
def override_pair():
    """The JAX and the port's tiny Open-Sora pipelines without caching, on
    the same weights: a per-request schedule is all that caches."""
    return _pipeline_pair()


@pytest.mark.parametrize("ekr", [dict(thresh=0.24, K=4, retention_ratio=0.1),
                                 dict(thresh=0.5, K=2),
                                 dict(retention_ratio=0.5),
                                 dict(use_magcache=False)])
def test_skip_override_matches_jax(ekr, override_pair, monkeypatch):
    jp, tp = override_pair
    got_mask, want_mask = tp.skip_mask_for(**ekr), np.asarray(jp.skip_mask_for(**ekr))
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got_mask.shape == (6, 1) and (got_mask.any() != ("use_magcache" in ekr))
    key = j_set_seed(5)
    _, zkey, _ = jax.random.split(key, 3)
    z = _np(jax.random.normal(zkey, (1,) + jp.latent_shape, jnp.float32))
    monkeypatch.setattr(tp, "_initial_noise", lambda gen: torch.from_numpy(z))
    want = jp.generate("a red boat at dawn", seed=5, skip_override=want_mask)
    got = tp.generate("a red boat at dawn", seed=5, skip_override=got_mask)
    np.testing.assert_allclose(got.latents.numpy(), _np(want.latents), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.skips, got_mask)


def test_skip_mask_for_without_arguments_keeps_the_config_schedule(override_pair):
    _, tp = override_pair
    # caching off: the config's own schedule is all False, an explicit
    # use_magcache=True the adapter rule (JAX's skip_mask_for)
    assert not tp.skip_mask_for().any() and tp.skip_mask_for(use_magcache=True).sum() > 0
    cached = tpipe.OpenSoraPipeline(dataclasses.replace(tp.config, use_magcache=True,
                                                        cache_policy="rolling"),
                                    "cpu", model=tp.model)
    np.testing.assert_array_equal(cached.skip_mask_for(), lane_skip_masks(
        cached._cache_cfg(), 6)[0])
    with pytest.raises(ValueError, match="plain t2v"):
        tp.generate("a boat", loop=2, condition_frame_length=1,
                    skip_override=tp.skip_mask_for(use_magcache=True))
