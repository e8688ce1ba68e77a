"""Wan2.1 i2v and flf2v in the port against the JAX package on the CPU, f32:
the image-conditioned block and forward (the CLIP tokens in front of the
text in one context, the ``y`` concat, ``img_emb``), the Wan VAE's encoder
whole and streamed, the causal VAE's encoder (the fallback), the image
encodes' masks and latents, the i2v and flf2v pipelines with MagCache and a
lane-asymmetric override, the skip schedules of the i2v and 14B presets,
TeaCache's i2v keys, the CLI tasks, and the trunk width the JAX config
gets wrong.

The JAX side is pinned to small widths with ``model_cfg_override`` (CLIP
features of 32, 17 tokens a image): the JAX default tiny i2v builds a
1,280-wide tower at 224 px.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.core.magcache import compute_skip_schedule as j_schedule
from magcache_tpu.core.presets import make_config as j_make_config
from magcache_tpu.models import clip as JC
from magcache_tpu.models import vae as JV
from magcache_tpu.models import vae_wan as JW
from magcache_tpu.models import wan as jwan
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu_torch.cli import generate as cli
from magcache_tpu_torch.core.magcache import compute_skip_schedule
from magcache_tpu_torch.core.presets import make_config
from magcache_tpu_torch.core.teacache import wan_teacache_settings
from magcache_tpu_torch.models import clip as TC
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models import wan as twan
from magcache_tpu_torch.models.convert import (causal_vae_params_from_numpy,
                                               clip_vision_params_from_numpy,
                                               wan_params_from_numpy,
                                               wan_vae_params_from_numpy)
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

# f32 on both sides; only GEMM/reduction summation order differs (the
# tolerance of tests/test_torch_wan.py for the t2v block)
TOL = 2e-4
# the VAEs' convs in f32 (tests/test_torch_vae_wan.py's)
VAE_TOL = 1e-4
# latents after the sampler, both sides f32
LATENT_TOL = 1e-4

I2V = dict(model_type="i2v", in_channels=36, clip_dim=32, clip_tokens=17)
FLF2V = dict(I2V, clip_tokens=34)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_params(init, cfg, seed):
    """A parameter tree in the layout ``init(key, cfg)`` returns, drawn with
    numpy (JAX's random compiles once a shape, seconds a VAE on the
    8-device test CPU): kernels ``N(0, 1/fan_in)``, vectors ``1 + 0.1 N(0,
    1)``."""
    rng = _rng(seed)

    def draw(s):
        if len(s.shape) <= 1:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree.map(draw, jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0)))


def _causal_params(cfg, seed):
    """``_numpy_params`` of the causal VAE, with its static time strides."""
    params = _numpy_params(JV.init_causal_vae_params, cfg, seed)
    for i, down in enumerate(cfg.temporal_downsample[:len(cfg.ch_mult) - 1]):
        params["encoder"][f"level{i}"]["down"]["tstride"] = 2 if down else 1
    return params


def _rng(seed):
    return np.random.default_rng(seed)


def _models(cfg_kw, grid, seed=0):
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    params = jwan.init_wan_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = twan.WanConfig.tiny(**cfg_kw)
    model = twan.WanModel(tcfg, "cpu")
    model.load_state_dict(wan_params_from_numpy(_np(params), tcfg, "cpu"))
    return (jwan.make_wan_core(jcfg, grid), params), twan.make_wan_core(model, grid), model


def _cond(cfg, grid, batch, seed):
    rng = _rng(seed)
    f, h, w = grid
    lat = (batch, f, 2 * h, 2 * w)
    return (rng.standard_normal(lat + (16,)).astype(np.float32),
            {"context": rng.standard_normal((batch, cfg.text_len, cfg.text_dim)).astype(np.float32),
             "y": rng.standard_normal(lat + (20,)).astype(np.float32),
             "clip_fea": rng.standard_normal((batch, cfg.clip_tokens, cfg.clip_dim)
                                             ).astype(np.float32)})


# ------------------------------------------------------------------ the DiT
@pytest.mark.parametrize("kind", ["i2v", "flf2v"])
@pytest.mark.parametrize("grid", [(2, 4, 4), (3, 8, 8)])
def test_forward_matches_jax(grid, kind):
    cfg_kw = I2V if kind == "i2v" else FLF2V
    (jcore, params), tcore, _ = _models(cfg_kw, grid, seed=1)
    cfg = twan.WanConfig.tiny(**cfg_kw)
    x, cond = _cond(cfg, grid, 2, seed=2)
    t = np.array([900.0, 250.0], np.float32)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.asarray(t),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    ht, ct = tcore.prepare(torch.from_numpy(x), torch.from_numpy(t),
                           {k: torch.from_numpy(v) for k, v in cond.items()})
    assert ct["context"].shape[1] == cfg.clip_tokens + cfg.text_len
    for key in ("e0", "context"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    oj = jcore.head(params, jcore.trunk(params, hj, cj), cj)
    ot = tcore.head(tcore.trunk(ht, ct), ct)
    assert ot.shape == x.shape
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=TOL, rtol=TOL)


def test_block_matches_jax_block_with_the_image_branch():
    cfg_kw = dict(I2V, layers=1)
    grid = (2, 8, 8)              # 128 queries over 17 image and 16 text keys
    (jcore, params), _, model = _models(cfg_kw, grid, seed=3)
    jcfg = jwan.WanConfig.tiny(**cfg_kw)
    x, cond = _cond(jcfg, grid, 1, seed=4)
    hj, cj = jax.jit(jcore.prepare)(params, jnp.asarray(x), jnp.full((1,), 500.0),
                                    {k: jnp.asarray(v) for k, v in cond.items()})
    cos, sin = jwan.wan_rope_tables(jcfg, grid)
    bp = jax.tree.map(lambda a: a[0], params["blocks"])
    want, _, _ = jax.jit(lambda p, carry: jwan._wan_block(
        jcfg, (jnp.asarray(cos), jnp.asarray(sin)), jcfg.clip_tokens, grid[1] * grid[2], p,
        carry))(bp, (hj, cj["e0"], cj["context"]))
    with torch.no_grad():
        got = model.blocks[0](*(torch.from_numpy(np.array(a)) for a in
                                (hj, cj["e0"], cj["context"], cos, sin)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the image branch is on: dropping it moves the output
    blk = model.blocks[0]
    with torch.no_grad():
        blk.cross_v_img.weight.zero_()
        blk.cross_v_img.bias.zero_()
        moved = blk(*(torch.from_numpy(np.array(a)) for a in
                      (hj, cj["e0"], cj["context"], cos, sin)))
    assert (moved - got).abs().max() > 1e-3


def test_i2v_converter_layout_and_dtypes():
    jp = jwan.init_wan_params(jax.random.PRNGKey(0), jwan.WanConfig.tiny(**I2V))
    tcfg = twan.WanConfig.tiny(dtype="bfloat16", **I2V)
    sd = twan.WanModel(tcfg, "cpu").state_dict()
    conv = wan_params_from_numpy(_np(jp), tcfg, "cpu")
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.dtype == conv[k].dtype and v.shape == conv[k].shape, k
    for k in ("blocks.1.cross_k_img.weight", "blocks.0.cross_v_img.bias",
              "patch_embedding.weight"):
        assert sd[k].dtype == torch.bfloat16, k
    for k in ("img_emb.in.weight", "img_emb.out.bias", "blocks.0.cross_norm_k_img"):
        assert sd[k].dtype == torch.float32, k
    assert sd["patch_embedding.weight"].shape == (tcfg.dim, 36 * 4)
    np.testing.assert_array_equal(conv["img_emb.out.weight"].numpy(),
                                  np.asarray(jp["img_emb"]["out"]["w"]).T)


def test_model_refuses_missing_conditioning_and_unported_variants():
    _, tcore, _ = _models(I2V, (2, 4, 4))
    x, cond = _cond(twan.WanConfig.tiny(**I2V), (2, 4, 4), 1, seed=5)
    t = torch.full((1,), 500.0)
    for drop in ("y", "clip_fea"):
        part = {k: torch.from_numpy(v) for k, v in cond.items() if k != drop}
        with pytest.raises(ValueError, match=drop):
            tcore.prepare(torch.from_numpy(x), t, part)
    # an i2v model without the CLIP branch takes the y concat alone
    _, core0, model0 = _models(dict(I2V, clip_tokens=0), (2, 4, 4))
    assert not hasattr(model0, "img_emb")
    h, c = core0.prepare(torch.from_numpy(x), t, {k: torch.from_numpy(cond[k])
                                                  for k in ("context", "y")})
    assert c["context"].shape[1] == 16 and torch.isfinite(core0.trunk(h, c)).all()


# ----------------------------------------------------------------- the VAEs
def _wan_vaes(cfg_kw, seed):
    jcfg, tcfg = JW.WanVAEConfig.tiny(**cfg_kw), TW.WanVAEConfig.tiny(**cfg_kw)
    params = _numpy_params(JW.init_wan_vae_params, jcfg, seed)
    vae = TW.WanVAE(tcfg, "cpu")
    vae.load_state_dict(wan_vae_params_from_numpy(params, tcfg))
    return JW.WanVAE(jcfg, params), vae


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("layout", ["wan2.1", "two transitions, patchify 2, normalized"])
def test_wan_vae_encode_matches_jax(layout, chunk):
    cfg_kw = {} if layout == "wan2.1" else dict(
        dim_mult=(1, 2, 2), temporal_down=(True, True), patchify=2,
        latent_mean=(0.1, -0.2, 0.0, 0.3), latent_std=(1.5, 0.5, 1.0, 2.0), latent_scale=1.2)
    jvae, tvae = _wan_vaes(cfg_kw, seed=6)
    side = 16 if layout == "wan2.1" else 32
    x = _rng(7).uniform(-1, 1, (1, 9, side, side, 3)).astype(np.float32)
    jm, jl = jvae.encode(jnp.asarray(x), pixel_chunk=chunk)
    tm, tl = tvae.encode(torch.from_numpy(x), pixel_chunk=chunk)
    assert tuple(tm.shape) == jm.shape == ((1, 5, 8, 8, 4) if layout == "wan2.1"
                                            else (1, 3, 4, 4, 4))
    for got, want in ((tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VAE_TOL, rtol=VAE_TOL)


def test_wan_vae_streamed_encode_equals_whole_and_refuses_off_phase_windows():
    _, tvae = _wan_vaes({}, seed=8)
    x = torch.from_numpy(_rng(9).uniform(-1, 1, (1, 13, 16, 16, 3)).astype(np.float32))
    whole, _ = tvae.encode(x, pixel_chunk=None)
    for chunk in (2, 4, 8):        # multiples of the tiny layout's time stride 2
        got, _ = tvae.encode(x, pixel_chunk=chunk)
        torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="time stride"):
        tvae.encode(x, pixel_chunk=3)
    one, _ = tvae.encode(x[:, :1])
    assert one.shape[1] == 1


@pytest.mark.parametrize("cfg_kw", [{}, dict(ch_mult=(1, 1, 2, 2), z_channels=16,
                                             temporal_downsample=(False, True, True, False))],
                         ids=["tiny", "wan strides"])
def test_causal_vae_encode_matches_jax(cfg_kw):
    jcfg, tcfg = JV.CausalVAEConfig.tiny(**cfg_kw), TV.CausalVAEConfig.tiny(**cfg_kw)
    params = _causal_params(jcfg, 10)
    vae = TV.CausalVAE(tcfg, "cpu")
    vae.load_state_dict(causal_vae_params_from_numpy(params, tcfg))
    x = _rng(11).uniform(-1, 1, (1, 9, 16, 24, 3)).astype(np.float32)
    jm, jl = jax.jit(JV.CausalVAE(jcfg, params).encode)(jnp.asarray(x))
    tm, tl = vae.encode(torch.from_numpy(x))
    assert tuple(tm.shape) == jm.shape
    for got, want in ((tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VAE_TOL, rtol=VAE_TOL)
    assert sum(p.numel() for p in vae.parameters()) == sum(
        a.size for a in jax.tree.leaves(params["encoder"]) if isinstance(a, np.ndarray))


# ------------------------------------------------------------ the pipelines
def _pipes(task, steps=6, **kw):
    """The JAX pipeline and the port's on the same DiT, CLIP tower and
    fallback VAE weights, at 64x32 x 9 frames. The JAX pipeline's encoders
    are set to what its ``_i2v_encoders`` builds (a 2-block tower of 32 at
    56 px, the tiny causal VAE), with numpy weights and a jitted encode."""
    cfg_kw = I2V if task == "i2v" else FLF2V
    base = dict(model="wan2.1-i2v-480p", task=task, tiny=True, size=(64, 32), frame_num=9,
                sample_steps=steps, sample_shift=3.0, guide_scale=5.0, dtype="float32", **kw)
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(
        model_cfg_override=jwan.WanConfig.tiny(**cfg_kw), **base))
    ccfg = JC.CLIPVisionConfig(dim=32, layers=2, heads=16, image_size=56)
    cparams = _numpy_params(JC.init_clip_vision_params, ccfg, 20)
    jp._clip = (ccfg, cparams, jax.jit(lambda pr, im: JC.clip_vision_forward(pr, ccfg, im)))
    vcfg = JV.CausalVAEConfig(base=8, ch_mult=(1, 1, 2, 2), blocks_per_level=1, groups=4)
    jvae = JV.CausalVAE(vcfg, _causal_params(vcfg, 21))
    jp._enc_vae = types.SimpleNamespace(encode=jax.jit(jvae.encode))
    tcfg = WanPipelineConfig(model_cfg_override=twan.WanConfig.tiny(**cfg_kw), **base)
    model = twan.WanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(wan_params_from_numpy(_np(jp.params), tcfg.model_config()))
    tccfg = TC.CLIPVisionConfig(**{f.name: getattr(ccfg, f.name)
                                   for f in dataclasses.fields(ccfg)})
    clip = TC.CLIPVisionModel(tccfg, "cpu")
    clip.load_state_dict(clip_vision_params_from_numpy(_np(cparams), tccfg))
    vcfg = TV.CausalVAEConfig(**{f.name: getattr(jvae.cfg, f.name)
                                 for f in dataclasses.fields(TV.CausalVAEConfig)})
    vae = TV.CausalVAE(vcfg, "cpu")
    vae.load_state_dict(causal_vae_params_from_numpy(_np(jvae.params), vcfg))
    tp = WanPipeline(tcfg, "cpu", model=model, clip=clip)
    tp.image_vae = vae
    return jp, tp


def _images(n, seed=12):
    rng = _rng(seed)
    return [(rng.random((24, 40, 3)) * 255).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("task", ["i2v", "flf2v"])
def test_image_encodes_match_jax(task):
    jp, tp = _pipes(task)
    imgs = _images(2 if task == "flf2v" else 1)
    if task == "flf2v":
        (jy, jc), (ty, tc) = jp.encode_flf(*imgs), tp.encode_flf(*imgs)
    else:
        (jy, jc), (ty, tc) = jp.encode_image(imgs[0]), tp.encode_image(imgs[0])
    lf, lh, lw, _ = tp.latent_shape
    assert tuple(ty.shape) == jy.shape == (1, lf, lh, lw, 20)
    assert tuple(tc.shape) == jc.shape == (1, tp.model_cfg.clip_tokens, 32)
    m = ty[..., :4].numpy()
    np.testing.assert_array_equal(m, np.asarray(jy[..., :4]))
    assert (m[:, 0] == 1).all() and (m[:, 1:-1] == 0).all()
    if task == "flf2v":
        assert (m[:, -1, ..., 3] == 1).all() and (m[:, -1, ..., :3] == 0).all()
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=VAE_TOL, rtol=VAE_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)


def _generate_both(jp, tp, monkeypatch, images, **kw):
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1,) + jp.latent_shape,
                                      jnp.float32))
    tp._initial_noise = lambda gen: torch.from_numpy(x0.copy())
    jkw = dict(image=images[0], last_image=images[1] if len(images) > 1 else None, **kw)
    with monkeypatch.context() as mp:      # the JAX pipeline draws its noise inline
        mp.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(x0))
        want = jp.generate("a corgi surfs a wave", seed=0, **jkw)
    got = tp.generate("a corgi surfs a wave", seed=0, **jkw)
    assert torch.isfinite(got.latents).all()
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    return got


@pytest.mark.parametrize("task", ["i2v", "flf2v"])
def test_pipeline_with_magcache_matches_jax(task, monkeypatch):
    jp, tp = _pipes(task, use_magcache=True)
    jp.record_skips = True
    got = _generate_both(jp, tp, monkeypatch, _images(2 if task == "flf2v" else 1))
    want = compute_skip_schedule(tp._cache_cfg()).reshape(6, 2)
    np.testing.assert_array_equal(got.skips, want)
    assert got.skips.sum() > 0
    assert set(got.timings) == {"text_s", "image_s", "total_s"}
    assert 0 < got.timings["image_s"] <= got.timings["total_s"]


def test_pipeline_lane_asymmetric_override_matches_jax(monkeypatch):
    # steps 2 and 4 skip one lane each: the half-batch trunk, whose rows take
    # their slice of the joint [image; text] context
    jp, tp = _pipes("i2v", use_magcache=True)
    mask = np.zeros((6, 2), bool)
    mask[2, 0] = mask[4, 1] = mask[3] = True
    got = _generate_both(jp, tp, monkeypatch, _images(1), skip_override=mask)
    np.testing.assert_array_equal(got.skips, mask)


def test_pipeline_takes_given_encodings_and_refuses_missing_images():
    _, tp = _pipes("i2v", steps=2)
    y, clip_fea = tp.encode_image(_images(1)[0])
    out = tp.generate("a", image_latents=y, clip_features=clip_fea)
    assert out.latents.shape == (1,) + tp.latent_shape and out.timings["image_s"] >= 0
    with pytest.raises(ValueError, match="i2v needs image="):
        tp.generate("a")
    with pytest.raises(ValueError, match="CLIP branch needs clip_features"):
        tp.generate("a", image_latents=y)
    _, fp = _pipes("flf2v", steps=2)
    with pytest.raises(ValueError, match="last_image"):
        fp.generate("a", image=_images(1)[0])
    t2v = WanPipeline(WanPipelineConfig(tiny=True, size=(64, 32), frame_num=9), "cpu")
    with pytest.raises(ValueError, match="i2v and flf2v"):
        t2v.generate("a", image=_images(1)[0])


def test_pipeline_falls_back_to_a_causal_vae_and_encodes_with_a_wan_vae():
    base = dict(model="wan2.1-i2v-480p", task="i2v", tiny=True, size=(64, 32), frame_num=9,
                sample_steps=2, dtype="float32",
                model_cfg_override=twan.WanConfig.tiny(**I2V))
    pipe = WanPipeline(WanPipelineConfig(**base), "cpu")
    clip, vae = pipe._i2v_encoders()
    assert isinstance(vae, TV.CausalVAE) and clip.cfg.tokens == 17 and clip.cfg.image_size == 56
    wvae = TW.WanVAE(TW.WanVAEConfig.tiny(dim_mult=(1, 2, 2, 2), z_channels=16,
                                          temporal_down=(False, True, True)), "cpu")
    wvae.init(torch.Generator().manual_seed(0))
    pipe = WanPipeline(WanPipelineConfig(**base), "cpu", vae=wvae)
    y, _ = pipe.encode_image(_images(1)[0])
    frames = torch.zeros((1, 9, 32, 64, 3))
    frames[:, 0] = torch.from_numpy(
        np.clip(jax.image.resize(_images(1)[0][None] / 255.0, (1, 32, 64, 3), "bicubic"),
                0, 1).astype(np.float32)) * 2 - 1
    torch.testing.assert_close(y[..., 4:], wvae.encode(frames)[0], atol=VAE_TOL, rtol=VAE_TOL)
    out = pipe.generate("a", image=_images(1)[0])
    assert tuple(out.video.shape) == (1, 9, 32, 64, 3) and "decode_s" in out.timings


# --------------------------------------------------- schedules and policies
@pytest.mark.parametrize("model,steps,elided", [("wan2.1-i2v-480p", 40, 46),
                                                ("wan2.1-i2v-480p", 50, None),
                                                ("wan2.1-i2v-720p", 40, None),
                                                ("wan2.1-t2v-14B", 50, None)])
def test_skip_schedules_bit_identical_to_jax(model, steps, elided):
    got = compute_skip_schedule(make_config(model, steps))
    want = np.asarray(j_schedule(j_make_config(model, steps)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0 and got.size == 2 * steps
    if elided is not None:
        assert int(got.sum()) == elided


def test_flf2v_at_50_steps_elides_56_of_100():
    assert int(compute_skip_schedule(make_config("wan2.1-i2v-480p", 50)).sum()) == 56


@pytest.mark.parametrize("size,key", [((832, 480), "i2v-480P"), ((1280, 720), "i2v-720P")])
def test_teacache_takes_the_i2v_coefficients(size, key):
    cfg = WanPipelineConfig(model="wan2.1-i2v-480p", task="i2v", size=size, sample_steps=40,
                            enable_teacache=True)
    lanes = WanPipeline._teacache_lanes(type("P", (), {"config": cfg})())
    coeffs, ret, cutoff = wan_teacache_settings(key, 40, False)
    assert tuple(lanes.coefficients) == tuple(coeffs)
    assert (lanes.ret_steps, lanes.cutoff_steps) == (ret, cutoff)
    cfg14 = WanPipelineConfig(model="wan2.1-t2v-14B", enable_teacache=True, use_ret_steps=True)
    lanes = WanPipeline._teacache_lanes(type("P", (), {"config": cfg14})())
    assert tuple(lanes.coefficients) == tuple(wan_teacache_settings("t2v-14B", 50, True)[0])
    flf = WanPipelineConfig(model="wan2.1-i2v-480p", task="flf2v", enable_teacache=True)
    with pytest.raises(ValueError, match="no published coefficients"):
        WanPipeline._teacache_lanes(type("P", (), {"config": flf})())


# ---------------------------------------------------- configs and the CLI
def test_width_fault_of_the_reference_is_not_inherited():
    """The JAX config picks the trunk by '14B' in the model key, which the
    i2v presets lack: it builds 1.3B's width. The port builds WAN_14B."""
    for task, tokens in (("i2v", 257), ("flf2v", 514)):
        jcfg = jpipe.WanPipelineConfig(model="wan2.1-i2v-480p", task=task).model_config()
        assert (jcfg.dim, jcfg.layers, jcfg.heads) == (1536, 30, 12)     # the fault
        for model in ("wan2.1-i2v-480p", "wan2.1-i2v-720p"):
            cfg = WanPipelineConfig(model=model, task=task).model_config()
            assert (cfg.dim, cfg.layers, cfg.heads, cfg.ffn_dim) == (5120, 40, 40, 13824)
            assert (cfg.in_channels, cfg.clip_tokens, cfg.clip_dim) == (36, tokens, 1280)
            assert cfg.model_type == "i2v" and cfg.has_clip and cfg.dtype == "bfloat16"
    cfg = WanPipelineConfig(model="wan2.1-t2v-14B").model_config()
    assert (cfg.dim, cfg.in_channels, cfg.model_type) == (5120, 16, "t2v")
    n = sum(p.numel() for p in twan.WanModel(WanPipelineConfig(
        model="wan2.1-i2v-480p", task="i2v").model_config(), "meta").parameters())
    assert 16.3e9 < n < 16.5e9


def test_configs_refuse_mismatched_and_unported_tasks():
    with pytest.raises(ValueError, match="takes task"):
        WanPipelineConfig(task="i2v")                       # a t2v model
    with pytest.raises(ValueError, match="takes task"):
        WanPipelineConfig(model="wan2.1-i2v-720p", task="t2v")
    with pytest.raises(NotImplementedError, match="sp > 1"):
        WanPipelineConfig(model="wan2.1-i2v-480p", task="i2v", sp=2)
    # VACE and ti2v are ported on one rank, not under sequence parallelism
    with pytest.raises(NotImplementedError):
        WanPipelineConfig(model="wan2.1-vace-14B", task="vace", sp=2)
    with pytest.raises(NotImplementedError):
        WanPipelineConfig(model="wan2.2-ti2v-5B-i2v", task="ti2v", sp=2)


def _save_image(tmp_path, name, seed):
    path = str(tmp_path / name)
    np.save(path, _rng(seed).random((40, 52, 3)).astype(np.float32))
    return path


def test_cli_i2v_tiny(tmp_path, capsys):
    img = _save_image(tmp_path, "x.npy", 13)
    out = str(tmp_path / "i2v")
    cli.main(["--task", "i2v-14B", "--tiny", "--image", img, "--device", "cpu",
              "--sample_steps", "6", "--use_magcache", "--save_file", out])
    lat = np.load(out + "_latents.npy")
    assert lat.shape == (1, 3, 4, 8, 16) and np.isfinite(lat).all()
    text = capsys.readouterr().out
    assert "skipped" in text and "mode=magcache" in text
    with pytest.raises(SystemExit, match="i2v needs image="):
        cli.main(["--task", "i2v-14B", "--tiny", "--device", "cpu", "--sample_steps", "2",
                  "--save_file", out])
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "i2v-14B", "--tiny", "--first_frame", img, "--device", "cpu"])
    with pytest.raises(SystemExit, match="does not apply"):
        cli.main(["--task", "t2v-1.3B", "--tiny", "--image", img, "--device", "cpu"])


def test_cli_flf2v_tiny_and_the_14B_t2v_tasks(tmp_path, monkeypatch):
    first, last = _save_image(tmp_path, "a.npy", 14), _save_image(tmp_path, "b.npy", 15)
    seen = []
    generate = WanPipeline.generate

    def spy(self, *a, **kw):
        seen.append((self.config, sorted(kw)))
        return generate(self, *a, **kw)

    monkeypatch.setattr(WanPipeline, "generate", spy)
    out = str(tmp_path / "flf")
    cli.main(["--task", "flf2v-14B", "--tiny", "--first_frame", first, "--last_frame", last,
              "--device", "cpu", "--sample_steps", "3", "--save_file", out])
    assert np.isfinite(np.load(out + "_latents.npy")).all()
    cfg, kw = seen[-1]
    assert (cfg.task, cfg.model, cfg.sample_shift) == ("flf2v", "wan2.1-i2v-480p", 16.0)
    assert "last_image" in kw and "image" in kw
    for task, frames in (("t2v-14B", 3), ("t2i-14B", 1)):
        cli.main(["--task", task, "--tiny", "--device", "cpu", "--sample_steps", "2",
                  "--save_file", str(tmp_path / task)])
        assert np.load(str(tmp_path / task) + "_latents.npy").shape == (1, frames, 4, 8, 16)
        assert (seen[-1][0].model, seen[-1][0].sample_steps) == ("wan2.1-t2v-14B", 2)
    # the JAX CLI's defaults: i2v 40 steps and shift 3.0 at 480p, the preset by height
    args = cli.build_parser().parse_args(["--task", "i2v-14B", "--size", "1280*720"])
    from magcache_tpu_torch.pipelines import wan as twp
    made = []
    monkeypatch.setattr(twp, "WanPipeline", lambda c, d, plan=None, **kw: made.append(c) or c)
    cli._wan_pipeline(args, torch.device("cpu"), None)
    assert (made[0].model, made[0].sample_steps, made[0].sample_shift) == (
        "wan2.1-i2v-720p", 40, 5.0)
    cli._wan_pipeline(cli.build_parser().parse_args(["--task", "i2v-14B"]),
                      torch.device("cpu"), None)
    assert (made[1].model, made[1].sample_shift, made[1].guide_scale) == (
        "wan2.1-i2v-480p", 3.0, 5.0)
