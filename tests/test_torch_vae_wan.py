"""The port's Wan2.1 VAE decode against the JAX package on the CPU:
``channel_rms_norm`` and ``causal_conv3d`` (with and without a carried time
cache, and strided), ``WanVAE.decode`` (same weights through
``wan_vae_params_from_numpy``) whole and streamed, f32 and bf16, and a tiny
``WanPipeline`` with a UMT5 text encoder and a VAE against the JAX
pipeline's video.

The port's VAE runs NCDHW inside; the JAX one NDHWC. Tensors cross between
the two here with ``_ncdhw``/``_ndhwc``, weights with the converter's
layout rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import text as JT
from magcache_tpu.models import umt5 as JU
from magcache_tpu.models import vae as JV
from magcache_tpu.models import vae_wan as JW
from magcache_tpu.pipelines import wan as jpipe
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models import umt5 as TU
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_wan as TW
from magcache_tpu_torch.models.convert import (umt5_params_from_numpy,
                                               wan_params_from_numpy,
                                               wan_vae_params_from_numpy)
from magcache_tpu_torch.models.wan import WanModel
from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

# f32 on both sides: conv and reduction order only (measured ~3e-6 at
# |pixel| < 3)
F32_TOL = 1e-4
# streamed against whole in f32: the same convs over the same frames
STREAM_TOL = 1e-5
# bf16 against f32, relative to the largest pixel (the JAX test's bound)
BF16_REL_MAX = 5e-2


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _ndhwc(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.float().numpy(), 1, -1)


def _vaes(cfg_kw=None, seed=0, dtype="float32"):
    cfg_kw = cfg_kw or {}
    jcfg = JW.WanVAEConfig.tiny(**cfg_kw, dtype=dtype)
    tcfg = TW.WanVAEConfig.tiny(**cfg_kw, dtype=dtype)
    params = JW.init_wan_vae_params(jax.random.PRNGKey(seed), JW.WanVAEConfig.tiny(**cfg_kw))
    vae = TW.WanVAE(tcfg, "cpu")
    vae.load_state_dict(wan_vae_params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    return JW.WanVAE(jcfg, params), vae


def _latents(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_rms_norm_matches_jax(dtype):
    x = _latents((2, 3, 5, 7, 12)) * 3
    w = 1 + 0.1 * _latents((12,), 1)
    b = 0.1 * _latents((12,), 2)
    jx = jnp.asarray(x, dtype)
    for bias in (None, b):
        want = np.asarray(JV.channel_rms_norm(
            jx, jnp.asarray(w), None if bias is None else jnp.asarray(bias)), np.float32)
        got = TV.channel_rms_norm(_ncdhw(x).to(getattr(torch, dtype)), torch.from_numpy(w),
                                  None if bias is None else torch.from_numpy(bias))
        assert got.dtype == getattr(torch, dtype)
        tol = F32_TOL if dtype == "float32" else 1e-2   # one bf16 ulp at |y| < 4
        np.testing.assert_allclose(_ndhwc(got), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("kernel,stride,cached", [
    ((3, 3, 3), 1, False), ((3, 3, 3), 1, True), ((3, 1, 1), 2, False),
    ((3, 1, 1), 2, True), ((1, 1, 1), 1, False), ((3, 3, 3), 2, True)])
def test_causal_conv3d_matches_jax(kernel, stride, cached):
    kt, kh, kw = kernel
    x = _latents((1, 5, 6, 7, 4))
    w = _latents((kt, kh, kw, 4, 6), 1) * 0.2
    b = _latents((6,), 2)
    cache = _latents((1, kt - 1, 6, 7, 4), 3) if cached and kt > 1 else None
    st = (stride, 1, 1)
    jy, jc = JV.causal_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=st,
                              tcache=None if cache is None else jnp.asarray(cache))
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    ty, tc = TV.causal_conv3d(_ncdhw(x), tw, torch.from_numpy(b), stride=st,
                              tcache=None if cache is None else _ncdhw(cache))
    np.testing.assert_allclose(_ndhwc(ty), np.asarray(jy), atol=F32_TOL, rtol=F32_TOL)
    if kt == 1:
        assert jc is None and tc is None
    else:           # the carried tail keeps the strided window phase
        np.testing.assert_array_equal(_ndhwc(tc), np.asarray(jc))


@pytest.mark.parametrize("chunk", [None, 1, 2])
def test_decode_matches_jax(chunk):
    jvae, tvae = _vaes()
    z = _latents((1, 5, 6, 8, 4))
    want = np.asarray(jvae.decode(jnp.asarray(z), latent_chunk=chunk))
    got = tvae.decode(torch.from_numpy(z), latent_chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 9, 12, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_decode_full_geometry_matches_jax():
    # Wan2.1's mults and transitions at a narrow width: stride (4, 8, 8)
    cfg_kw = dict(base=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                  temporal_down=(False, True, True), z_channels=16)
    jvae, tvae = _vaes(cfg_kw, seed=1)
    z = _latents((1, 3, 4, 4, 16), 1)
    want = np.asarray(jvae.decode(jnp.asarray(z)))
    got = tvae.decode(torch.from_numpy(z))
    assert tuple(got.shape) == (1, 9, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_streamed_decode_equals_whole(chunk):
    _, tvae = _vaes()
    z = torch.from_numpy(_latents((1, 5, 6, 8, 4), 4))
    whole = tvae.decode(z, latent_chunk=None)
    torch.testing.assert_close(tvae.decode(z, latent_chunk=chunk), whole,
                               atol=STREAM_TOL, rtol=STREAM_TOL)


def test_bf16_decode_tracks_f32():
    _, v32 = _vaes(seed=5)
    _, v16 = _vaes(seed=5, dtype="bfloat16")
    assert v16.decoder.conv1.weight.dtype == torch.bfloat16
    assert v16.decoder.head_norm.dtype == torch.float32
    z = torch.from_numpy(_latents((1, 5, 8, 8, 4), 5))
    y32, y16 = v32.decode(z), v16.decode(z)
    assert y16.dtype == torch.float32 and y16.shape == y32.shape
    assert float((y16 - y32).abs().max() / y32.abs().max()) < BF16_REL_MAX
    # streamed against whole in bf16: the convs see other frame counts, so
    # the f32 accumulators reassociate (the JAX test's bound)
    assert float((y16 - v16.decode(z, latent_chunk=None)).abs().max()) < 0.03


def test_latent_denormalization_matches_jax():
    cfg_kw = dict(latent_mean=tuple(0.1 * i for i in range(4)),
                  latent_std=tuple(1.0 + 0.05 * i for i in range(4)), latent_scale=1.5)
    jvae, tvae = _vaes(cfg_kw, seed=2)
    z = _latents((1, 3, 4, 4, 4), 2)
    np.testing.assert_allclose(tvae.decode(torch.from_numpy(z)).numpy(),
                               np.asarray(jvae.decode(jnp.asarray(z))),
                               atol=F32_TOL, rtol=F32_TOL)


def test_unpatchify_pixels_and_converter_layout():
    x = _latents((1, 2, 3, 4, 12))
    np.testing.assert_array_equal(TW._unpatchify_pixels(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(JW._unpatchify_pixels(jnp.asarray(x), 2)))
    cfg = TW.WanVAEConfig.tiny(dtype="bfloat16")
    params = JW.init_wan_vae_params(jax.random.PRNGKey(0), JW.WanVAEConfig.tiny())
    sd = wan_vae_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    want = TW.WanVAE(cfg, "cpu").state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    np.testing.assert_array_equal(
        sd["decoder.levels.0.time_conv.weight"].float().numpy(),
        np.asarray(params["decoder"]["levels"][0]["time_conv"]["w"]).transpose(
            4, 3, 0, 1, 2).astype(np.float32).astype(jnp.bfloat16).astype(np.float32))
    m = TW.WanVAE(TW.WAN21_VAE, "meta")
    assert sum(p.numel() for p in m.parameters()) > 70e6    # the decoder's ~73 M


def test_tiny_pipeline_with_umt5_and_vae_matches_jax_video(monkeypatch, capsys):
    """Text through UMT5 (hash tokenizer) -> cached UniPC -> VAE decode, the
    JAX pipeline and the port on the same weights and noise."""
    base = dict(tiny=True, size=(64, 32), frame_num=9, sample_steps=6, sample_shift=5.0,
                guide_scale=5.0, dtype="float32", use_magcache=True)
    ucfg = dict(d_model=24, heads=4, d_kv=8)
    tok = dict(vocab_size=128, eos_token_id=1, pad_token_id=0)
    jenc = JU.UMT5Encoder(JU.UMT5Config.tiny(**ucfg), seq_len=16,
                          tokenizer=JT.FallbackHashTokenizer(**tok))
    vcfg = dict(base=8, dim_mult=(1, 2, 4, 4), num_res_blocks=1,
                temporal_down=(False, True, True), z_channels=16)
    jvp = JW.init_wan_vae_params(jax.random.PRNGKey(3), JW.WanVAEConfig(**vcfg))
    jp = jpipe.WanPipeline(jpipe.WanPipelineConfig(**base), text_encoder=jenc,
                           vae=JW.WanVAE(JW.WanVAEConfig(**vcfg), jvp))

    tucfg = TU.UMT5Config.tiny(**ucfg)
    umodel = TU.UMT5Model(tucfg, "cpu")
    umodel.load_state_dict(umt5_params_from_numpy(jax.tree.map(np.asarray, jenc.params),
                                                  tucfg))
    tvae = TW.WanVAE(TW.WanVAEConfig(**vcfg), "cpu")
    tvae.load_state_dict(wan_vae_params_from_numpy(jax.tree.map(np.asarray, jvp),
                                                   tvae.cfg))
    tcfg = WanPipelineConfig(**base)
    model = WanModel(tcfg.model_config(), "cpu")
    model.load_state_dict(wan_params_from_numpy(jax.tree.map(np.asarray, jp.params),
                                                tcfg.model_config()))
    tp = WanPipeline(tcfg, "cpu", model=model, vae=tvae,
                     text_encoder=TU.UMT5Encoder(tucfg, seq_len=16, model=umodel,
                                                 tokenizer=TT.FallbackHashTokenizer(**tok)))
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1,) + jp.latent_shape,
                                      jnp.float32))
    tp._initial_noise = lambda gen: torch.from_numpy(x0.copy())
    # the JAX pipeline draws its noise inline: hand it the same
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(x0))
    want = jp.generate("a red boat at dawn", seed=0)
    got = tp.generate("a red boat at dawn", seed=0)
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=1e-4, rtol=1e-4)
    assert tuple(got.video.shape) == (1, 9, 32, 64, 3) == want.video.shape
    np.testing.assert_allclose(got.video.numpy(), want.video, atol=1e-4, rtol=1e-4)
    assert got.timings["decode_s"] <= got.timings["total_s"]
    # without a VAE the output stays latents only
    assert WanPipeline(WanPipelineConfig(**base), "cpu").generate("a").video is None
