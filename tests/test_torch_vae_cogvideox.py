"""The port's CogVideoX VAE decoder against the JAX package on the CPU: its
causal conv (``models.vae.causal_conv3d``, with and without a carried
cache, against JAX's ``causal_conv3d_cog``), the converter,
``decode`` (odd and even frame counts), ``decode_tiled`` (overlapping latent
tiles decoded in frame slices with the conv caches carried, then blended)
at the tiny config and at a 4x-time, 8x-space one, and the CogVideoX
pipeline returning pixels with ``vae=``.

Both sides get the same weights (seeded numpy values in the tree of
``init_cogvideox_vae_params``, converted by ``cogvideox_vae_params_from_numpy``)
and the same numpy latents. GroupNorm's
statistics span a slice's frames, so ``decode_tiled`` is held to JAX's
``decode_tiled`` and not to ``decode``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import vae_cogvideox as JC
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_cogvideox as TC
from magcache_tpu_torch.models.convert import cogvideox_vae_params_from_numpy
from magcache_tpu_torch.pipelines import cogvideox as tpipe
from tests.test_torch_vae_osp import numpy_params

# f32 on both sides: conv and reduction order only
F32_TOL = 1e-4
# 4x in time and 8x in space (the pipeline's strides) at test widths, 32-pixel
# tiles of 4 latents
CONFIGS = {"tiny": {},
           "4x8x": dict(block_out_channels=(8, 8, 16, 16), z_channels=16,
                        temporal_compression=4)}


@functools.lru_cache(maxsize=None)
def _tree(name):
    return numpy_params(JC.init_cogvideox_vae_params,
                        JC.CogVideoXVAEConfig.tiny(**CONFIGS[name]), seed=0)


def _vaes(name):
    tcfg = TC.CogVideoXVAEConfig.tiny(**CONFIGS[name])
    vae = TC.CogVideoXVAE(tcfg, "cpu")
    vae.load_state_dict(cogvideox_vae_params_from_numpy(_tree(name), tcfg))
    jcfg = JC.CogVideoXVAEConfig.tiny(**CONFIGS[name])
    return JC.CogVideoXVAE(jcfg, jax.tree.map(jnp.asarray, _tree(name))), vae


def _latents(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_is_the_jax_default():
    import dataclasses

    for f in dataclasses.fields(JC.CogVideoXVAEConfig):
        assert getattr(TC.CogVideoXVAEConfig(), f.name) == getattr(JC.CogVideoXVAEConfig(),
                                                                   f.name), f.name
    assert TC.CogVideoXVAEConfig().space_stride == 8


@pytest.mark.parametrize("kt", [3, 1])
def test_causal_conv_cache_matches_jax_and_streams(kt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 5, 6, 7, 4)).astype(np.float32)
    p = {"w": (rng.standard_normal((kt, 3, 3, 4, 6)) * 0.2).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    w = torch.from_numpy(p["w"].transpose(4, 3, 0, 1, 2).copy())
    b = torch.from_numpy(p["b"])
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    want, jcache = JC.causal_conv3d_cog(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    got, cache = TV.causal_conv3d(xt, w, b)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    if kt == 1:
        assert cache is None and jcache is None
        return
    np.testing.assert_array_equal(np.moveaxis(cache.numpy(), 1, -1), np.asarray(jcache))
    # two slices with the carried cache equal the whole
    a, c_a = TV.causal_conv3d(xt[:, :, :2], w, b)
    b2, _ = TV.causal_conv3d(xt[:, :, 2:], w, b, tcache=c_a)
    torch.testing.assert_close(torch.cat([a, b2], 2), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "4x8x"])
def test_converter_carries_the_decoder(name):
    tcfg = TC.CogVideoXVAEConfig.tiny(**CONFIGS[name])
    sd = TC.CogVideoXVAE(tcfg, "cpu").state_dict()
    conv = cogvideox_vae_params_from_numpy(_tree(name), tcfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape and conv[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["decoder.up0.up.weight"].numpy(),
                                  _tree(name)["decoder"]["up0"]["up"]["w"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("name,t", [("tiny", 3), ("tiny", 4), ("4x8x", 3)])
def test_decode_matches_jax(name, t):
    jvae, vae = _vaes(name)
    z = _latents((1, t, 3, 4, vae.cfg.z_channels))
    want = np.asarray(jvae.decode(jnp.asarray(z)))
    got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name,shape", [("4x8x", (1, 5, 4, 5)), ("tiny", (1, 4, 3, 3))])
def test_decode_tiled_matches_jax(name, shape):
    """Latent tiles of 4 overlapping by 3 (a row of 2; the OSP tests hold
    the shared stitching over 2 x 2), each in slices of 3 + 2 latent
    frames (or 2 + 2) with the conv caches carried,
    blended over a quarter tile and cropped, against JAX's
    ``decode_tiled``. An odd latent count T gives 1 + c (T - 1) frames; an
    even one has no odd first slice to keep frame 0 apart, and gives c T,
    in JAX as here."""
    jvae, vae = _vaes(name)
    z = _latents(shape + (vae.cfg.z_channels,), seed=2)
    want = np.asarray(jvae.decode_tiled(jnp.asarray(z)))
    got = vae.decode_tiled(torch.from_numpy(z)).numpy()
    sp, tc, t = vae.cfg.space_stride, vae.cfg.temporal_compression, shape[1]
    frames = 1 + tc * (t - 1) if t % 2 else tc * t
    assert got.shape == want.shape == (1, frames, sp * shape[2], sp * shape[3], 3)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # GroupNorm over slices and the seams: not the whole-clip decode
    assert np.abs(vae.decode(torch.from_numpy(z)).numpy() - got).max() > 1e-3


def test_nearest_resize_takes_integer_factors_only():
    z = torch.zeros(1, 2, 3, 4, 4)
    assert TC._resize_nearest(z, (6, 8, 16)).shape == (1, 2, 6, 8, 16)
    with pytest.raises(ValueError, match="integer factor"):
        TC._resize_nearest(z, (4, 8, 8))


def test_pipeline_returns_pixels():
    """A tiny CogVideoX request with a 4x-time, 8x-space VAE: ``video`` is
    ``decode_tiled`` of the latents over ``scaling_factor``, 1 + 4 (T - 1)
    frames at 8x; a VAE with other strides, or an even latent frame count
    (13 frames: 4 latent frames, which would decode to 16), is refused."""
    _, vae = _vaes("4x8x")
    base = dict(tiny=True, num_frames=9, height=32, width=32, num_inference_steps=3,
                txt_len=5, dtype="float32")
    pipe = tpipe.CogVideoXPipeline(tpipe.CogVideoXPipelineConfig(**base), "cpu", vae=vae)
    out = pipe.generate("a red boat", seed=1)
    assert out.latents.shape == (1, 3, 4, 4, 16)
    assert out.video.shape == (1, 9, 32, 32, 3) and torch.isfinite(out.video).all()
    torch.testing.assert_close(out.video, vae.decode_tiled(out.latents / vae.cfg.scaling_factor),
                               rtol=0, atol=0)
    assert out.timings["decode_s"] >= 0
    with pytest.raises(ValueError, match="strides"):
        tpipe.CogVideoXPipeline(tpipe.CogVideoXPipelineConfig(**base), "cpu",
                                vae=TC.CogVideoXVAE(TC.CogVideoXVAEConfig.tiny(), "cpu"))
    with pytest.raises(ValueError, match="4 latent frames"):
        tpipe.CogVideoXPipeline(tpipe.CogVideoXPipelineConfig(**dict(base, num_frames=13)),
                                "cpu", vae=vae)
