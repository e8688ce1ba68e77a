"""The port's Open-Sora temporal VAE (``models/vae_temporal.py``) and the
micro-frame composite (``models.vae.MicroFrameVAE``) against the JAX package
on the CPU: the config, the converter, the causal conv's zero front pad,
``VAETemporal.encode`` and ``decode`` (the depth-to-time order, ``num_frames``),
the front-pad shapes, ``MicroFrameVAE`` encode and decode at micro-frame
sizes 3 and 5, the Open-Sora pipeline returning pixels (plain and looped),
and an image reference read from a PNG and encoded.

Both sides get the same weights (seeded numpy values in the trees of
``init_vae_temporal_params`` and ``init_sd_vae_params``) and the same numpy
inputs. Departure from the JAX package, stated: the reference composite has
two latent scales and the JAX ``MicroFrameVAE`` applies neither. The port
applies the per-channel ``z * scale + shift`` at the composite's edge and
the spatial VAE's ``from_latent`` / ``to_latent`` between the stages. Module
parity runs with identity values (which make the port's composite JAX's);
elsewhere the JAX side gets both scales by hand.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import vae as JV
from magcache_tpu.models import vae_sd as JS
from magcache_tpu.models import vae_temporal as JT
from magcache_tpu.pipelines import open_sora as jpipe
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_sd as TS
from magcache_tpu_torch.models import vae_temporal as TT
from magcache_tpu_torch.models.convert import (sd_vae_params_from_numpy,
                                               vae_temporal_params_from_numpy)
from magcache_tpu_torch.pipelines import open_sora as tpipe
from tests.test_torch_vae_osp import numpy_params

# the JAX temporal-VAE tests' tolerance (tests/test_vae_temporal.py)
TOL = 3e-4
# the JAX parity test's config (2 levels of 3, one time stride) and a 4x one
CONFIGS = {"jax-test": dict(filters=8, num_res_blocks=2, channel_multipliers=(1, 2, 2),
                            temporal_downsample=(False, True), groups=4),
           "4x": dict(filters=8, num_res_blocks=1, channel_multipliers=(1, 2, 2),
                      temporal_downsample=(True, True), groups=4)}
IDENTITY = dict(scale=(1.0,) * 4, shift=(0.0,) * 4)
# the Open-Sora pipeline's geometry at test widths: 8x in space, 4x in time
STRIDE8 = TS.SDVAEConfig(base=8, ch_mult=(1, 1, 2, 2), blocks_per_level=1, groups=4)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _temporal(cfg: TT.VAETemporalConfig, seed: int = 0):
    """``(jax VAETemporal with jitted encode/decode, port VAETemporal)``."""
    jcfg = JT.VAETemporalConfig(**_fields(cfg))
    tree = numpy_params(JT.init_vae_temporal_params, jcfg, seed=seed)
    vae = TT.VAETemporal(cfg, "cpu")
    vae.load_state_dict(vae_temporal_params_from_numpy(tree, cfg))
    jvae = JT.VAETemporal(jcfg, jax.tree.map(jnp.asarray, tree))
    jvae.encode = jax.jit(jvae.encode)
    jvae.decode = jax.jit(jvae.decode, static_argnames="num_frames")
    return jvae, vae


@functools.lru_cache(maxsize=None)
def _spatial(cfg: TS.SDVAEConfig, seed: int = 1):
    jcfg = JS.SDVAEConfig(**_fields(cfg))
    tree = numpy_params(JS.init_sd_vae_params, jcfg, seed=seed)
    vae = TS.SDVAE(cfg, "cpu")
    vae.load_state_dict(sd_vae_params_from_numpy(tree, cfg))
    jvae = JS.SDVAE(jcfg, jax.tree.map(jnp.asarray, tree))
    jvae.encode, jvae.decode = jax.jit(jvae.encode), jax.jit(jvae.decode)
    return jvae, vae


class _ScaledSpatial:
    """The JAX spatial VAE with the spatial factor between the stages, by
    hand: ``to_latent`` after its encode, ``from_latent`` before its
    decode."""

    def __init__(self, jvae):
        self.jvae, self.cfg = jvae, jvae.cfg

    def encode(self, x):
        mean, logvar = self.jvae.encode(x)
        return self.jvae.to_latent(mean), logvar

    def decode(self, z):
        return self.jvae.decode(self.jvae.from_latent(z))


class _ScaledComposite:
    """The JAX composite with both reference scales by hand: ``encode`` ends
    with ``(z - shift) / scale``, ``decode`` starts with ``z * scale +
    shift``."""

    def __init__(self, jspatial, jtemporal, micro_frame_size, scale, shift):
        self.mf = JV.MicroFrameVAE(_ScaledSpatial(jspatial), jtemporal,
                                   micro_frame_size=micro_frame_size)
        self.scale, self.shift = np.asarray(scale, np.float32), np.asarray(shift, np.float32)

    def encode(self, x):
        return (np.asarray(self.mf.encode(jnp.asarray(x))) - self.shift) / self.scale

    def decode(self, z):
        return np.asarray(self.mf.decode(jnp.asarray(np.asarray(z) * self.scale + self.shift)))


def test_config_and_defaults():
    """The port's fields and tiny() are JAX's (published widths by default,
    time factor 4); ``open_sora_vae`` is the published composite."""
    assert _fields(TT.VAETemporalConfig()) == _fields(JT.VAETemporalConfig())
    assert _fields(TT.VAETemporalConfig.tiny()) == _fields(JT.VAETemporalConfig.tiny())
    assert TT.VAETemporalConfig().time_factor == 4 and TT.VAETemporalConfig.tiny().time_factor == 2
    vae = TT.open_sora_vae("meta")
    assert vae.spatial.cfg == TS.OPEN_SORA_SPATIAL_VAE
    assert vae.temporal.cfg == TT.VAETemporalConfig() and vae.micro_frame_size == 17
    assert (vae.scale, vae.shift) == (TV.OPEN_SORA_VAE_SCALE, TV.OPEN_SORA_VAE_SHIFT)
    assert TV.OPEN_SORA_VAE_SCALE == (3.85, 2.32, 2.33, 3.06)
    assert TV.OPEN_SORA_VAE_SHIFT == (-0.10, 0.34, 0.27, 0.98)
    assert TT.VAETemporal.front_padded_latents and JT.VAETemporal.front_padded_latents


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_converter_carries_every_weight(name):
    """Every JAX leaf lands on a port parameter of the same count, under the
    reference's names (``.conv`` inside each causal conv, ``nn.Identity``
    holding the index of a level without a time stride)."""
    cfg = TT.VAETemporalConfig(**CONFIGS[name])
    tree = numpy_params(JT.init_vae_temporal_params, JT.VAETemporalConfig(**CONFIGS[name]), 2)
    sd = TT.VAETemporal(cfg, "cpu").state_dict()
    conv = vae_temporal_params_from_numpy(tree, cfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape, k
    assert sum(v.numel() for v in conv.values()) == sum(
        np.size(leaf) for leaf in jax.tree.leaves(tree))
    assert "encoder.block_res_blocks.0.0.conv1.conv.bias" not in sd
    np.testing.assert_array_equal(conv["decoder.conv_blocks.1.conv.weight"].numpy(),
                                  tree["decoder"]["blocks"][2]["up"]["w"].transpose(4, 3, 0, 1, 2))


def test_causal_conv_zero_pads_the_front():
    """Stride 1 pads ``kt - 1`` zero frames, the stride-2 down conv one:
    JAX's ``_cconv`` on both."""
    rng = np.random.default_rng(3)
    x = _x((1, 5, 4, 3, 2))
    for stride in (1, 2):
        w = rng.standard_normal((3, 3, 3, 2, 3)).astype(np.float32)
        b = rng.standard_normal(3).astype(np.float32)
        want = np.asarray(JT._cconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=(stride, 1, 1)))
        conv = TT.CausalConv3d(2, 3, stride=(stride, 1, 1), device="cpu")
        with torch.no_grad():
            conv.conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2)))
            conv.conv.bias.copy_(torch.from_numpy(b))
            got = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        assert got.shape == want.shape == (1, 5 if stride == 1 else 2, 4, 3, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_and_decode_match_jax(name):
    """``encode`` (front pad to the time factor, the stride-2 down convs)
    and ``decode`` of several latent frames and channels (the depth-to-time
    order) with and without ``num_frames``."""
    cfg = TT.VAETemporalConfig(**CONFIGS[name])
    jvae, vae = _temporal(cfg)
    x = _x((1, 5, 5, 6, 4), 4)
    jm, jl = jvae.encode(jnp.asarray(x))
    tm, tl = vae.encode(torch.from_numpy(x))
    assert tm.shape == jm.shape == (1, -(-5 // cfg.time_factor), 5, 6, 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    z = _x((1, 3, 5, 6, 4), 5)
    for nf in (None, 5, 3 * cfg.time_factor - 1):
        want = np.asarray(jvae.decode(jnp.asarray(z), num_frames=nf))
        got = vae.decode(torch.from_numpy(z), num_frames=nf).numpy()
        assert got.shape == want.shape == (1, nf or 3 * cfg.time_factor, 5, 6, 4)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_depth_to_time_order():
    """Frame ``2t + s`` is channel ``2c + s``: the NCDHW reshape gives JAX's
    channel-last split, and the other order would not."""
    h = _x((1, 3, 2, 2, 6), 6)                     # [B, T, H, W, 2C] channel-last
    b, t, hh, ww, c2 = h.shape
    want = h.reshape(b, t, hh, ww, c2 // 2, 2).transpose(0, 1, 5, 2, 3, 4).reshape(
        b, 2 * t, hh, ww, c2 // 2)
    got = TT._depth_to_time(torch.from_numpy(h).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    major = h.reshape(b, t, hh, ww, 2, c2 // 2).transpose(0, 1, 4, 2, 3, 5).reshape(want.shape)
    assert not np.array_equal(major, want)


def test_front_pad_shapes():
    """5 frames at factor 2 make 3 latents; the encode equals that of the
    clip front-padded with a zero frame; decode slices back to 5."""
    cfg = TT.VAETemporalConfig.tiny()
    _, vae = _temporal(cfg)
    x = _x((1, 5, 4, 4, cfg.in_out_channels), 7)
    mean, logvar = vae.encode(torch.from_numpy(x))
    assert mean.shape == logvar.shape == (1, 3, 4, 4, cfg.embed_dim)
    padded, _ = vae.encode(torch.from_numpy(np.concatenate([np.zeros_like(x[:, :1]), x], 1)))
    torch.testing.assert_close(mean, padded, rtol=0, atol=0)
    y = vae.decode(mean, num_frames=5)
    assert y.shape == (1, 5, 4, 4, cfg.in_out_channels) and torch.isfinite(y).all()


def _composites(mf, spatial_cfg, temporal_cfg, scales, **kw):
    """``(jax composite with the scales by hand, port MicroFrameVAE)``."""
    js, ts = _spatial(spatial_cfg)
    jt, tt = _temporal(temporal_cfg)
    return (_ScaledComposite(js, jt, mf, **scales),
            TV.MicroFrameVAE(ts, tt, micro_frame_size=mf, **scales, **kw))


@pytest.mark.parametrize("mf,frames", [(3, 8), (5, 10)])
def test_micro_frame_vae_matches_jax(mf, frames):
    """With identity scales the composite is JAX's ``MicroFrameVAE``: the
    frames encode in chunks of ``mf`` (``ceil(mf / 2)`` latents each, the
    last chunk shorter) and decode back to as many; a spatial
    ``micro_batch`` of 1 gives the same pixels."""
    scfg = TS.SDVAEConfig.tiny(scaling_factor=1.0)
    tcfg = TT.VAETemporalConfig.tiny(in_out_channels=4)
    jvae, vae = _composites(mf, scfg, tcfg, IDENTITY)
    plain = JV.MicroFrameVAE(jvae.mf.spatial.jvae, jvae.mf.temporal, micro_frame_size=mf)
    x = _x((1, frames, 8, 8, 3), 8)
    want = np.asarray(plain.encode(jnp.asarray(x)))
    got = vae.encode(torch.from_numpy(x))
    n_lat = frames // mf * -(-mf // 2) + -(-(frames % mf) // 2)
    assert got.shape == want.shape == (1, n_lat, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want = np.asarray(plain.decode(jnp.asarray(want)))
    px = vae.decode(got)
    assert px.shape == want.shape == (1, frames, 8, 8, 3)
    np.testing.assert_allclose(px.numpy(), want, rtol=TOL, atol=TOL)
    # another batch of images a conv call: summation order only
    vae.spatial.micro_batch = 1
    torch.testing.assert_close(vae.decode(got), px, rtol=1e-5, atol=1e-5)
    vae.spatial.micro_batch = 8


def test_micro_frame_vae_published_scales_are_the_maps():
    """The published scales change the composite by exactly their maps: the
    port with them equals JAX's composite with ``z * scale + shift`` before
    its decode, the spatial factor between the stages, and the inverse
    after its encode."""
    scfg = TS.SDVAEConfig.tiny(scaling_factor=0.18215)
    tcfg = TT.VAETemporalConfig.tiny(in_out_channels=4)
    published = dict(scale=TV.OPEN_SORA_VAE_SCALE, shift=TV.OPEN_SORA_VAE_SHIFT)
    jvae, vae = _composites(5, scfg, tcfg, published)
    x = _x((1, 7, 8, 8, 3), 9)
    want = jvae.encode(x)
    got = vae.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    z = _x(want.shape, 10)
    np.testing.assert_allclose(vae.decode(torch.from_numpy(z)).numpy(), jvae.decode(z),
                               rtol=TOL, atol=TOL)
    # and the scales matter: the identity composite on the same weights differs
    ident = TV.MicroFrameVAE(vae.spatial, vae.temporal, micro_frame_size=5, **IDENTITY)
    assert (ident.decode(torch.from_numpy(z)) - vae.decode(torch.from_numpy(z))).abs().max() > 1e-2


# ---------------------------------------------------------------- pipeline
def _os_vaes():
    """The pipeline's geometry (17-frame chunks, 4x in time, 8x in space)
    at test widths, with the published scales."""
    scfg = dataclasses.replace(STRIDE8, scaling_factor=0.18215)
    tcfg = TT.VAETemporalConfig(**CONFIGS["4x"])
    return _composites(17, scfg, tcfg, dict(scale=TV.OPEN_SORA_VAE_SCALE,
                                            shift=TV.OPEN_SORA_VAE_SHIFT))


def _os_pipe(vae, **kw):
    cfg = tpipe.OpenSoraPipelineConfig(tiny=True, num_frames=8, height=32, width=32,
                                       num_sampling_steps=3, caption_len=6, **kw)
    return tpipe.OpenSoraPipeline(cfg, "cpu", vae=vae)


@pytest.mark.parametrize("loop", [1, 2])
def test_open_sora_pipeline_returns_pixels(loop):
    """8 frames are 2 latents; the video (looped clips trimmed of their
    hand-off latent and joined first) is JAX's composite decode with the
    scales by hand; ``decode_s`` is recorded; a VAE of another geometry is
    refused."""
    jvae, vae = _os_vaes()
    out = _os_pipe(vae).generate("a boat", seed=3, loop=loop, condition_frame_length=1,
                                 align=1)
    assert out.latents.shape == (1, 1 + loop, 4, 4, 4)
    frames = min(17, 4 * (1 + loop))
    assert out.video.shape == (1, frames, 32, 32, 3) and torch.isfinite(out.video).all()
    np.testing.assert_allclose(out.video.numpy(), jvae.decode(out.latents.numpy()),
                               rtol=TOL, atol=TOL)
    assert out.timings["total_s"] >= out.timings["decode_s"] >= 0
    bad = TV.MicroFrameVAE(vae.spatial, TT.VAETemporal(TT.VAETemporalConfig.tiny(), "meta"))
    with pytest.raises(ValueError, match="latents'"):
        _os_pipe(bad)


def test_open_sora_image_reference_matches_jax(tmp_path):
    """A PNG reference is read with the resize-crop transform and encoded
    by the composite as JAX's ``_collect_references`` does (the scales by
    hand); a request conditioned on it returns pixels; without a VAE it
    raises before the file is read."""
    from PIL import Image

    jvae, vae = _os_vaes()
    path = str(tmp_path / "ref.png")
    Image.fromarray(np.random.default_rng(11).integers(0, 256, (40, 56, 3), np.uint8)).save(path)
    pipe = _os_pipe(vae)
    got = pipe._collect_references([path, ""])
    ns = types.SimpleNamespace(config=pipe.config, vae=jvae)
    want = jpipe.OpenSoraPipeline._collect_references(ns, [path, ""])
    assert got[1] == want[1] == [] and got[0][0].shape == np.asarray(want[0][0]).shape == (
        1, 4, 4, 4)
    np.testing.assert_allclose(got[0][0], np.asarray(want[0][0]), rtol=TOL, atol=TOL)
    out = pipe.generate("a boat", seed=4, ms="0,0,0,0,1,0", refs=path, align=1)
    assert out.video.shape == (1, 8, 32, 32, 3) and torch.isfinite(out.video).all()
    with pytest.raises(ValueError, match="VAE"):
        _os_pipe(None)._collect_references([str(tmp_path / "missing.png")])
