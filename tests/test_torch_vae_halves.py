"""The VAE halves the port added to its VAEs, against the JAX package on the
CPU: the causal 3-D VAE's decoder (``decode`` and the streamed
``decode_chunked``), the compact ``ImageVAE`` (encode, decode and the
blended ``decode_tiled``), ``MicroFrameVAE`` over the two, the
Open-Sora-Plan CausalVAE's encoder (whole, and tiled in time windows and
2-D tiles at small tile thresholds) and the CogVideoX VAE's encoder; the
converters' full trees and the OSP and CogVideoX checkpoint loaders'
encoder weights bit-equal to the JAX converters' trees.

Both sides get the same weights (seeded numpy values in the trees of the
JAX inits) and the same numpy inputs, f32 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import vae as JV
from magcache_tpu.models import vae_cogvideox as JCV
from magcache_tpu.models import vae_osp as JOV
from magcache_tpu_torch.models import convert as TC
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_cogvideox as TCV
from magcache_tpu_torch.models import vae_osp as TOV
from tests.test_torch_checkpoint_vaes import (_cogvideox_published, _osp_published,
                                              _random_tree, _save)
from tests.test_torch_vae_cogvideox import CONFIGS as COG_CONFIGS
from tests.test_torch_vae_osp import LAYOUTS, WIDTHS, numpy_params

# f32 on both sides: conv, interpolation and reduction order only
F32_TOL = 1e-4
# the causal VAE's tiny config, and one with the Wan strides (4x time, 8x space)
CAUSAL = {"tiny": {}, "wan strides": dict(ch_mult=(1, 1, 2, 2), z_channels=16,
                                           temporal_downsample=(False, True, True, False))}


def _np(a):
    return np.asarray(a, np.float32)


def _pixels(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# --------------------------------------------------------- the causal VAE
@functools.lru_cache(maxsize=None)
def _causal_tree(name):
    cfg = JV.CausalVAEConfig.tiny(**CAUSAL[name])
    tree = numpy_params(JV.init_causal_vae_params, cfg, seed=3)
    # the static time strides the init writes beside the convs
    n = len(cfg.ch_mult)
    for i in range(n - 1):
        tree["encoder"][f"level{i}"]["down"]["tstride"] = 2 if cfg.temporal_downsample[i] else 1
        tree["decoder"][f"level{i}"]["up"]["tstride"] = (
            2 if cfg.temporal_downsample[n - 2 - i] else 1)
    return tree


def _causal_vaes(name):
    tree = _causal_tree(name)
    tcfg = TV.CausalVAEConfig.tiny(**CAUSAL[name])
    vae = TV.CausalVAE(tcfg, "cpu")
    vae.load_state_dict(TC.causal_vae_params_from_numpy(tree, tcfg))
    return JV.CausalVAE(JV.CausalVAEConfig.tiny(**CAUSAL[name]), tree), vae


@pytest.mark.parametrize("name", sorted(CAUSAL))
def test_causal_vae_decode_and_chunked_decode_match_jax(name):
    """``decode`` and ``decode_chunked`` (chunks of 2 latents, the caches
    carried) against JAX's, and the port's chunked decodes at 1, 2 and 3
    latents a chunk and JAX's against the whole one: the first chunk drops
    the frames its temporal upsamples fabricate for frame 0, and the norms
    are position-local."""
    jvae, vae = _causal_vaes(name)
    z = np.random.default_rng(1).standard_normal(
        (1, 5, 6, 4, vae.cfg.z_channels)).astype(np.float32)
    want = _np(jax.jit(jvae.decode)(jnp.asarray(z)))
    got = vae.decode(torch.from_numpy(z)).numpy()
    tf = vae.cfg.time_factor
    assert got.shape == want.shape == (1, 1 + tf * 4, 6 * 2 ** (len(vae.cfg.ch_mult) - 1),
                                       4 * 2 ** (len(vae.cfg.ch_mult) - 1), 3)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # JAX's own chunked decode at one chunk size (one compile: 2 + 2 + 1
    # latents), the port's at three
    jchunked = _np(jax.jit(lambda z_: jvae.decode_chunked(z_, 2))(jnp.asarray(z)))
    np.testing.assert_allclose(jchunked, want, atol=F32_TOL, rtol=F32_TOL)
    for chunk in (1, 2, 3):
        chunked = vae.decode_chunked(torch.from_numpy(z), chunk=chunk).numpy()
        np.testing.assert_allclose(chunked, got, atol=F32_TOL, rtol=F32_TOL)
        if chunk == 2:
            np.testing.assert_allclose(chunked, jchunked, atol=F32_TOL, rtol=F32_TOL)


def test_causal_vae_converter_carries_both_halves_and_keeps_the_encoder_draws():
    """Every parameter of the port comes from the JAX tree, and the encoder's
    random draws do not depend on the decoder registered after it."""
    tree = _causal_tree("wan strides")
    tcfg = TV.CausalVAEConfig.tiny(**CAUSAL["wan strides"])
    sd = TV.CausalVAE(tcfg, "cpu").state_dict()
    conv = TC.causal_vae_params_from_numpy(tree, tcfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape, k
    np.testing.assert_array_equal(conv["decoder.levels.1.up.weight"].numpy(),
                                  tree["decoder"]["level1"]["up"]["conv"]["w"]
                                  .transpose(4, 3, 0, 1, 2))
    seeded = TV.CausalVAE(tcfg, "cpu").init(torch.Generator().manual_seed(4))
    enc = TV.CausalVAEEncoder(tcfg, "cpu")
    TV.init_convs_(enc, torch.Generator().manual_seed(4))
    for k, v in enc.state_dict().items():
        torch.testing.assert_close(seeded.encoder.state_dict()[k], v, rtol=0, atol=0)


# ------------------------------------------------------------ the image VAE
@functools.lru_cache(maxsize=None)
def _image_tree():
    return numpy_params(JV.init_image_vae_params, JV.ImageVAEConfig.tiny(), seed=5)


def _image_vaes():
    tcfg = TV.ImageVAEConfig.tiny()
    vae = TV.ImageVAE(tcfg, "cpu")
    vae.load_state_dict(TC.image_vae_params_from_numpy(_image_tree(), tcfg))
    jvae = JV.ImageVAE(JV.ImageVAEConfig.tiny(), _image_tree())
    jvae.encode, jvae.decode = jax.jit(jvae.encode), jax.jit(jvae.decode)
    return jvae, vae


def test_image_vae_matches_jax():
    """Encode, decode and ``decode_tiled`` (2 x 2 tiles of 16 latents
    overlapping by 4 on 28 x 28 latents, the JAX test's blend; one tile
    shape, one JAX compile) against JAX's; the converter carries every
    parameter."""
    jvae, vae = _image_vaes()
    assert TV.ImageVAE(vae.cfg, "cpu").state_dict().keys() == TC.image_vae_params_from_numpy(
        _image_tree(), vae.cfg).keys()
    x = _pixels((2, 32, 24, 3))
    jm, jl = jvae.encode(jnp.asarray(x))
    tm, tl = vae.encode(torch.from_numpy(x))
    assert tuple(tm.shape) == jm.shape == (2, 16, 12, 4)
    for got, want in ((tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL, rtol=F32_TOL)
    z = np.random.default_rng(3).standard_normal((1, 28, 28, 4)).astype(np.float32)
    want = _np(jvae.decode_tiled(jnp.asarray(z), tile=16, overlap=4))
    got = vae.decode_tiled(torch.from_numpy(z), tile=16, overlap=4).numpy()
    assert got.shape == want.shape == (1, 56, 56, 3)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(vae.decode(torch.from_numpy(z[:, :16, :16])).numpy(),
                               _np(jvae.decode(jnp.asarray(z[:, :16, :16]))),
                               atol=F32_TOL, rtol=F32_TOL)


def test_micro_frame_vae_over_the_image_and_causal_vaes_matches_jax():
    """``MicroFrameVAE(ImageVAE, CausalVAE)`` (the JAX tests' composite) with
    the identity latent scales: chunks of 5 frames encode to 3 latents each
    and decode back, each chunk alone."""
    jimg, img = _image_vaes()
    tcfg = TV.CausalVAEConfig.tiny(in_channels=4)
    jcfg = JV.CausalVAEConfig.tiny(in_channels=4)
    tree = numpy_params(JV.init_causal_vae_params, jcfg, seed=7)
    tree["encoder"]["level0"]["down"]["tstride"] = 2
    tree["decoder"]["level0"]["up"]["tstride"] = 2
    temporal = TV.CausalVAE(tcfg, "cpu")
    temporal.load_state_dict(TC.causal_vae_params_from_numpy(tree, tcfg))
    jvae = JV.MicroFrameVAE(jimg, JV.CausalVAE(jcfg, tree), micro_frame_size=5)
    vae = TV.MicroFrameVAE(img, temporal, micro_frame_size=5, scale=(1.0,) * 4,
                           shift=(0.0,) * 4)
    x = _pixels((1, 10, 16, 16, 3), seed=8)
    want = _np(jax.jit(jvae.encode)(jnp.asarray(x)))
    got = vae.encode(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 6, 4, 4, 4)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    want = _np(jax.jit(jvae.decode)(jnp.asarray(got)))
    pixels = vae.decode(torch.from_numpy(got)).numpy()
    assert pixels.shape == want.shape == (1, 10, 16, 16, 3)
    np.testing.assert_allclose(pixels, want, atol=F32_TOL, rtol=F32_TOL)


# ---------------------------------------------------- Open-Sora-Plan encoder
@functools.lru_cache(maxsize=None)
def _osp_tree(layout):
    return numpy_params(JOV.init_osp_vae_params, JOV.OSPVAEConfig(**WIDTHS, **LAYOUTS[layout]),
                        seed=9)


def _osp_vaes(layout):
    kw = dict(WIDTHS, **LAYOUTS[layout])
    tcfg = TOV.OSPVAEConfig(**kw)
    vae = TOV.OSPCausalVAE(tcfg, "cpu")
    vae.load_state_dict(TC.osp_vae_params_from_numpy(_osp_tree(layout), tcfg))
    jvae = JOV.OSPCausalVAE(JOV.OSPVAEConfig(**kw), jax.tree.map(jnp.asarray, _osp_tree(layout)))
    jvae._encode_one = jax.jit(jvae._encode_one)      # one compile per tile shape
    return jvae, vae


@pytest.mark.parametrize("layout", ["v120", "v110"])
def test_osp_encode_matches_jax(layout):
    """The whole clip (v1.1's time downsample too), and on v1.2 the tiled
    path at small thresholds: two 5-frame windows (the second drops its
    first latent frame) of 64-pixel tiles (2 x 2 on 80 x 96 pixels)
    blended over one latent and cropped at 7."""
    jvae, vae = _osp_vaes(layout)
    x = _pixels((1, 9, 80, 96, 3), seed=10)
    tiled = dict(tile_sample_min_size=64, tile_sample_min_size_t=5, tile_latent_min_size=8)
    for tiles in (None, tiled) if layout == "v120" else (None,):
        for obj in (jvae, vae):
            for k, v in (tiles or {}).items():
                setattr(obj, k, v)
        jm, jl = jvae.encode(jnp.asarray(x), use_tiling=tiles is not None)
        tm, tl = vae.encode(torch.from_numpy(x), use_tiling=tiles is not None)
        assert tuple(tm.shape) == jm.shape == (1, 3, 10, 12, 4)
        for got, want in ((tm, jm), (tl, jl)):
            np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL, rtol=F32_TOL)
    if layout == "v120":
        # the thresholds pick the tiled path, which differs from the whole clip
        auto = vae.encode(torch.from_numpy(x))[0].numpy()
        np.testing.assert_array_equal(auto, tm.numpy())
        whole = vae.encode(torch.from_numpy(x), use_tiling=False)[0].numpy()
        assert np.abs(auto - whole).max() > 1e-4


# ------------------------------------------------------------ CogVideoX encoder
@pytest.mark.parametrize("name,frames", [("tiny", 5), ("tiny", 4), ("4x8x", 9)])
def test_cogvideox_encode_matches_jax(name, frames):
    """Odd and even frame counts through the frame-pair means (an odd count
    keeps frame 0 apart) and the stride-2 per-frame convs."""
    tcfg = TCV.CogVideoXVAEConfig.tiny(**COG_CONFIGS[name])
    tree = numpy_params(JCV.init_cogvideox_vae_params,
                        JCV.CogVideoXVAEConfig.tiny(**COG_CONFIGS[name]), seed=11)
    vae = TCV.CogVideoXVAE(tcfg, "cpu")
    vae.load_state_dict(TC.cogvideox_vae_params_from_numpy(tree, tcfg))
    jvae = JCV.CogVideoXVAE(JCV.CogVideoXVAEConfig.tiny(**COG_CONFIGS[name]),
                            jax.tree.map(jnp.asarray, tree))
    x = _pixels((1, frames, 32, 24, 3), seed=12)
    jm, jl = jvae.encode(jnp.asarray(x))
    tm, tl = vae.encode(torch.from_numpy(x))
    assert tuple(tm.shape) == jm.shape and jm.shape[-1] == tcfg.z_channels
    for got, want in ((tm, jm), (tl, jl)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------- the loaders' encoders
def test_loaders_carry_the_encoder_weights_bit_equal(tmp_path):
    """A published-layout checkpoint of each VAE: the loaded module's encoder
    (and the OSP quant conv) equals the JAX converter's tree bit for bit."""
    jcfg, tcfg = JOV.OSPVAEConfig.tiny(), TOV.OSPVAEConfig.tiny()
    pub = _osp_published(_random_tree(JOV.init_osp_vae_params, jcfg, 13))
    got = TOV.load_osp_vae_checkpoint(_save(tmp_path / "osp", pub), tcfg, device="cpu")
    _, jtree = JOV.load_osp_vae_checkpoint(str(tmp_path / "osp"), jcfg)
    sd = got.state_dict()
    np.testing.assert_array_equal(sd["encoder.conv_in.weight"].numpy(),
                                  _np(jtree["encoder"]["conv_in"]["w"]).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["encoder.down.0.downsample.weight"].numpy(),
                                  _np(jtree["encoder"]["down"][0]["downsample"]["w"])
                                  .transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sd["quant_conv.bias"].numpy(), _np(jtree["quant_conv"]["b"]))
    assert sum(k.startswith("encoder.") for k in sd) == len(jax.tree.leaves(jtree["encoder"]))

    jcfg, tcfg = JCV.CogVideoXVAEConfig.tiny(), TCV.CogVideoXVAEConfig.tiny()
    pub = _cogvideox_published(_random_tree(JCV.init_cogvideox_vae_params, jcfg, 14), jcfg)
    got = TCV.load_cogvideox_vae_checkpoint(_save(tmp_path / "cog", pub), tcfg, device="cpu")
    jtree = JCV.convert_cogvideox_vae_state_dict(pub, jcfg)
    sd = got.state_dict()
    np.testing.assert_array_equal(sd["encoder.down0.down.weight"].numpy(),
                                  _np(jtree["encoder"]["down0"]["down"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["encoder.mid.1.norm2.weight"].numpy(),
                                  _np(jtree["encoder"]["mid"][1]["norm2"]["w"]))
    assert sum(k.startswith("encoder.") for k in sd) == len(jax.tree.leaves(jtree["encoder"]))
