"""The port's SD VAE (``models/vae_sd.py``) against the JAX package on the
CPU: the presets, the converter, ``encode`` (mean and logvar, with and
without the quant convs), ``decode``, ``decode_tiled``, ``to_latent`` /
``from_latent``, the video decode (frame by frame, in chunks), the FLUX,
Latte and Vchitect pipelines returning pixels with ``vae=``, and Kontext's
conditioning image (``image_to_grid_latent``) with and without a VAE.

Both sides get the same weights (seeded numpy values in the tree of
``init_sd_vae_params``, converted by ``sd_vae_params_from_numpy``) and the
same numpy inputs. Departure from the JAX pipelines, stated: they decode the
sampler's latents as they are, and the Latte and Vchitect ones hand 5-D
latents to the 2-D decode; the port's pipelines apply ``from_latent`` (the
VAE's shift and scale) and decode frame by frame, so the JAX side here gets
``from_latent`` and the frame loop by hand.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.cli import generate as jcli
from magcache_tpu.models.flux import unpack_latents as j_unpack
from magcache_tpu.models import vae_sd as JS
from magcache_tpu_torch.models import vae_sd as TS
from magcache_tpu_torch.models.convert import sd_vae_params_from_numpy
from magcache_tpu_torch.models.flux import FluxConfig, pack_latents
from magcache_tpu_torch.models.latte import LatteConfig
from magcache_tpu_torch.models.stdit3 import STDiT3Config
from magcache_tpu_torch.models.vchitect import VchitectConfig
from magcache_tpu_torch.pipelines import flux as tflux
from magcache_tpu_torch.pipelines import latte as tlatte
from magcache_tpu_torch.pipelines import vchitect as tvch
from tests.test_torch_vae_osp import numpy_params

# the JAX SD-VAE tests' tolerance (tests/test_vae_sd.py): f32 conv order only
TOL = 2e-4
# 8x in space (the pipelines' stride) at test widths
STRIDE8 = dict(base=8, ch_mult=(1, 1, 2, 2), blocks_per_level=1, groups=4)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@functools.lru_cache(maxsize=None)
def _vaes(cfg: TS.SDVAEConfig, seed: int = 0):
    """``(jax SDVAE with jitted encode/decode, port SDVAE)`` on the same
    seeded weights."""
    jcfg = JS.SDVAEConfig(**_fields(cfg))
    tree = numpy_params(JS.init_sd_vae_params, jcfg, seed=seed)
    vae = TS.SDVAE(cfg, "cpu", micro_batch=2)
    vae.load_state_dict(sd_vae_params_from_numpy(tree, cfg))
    jvae = JS.SDVAE(jcfg, jax.tree.map(jnp.asarray, tree))
    jvae.encode, jvae.decode = jax.jit(jvae.encode), jax.jit(jvae.decode)
    return jvae, vae


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_presets_and_defaults():
    """The port's fields and tiny() are the JAX ones; each preset is the
    default geometry with its published channels, quant convs and scales,
    and its channels fit the trunk it decodes for."""
    assert _fields(TS.SDVAEConfig()) == _fields(JS.SDVAEConfig())
    assert _fields(TS.SDVAEConfig.tiny()) == _fields(JS.SDVAEConfig.tiny())
    geometry = ("in_channels", "base", "ch_mult", "blocks_per_level", "groups")
    table = {TS.FLUX_VAE: (16, False, 0.3611, 0.1159),
             TS.SD_VAE_FT: (4, True, 0.18215, 0.0),
             TS.SD3_VAE: (16, False, 1.5305, 0.0609),
             TS.OPEN_SORA_SPATIAL_VAE: (4, True, 0.18215, 0.0)}
    for cfg, want in table.items():
        assert (cfg.z_channels, cfg.quant_conv, cfg.scaling_factor, cfg.shift_factor) == want
        assert all(getattr(cfg, f) == getattr(TS.SDVAEConfig(), f) for f in geometry)
        assert cfg.spatial_down == 8
    assert TS.FLUX_VAE.shift_factor == JS.SDVAEConfig(shift_factor=0.1159).shift_factor
    assert 4 * TS.FLUX_VAE.z_channels == FluxConfig().in_channels
    assert TS.SD_VAE_FT.z_channels == LatteConfig().in_channels
    assert TS.SD3_VAE.z_channels == VchitectConfig().in_channels
    assert TS.OPEN_SORA_SPATIAL_VAE.z_channels == STDiT3Config().in_channels


@pytest.mark.parametrize("quant", [True, False])
def test_converter_carries_every_weight(quant):
    """Every JAX leaf lands on a port parameter of the same count, under
    diffusers' names; convs are OIHW, the attention linears as they are."""
    cfg = TS.SDVAEConfig.tiny(quant_conv=quant)
    tree = numpy_params(JS.init_sd_vae_params, JS.SDVAEConfig(**_fields(cfg)), seed=1)
    sd = TS.SDVAE(cfg, "cpu").state_dict()
    conv = sd_vae_params_from_numpy(tree, cfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape and conv[k].dtype == torch.float32, k
    assert sum(v.numel() for v in conv.values()) == sum(
        np.size(leaf) for leaf in jax.tree.leaves(tree))
    assert ("quant_conv.weight" in sd) == quant
    np.testing.assert_array_equal(
        conv["decoder.up_blocks.0.upsamplers.0.conv.weight"].numpy(),
        tree["decoder"]["level0"]["up"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv["encoder.mid_block.attentions.0.to_out.0.weight"].numpy(),
                                  tree["encoder"]["mid"]["attn"]["o"]["w"])
    np.testing.assert_array_equal(
        conv["encoder.down_blocks.1.resnets.0.conv_shortcut.weight"].numpy(),
        tree["encoder"]["level1"]["res"][0]["shortcut"]["w"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("quant", [True, False])
def test_encode_and_decode_match_jax(quant):
    """``encode`` (mean and logvar: the right/bottom pad before each stride-2
    conv, the optional quant conv) and ``decode`` (the optional post-quant
    conv, nearest 2x and a conv a level) on odd and even sizes."""
    jvae, vae = _vaes(TS.SDVAEConfig.tiny(quant_conv=quant))
    x = _x((3, 16, 10, 3))
    jm, jl = jvae.encode(jnp.asarray(x))
    tm, tl = vae.encode(torch.from_numpy(x))
    assert tm.shape == jm.shape == (3, 8, 5, 4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    z = _x((3, 4, 5, 4), 1)
    want = np.asarray(jvae.decode(jnp.asarray(z)))
    got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (3, 8, 10, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_tiled_matches_jax():
    """Tiles of 6 latents stepping 4 on a 10 x 12 latent (3 x 3 tiles, the
    last ones 2 latents wide), blended over 4 pixels: JAX's weights and
    seams; a latent of one tile decodes whole."""
    jvae, vae = _vaes(TS.SDVAEConfig.tiny())
    z = _x((1, 10, 12, 4), 2)
    want = np.asarray(JS.SDVAE.decode_tiled(jvae, jnp.asarray(z), tile=6, overlap=2))
    got = vae.decode_tiled(torch.from_numpy(z), tile=6, overlap=2).numpy()
    assert got.shape == want.shape == (1, 20, 24, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    whole = vae.decode(torch.from_numpy(z)).numpy()
    assert np.abs(whole - got).max() > 1e-3          # the seams are there
    small = torch.from_numpy(z[:, :6, :6])
    torch.testing.assert_close(vae.decode_tiled(small, tile=6), vae.decode(small),
                               rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["FLUX_VAE", "SD_VAE_FT", "SD3_VAE"])
def test_latent_round_trip(preset):
    """``to_latent`` and ``from_latent`` are JAX's maps and undo each other."""
    cfg = getattr(TS, preset)
    jvae = JS.SDVAE(JS.SDVAEConfig(**_fields(cfg)), None)
    vae = TS.SDVAE(cfg, "meta")                 # the maps read only the config
    m = _x((2, 3, 4, cfg.z_channels), 3)
    z = vae.to_latent(torch.from_numpy(m))
    np.testing.assert_allclose(z.numpy(), np.asarray(jvae.to_latent(jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(vae.from_latent(z).numpy(), m, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        vae.from_latent(z).numpy(), np.asarray(jvae.from_latent(jvae.to_latent(jnp.asarray(m)))),
        rtol=1e-6, atol=1e-6)


def test_video_decode_is_jax_per_frame():
    """Video latents ``[B, T, h, w, z]`` decode as JAX's decode of each
    frame, whatever the chunk of frames (GroupNorm is per sample)."""
    jvae, vae = _vaes(TS.SDVAEConfig.tiny())
    z = _x((2, 5, 4, 3, 4), 4)
    want = np.stack([np.asarray(jvae.decode(jnp.asarray(z[:, t]))) for t in range(5)], axis=1)
    for mb in (1, 3, 10):
        vae.micro_batch = mb
        got = vae.decode(torch.from_numpy(z)).numpy()
        assert got.shape == want.shape == (2, 5, 8, 6, 3)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    vae.micro_batch = 2


# ---------------------------------------------------------------- pipelines
def _pipeline_vae(**kw):
    return _vaes(TS.SDVAEConfig(**STRIDE8, **kw))


def _jax_pixels(jvae, latents: np.ndarray) -> np.ndarray:
    """The departure applied by hand: JAX's ``from_latent``, then its 2-D
    decode of each frame."""
    z = jvae.from_latent(jnp.asarray(latents))
    if z.ndim == 4:
        return np.asarray(jvae.decode(z))
    return np.stack([np.asarray(jvae.decode(z[:, t])) for t in range(z.shape[1])], axis=1)


def _check_pixels(out, shape):
    pixels = out.image if out.video is None else out.video
    assert pixels.shape == shape and torch.isfinite(pixels).all()
    assert out.timings["total_s"] >= out.timings["decode_s"] >= 0
    return pixels


def test_flux_pipeline_returns_pixels():
    """FLUX t2i at 64 x 64: the packed latents unpack to 8 x 8 x 4 (the tiny
    model's 16 channels), ``image`` is JAX's decode of ``from_latent``;
    Kontext with a conditioning image encoded by the same VAE; a VAE of
    other channels is refused."""
    jvae, vae = _pipeline_vae(z_channels=4, quant_conv=False, scaling_factor=0.3611,
                              shift_factor=0.1159)
    cfg = tflux.FluxPipelineConfig(tiny=True, height=64, width=64, num_inference_steps=3,
                                   txt_len=8, dtype="float32")
    pipe = tflux.FluxPipeline(cfg, "cpu", vae=vae)
    out = pipe.generate("a fox", seed=1)
    image = _check_pixels(out, (1, 64, 64, 3))
    lat = np.asarray(j_unpack(jnp.asarray(out.latents.numpy()), 4, 4))
    np.testing.assert_allclose(image.numpy(), _jax_pixels(jvae, lat), rtol=TOL, atol=TOL)
    kontext = tflux.FluxPipeline(dataclasses.replace(cfg, model="flux-kontext-dev"), "cpu",
                                 vae=vae)
    img = np.random.default_rng(5).uniform(size=(64, 64, 3)).astype(np.float32)
    cond = kontext.encode_image(img)
    assert cond.shape == (1, 16, 16)
    out = kontext.generate("a fox", seed=1, cond_latents=cond)
    _check_pixels(out, (1, 64, 64, 3))
    with pytest.raises(ValueError, match="do not fit"):
        tflux.FluxPipeline(cfg, "cpu", vae=TS.SDVAE(TS.FLUX_VAE, "meta"))


@pytest.mark.parametrize("family", ["latte", "vchitect"])
def test_video_pipeline_returns_pixels(family):
    """Latte (4 channels, the sd-vae-ft scale) and Vchitect (16 channels, the
    SD3 shift and scale) at 4 frames of 32 x 32: ``video`` is JAX's decode of
    each frame of ``from_latent``; a VAE of other channels or stride is
    refused."""
    if family == "latte":
        mod, z = tlatte, 4
        jvae, vae = _pipeline_vae(z_channels=4)
        cfg = tlatte.LattePipelineConfig(tiny=True, num_frames=4, height=32, width=32,
                                         num_sampling_steps=3, caption_len=6)
        make = tlatte.LattePipeline
    else:
        mod, z = tvch, 16
        jvae, vae = _pipeline_vae(z_channels=16, quant_conv=False, scaling_factor=1.5305,
                                  shift_factor=0.0609)
        cfg = tvch.VchitectPipelineConfig(tiny=True, num_frames=4, height=32, width=32,
                                          num_inference_steps=3, txt_len=6)
        make = tvch.VchitectPipeline
    out = make(cfg, "cpu", vae=vae).generate("a boat", seed=2)
    assert out.latents.shape == (1, 4, 4, 4, z)
    video = _check_pixels(out, (1, 4, 32, 32, 3))
    np.testing.assert_allclose(video.numpy(), _jax_pixels(jvae, out.latents.numpy()),
                               rtol=TOL, atol=TOL)
    assert mod.VAE_SPATIAL_STRIDE == 8
    for bad in (TS.SDVAEConfig.tiny(z_channels=z), TS.SDVAEConfig(z_channels=20 - z)):
        with pytest.raises(ValueError, match="do not fit"):
            make(cfg, "cpu", vae=TS.SDVAE(bad, "meta"))


# ---------------------------------------------------------------- Kontext image
@pytest.mark.parametrize("with_vae", [True, False])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_kontext_image_to_grid_latent_matches_jax(with_vae, hw):
    """The conditioning latent of an image in [0, 1] equals the JAX CLI's
    ``_image_to_grid_latent``: with a VAE the encode's mean through
    ``to_latent`` (nearest-resized where the grid differs), without one the
    nearest resize and channel tile; ``encode_image`` packs it 2x2."""
    jvae, vae = _pipeline_vae(z_channels=4, quant_conv=False, scaling_factor=0.3611,
                              shift_factor=0.1159)
    img = np.random.default_rng(6).uniform(size=hw + (3,)).astype(np.float32)
    want = jcli._image_to_grid_latent(types.SimpleNamespace(vae=jvae if with_vae else None),
                                      img, 8, 8, 4)
    got = tflux.image_to_grid_latent(vae if with_vae else None, img, 8, 8, 4)
    assert got.shape == want.shape == (8, 8, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    cfg = tflux.FluxPipelineConfig(model="flux-kontext-dev", tiny=True, height=64, width=64,
                                   txt_len=8, dtype="float32")
    pipe = tflux.FluxPipeline(cfg, "cpu", vae=vae if with_vae else None)
    torch.testing.assert_close(pipe.encode_image(img),
                               pack_latents(torch.from_numpy(np.asarray(got))[None]),
                               rtol=0, atol=0)
    if with_vae:
        with pytest.raises(ValueError, match="latent channels"):
            tflux.image_to_grid_latent(vae, img, 8, 8, 16)


def test_load_image_reads_npy_and_png(tmp_path):
    """``.npy`` arrays load without PIL (uint8 scaled to [0, 1]); image files
    through PIL, as the JAX CLI's ``_load_image``."""
    from PIL import Image

    arr = np.random.default_rng(7).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    np.save(tmp_path / "img.npy", arr)
    Image.fromarray(arr).save(tmp_path / "img.png")
    for name in ("img.npy", "img.png"):
        got = tflux.load_image(str(tmp_path / name))
        np.testing.assert_array_equal(got, jcli._load_image(str(tmp_path / name)))
        assert got.dtype == np.float32 and got.max() <= 1.0
