"""The port's Open-Sora-Plan CausalVAE decoder against the JAX package on
the CPU: ``group_norm`` (with its group fallback), the converter, the named
4x-time layouts, ``OSPCausalVAE.decode`` whole and tiled (a latent that
needs both the time windows and the 2-D tiles) for both layouts, and the
Open-Sora-Plan pipeline returning pixels with ``vae=``.

Both sides get the same weights (seeded numpy values in the tree of
``init_osp_vae_params``, converted by ``osp_vae_params_from_numpy``) and the
same numpy latents. The port's VAE
runs NCDHW inside and takes and returns channel-last tensors, as JAX does.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import vae as JV
from magcache_tpu.models import vae_osp as JO
from magcache_tpu_torch.models import vae as TV
from magcache_tpu_torch.models import vae_osp as TO
from magcache_tpu_torch.models.convert import osp_vae_params_from_numpy
from magcache_tpu_torch.pipelines import open_sora_plan as tpipe

# f32 on both sides: conv, interpolation and reduction order only
F32_TOL = 1e-4

# the two 4x-time, 8x-space layouts at test widths (the JAX tests'
# test_vae_osp.py:210-242)
WIDTHS = dict(hidden=8, ch_mult=(1, 1, 2, 2), num_res_blocks=1, groups=4)
LAYOUTS = {"v120": dict(down_types=("spatial", "s2t2", "s2t2", ""),
                        up_types=("", "s2t2", "s2t2", "spatial")),
           "v110": dict(down_types=("spatial", "spatial", "spatial", ""),
                        time_down_types=("", "time", "time", ""),
                        up_types=("", "spatial", "spatial", "spatial"),
                        time_up_types=("", "time", "time", ""))}
# toy tiling constants that keep the reference's identity row_limit ==
# overlap x scale (56 == 7 x 8), as the JAX tiled-decode test does
TILES = dict(tile_latent_min_size=8, tile_sample_min_size=64, tile_latent_min_size_t=3)


def numpy_params(init, cfg, seed, fan_in=lambda shape: int(np.prod(shape[:-1]))):
    """``init(key, cfg)``'s parameter tree (its structure, shapes and dtypes
    from ``jax.eval_shape``, without running the init) with seeded numpy
    values: ``w`` leaves of two or more dims ``N(0, 1/fan_in)``, 1-D ``w``
    (norm gains) near 1, ``b`` leaves small."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name, shape = path[-1].key, spec.shape
        if name == "w" and len(shape) > 1:
            v = rng.standard_normal(shape) / np.sqrt(fan_in(shape))
        elif name == "w":
            v = 1 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _tree(layout):
    """A parameter tree of a layout at test widths in the JAX layout."""
    return numpy_params(JO.init_osp_vae_params,
                        JO.OSPVAEConfig(**WIDTHS, **LAYOUTS[layout]), seed=0)


def _vaes(layout):
    kw = dict(WIDTHS, **LAYOUTS[layout])
    tree = _tree(layout)
    tcfg = TO.OSPVAEConfig(**kw)
    vae = TO.OSPCausalVAE(tcfg, "cpu")
    vae.load_state_dict(osp_vae_params_from_numpy(tree, tcfg))
    jvae = JO.OSPCausalVAE(JO.OSPVAEConfig(**kw), jax.tree.map(jnp.asarray, tree))
    jvae._decode_one = jax.jit(jvae._decode_one)     # one compile per tile shape
    return jvae, vae


def _latents(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,groups", [(12, 4), (10, 4), (12, 32)])
def test_group_norm_matches_jax(dtype, c, groups):
    """f32 statistics over each group's channels and every position; 10
    channels in 4 groups fall back to 2, 12 in 32 to 12."""
    x = _latents((2, 3, 5, 7, c)) * 3 + 1
    w, b = 1 + 0.1 * _latents((c,), 1), 0.1 * _latents((c,), 2)
    want = np.asarray(JV.group_norm(jnp.asarray(x, dtype), jnp.asarray(w), jnp.asarray(b),
                                    groups), np.float32)
    got = TV.group_norm(torch.from_numpy(np.moveaxis(x, -1, 1)).to(getattr(torch, dtype)),
                        torch.from_numpy(w), torch.from_numpy(b), groups)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 2e-2   # a bf16 ulp at |y| < 4
    np.testing.assert_allclose(np.moveaxis(got.float().numpy(), 1, -1), want, atol=tol,
                               rtol=tol)


def test_layouts_and_defaults():
    """The port's defaults are the JAX fields; the named layouts are the
    published widths with the tests' 4x block types; the JAX default
    compresses time 8x (57 frames from 8 latent frames)."""
    j = JO.OSPVAEConfig()
    for f in dataclasses.fields(j):
        assert getattr(TO.OSPVAEConfig(), f.name) == getattr(j, f.name), f.name
    assert TO.OSPVAEConfig().time_stride == 8 and 1 + 8 * 7 == 57
    for layout, cfg in (("v120", TO.OSP_V120_VAE), ("v110", TO.OSP_V110_VAE)):
        assert (cfg.time_stride, cfg.space_stride) == (4, 8)
        assert (cfg.hidden, cfg.ch_mult, cfg.num_res_blocks) == (128, (1, 2, 4, 4), 2)
        for name, types in LAYOUTS[layout].items():
            assert getattr(cfg, name) == types, (layout, name)
    for v, cfg in (("v120", TO.OSP_V120_VAE), ("v110", TO.OSP_V110_VAE)):
        assert tpipe.OpenSoraPlanPipelineConfig(version=v).vae_config() == cfg
    for t, size in ((24, 16), (17, 16), (16, 16), (5, 3), (9, 3), (2, 3), (40, 16)):
        assert TO.t_chunks(t, size) == JO._t_chunks(t, size)


@pytest.mark.parametrize("layout", ["v120", "v110"])
def test_converter_carries_the_decoder(layout):
    tree = _tree(layout)
    cfg = TO.OSPVAEConfig(**WIDTHS, **LAYOUTS[layout])
    sd = TO.OSPCausalVAE(cfg, "cpu").state_dict()
    conv = osp_vae_params_from_numpy(tree, cfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape and conv[k].dtype == torch.float32, k
    np.testing.assert_array_equal(conv["decoder.up.2.upsample.weight"].numpy(),
                                  tree["decoder"]["up"][2]["upsample"]["w"].transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("layout", ["v120", "v110"])
def test_decode_whole_matches_jax(layout):
    jvae, vae = _vaes(layout)
    z = _latents((1, 3, 4, 5, 4))
    want = np.asarray(jvae.decode(jnp.asarray(z), use_tiling=False))
    got = vae.decode(torch.from_numpy(z), use_tiling=False).numpy()
    assert got.shape == want.shape == (1, 9, 32, 40, 3)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("layout,h", [("v120", 12), ("v110", 7)])
def test_tiled_decode_matches_jax(layout, h):
    """Two 3-frame time windows (the second drops its first output frame)
    of latent tiles of up to 8 (2 x 2 of them on 12 x 10 latents, a row of
    2 on 7 x 10), blended over 8 pixels: the same tiles and seams as
    JAX's."""
    jvae, vae = _vaes(layout)
    for obj in (jvae, vae):
        for name, v in TILES.items():
            setattr(obj, name, v)
    z = _latents((1, 5, h, 10, 4), seed=2)
    want = np.asarray(jvae.decode(jnp.asarray(z)))
    got = vae.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 17, 8 * h, 80, 3)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # the tiles and windows are there: the whole decode differs at the seams
    whole = vae.decode(torch.from_numpy(z), use_tiling=False).numpy()
    assert whole.shape == got.shape and np.abs(whole - got).max() > 1e-3


@pytest.mark.parametrize("version", ["v120", "v110"])
def test_pipeline_returns_pixels(version):
    """A tiny Open-Sora-Plan request with a VAE of the version's layout:
    ``video`` has 1 + 4 (T - 1) frames at 8x the latents, is the VAE's
    decode of the latents, and ``decode_s`` is recorded; a VAE whose strides
    are not the latents' is refused."""
    base = dict(version=version, tiny=True, num_frames=9, height=32, width=32,
                num_inference_steps=3, caption_len=6, dtype="float32")
    _, vae = _vaes(version)
    pipe = tpipe.OpenSoraPlanPipeline(tpipe.OpenSoraPlanPipelineConfig(**base), "cpu",
                                      vae=vae)
    out = pipe.generate("a red boat", seed=1)
    assert out.latents.shape == (1, 3, 4, 4, 4)
    assert out.video.shape == (1, 9, 32, 32, 3) and torch.isfinite(out.video).all()
    torch.testing.assert_close(out.video, vae.decode(out.latents), rtol=0, atol=0)
    assert out.timings["decode_s"] >= 0 and out.timings["total_s"] >= out.timings["decode_s"]
    with pytest.raises(ValueError, match="strides"):
        tpipe.OpenSoraPlanPipeline(tpipe.OpenSoraPlanPipelineConfig(**base), "cpu",
                                   vae=TO.OSPCausalVAE(TO.OSPVAEConfig(), "meta"))
