"""The port's CLIP vision tower (Wan i2v's image encoder) against the JAX
package's on the CPU: ``clip_vision_forward`` in f32 on the same weights
(``init_clip_vision_params`` through ``clip_vision_params_from_numpy``),
at 17 tokens (the einsum attention) and 145 tokens (K1's plain version),
penultimate and full depth; the converter's layout; the bicubic resize
against ``jax.image.resize``; and ``preprocess_clip_image``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import clip as JC
from magcache_tpu_torch.models import clip as TC
from magcache_tpu_torch.models.convert import clip_vision_params_from_numpy
from magcache_tpu_torch.utils.misc import resize_bicubic

# f32 on both sides: GEMM and reduction order only (measured ~3e-6 at
# |state| < 10)
TOL = 1e-5
# the resize: the same cubic weights, summed in another order
RESIZE_TOL = 5e-5

SIZES = {"17 tokens": dict(), "145 tokens": dict(image_size=96, patch=8)}


def _towers(cfg_kw, seed=0, dtype="float32"):
    jcfg = JC.CLIPVisionConfig.tiny(**cfg_kw)
    params = JC.init_clip_vision_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = TC.CLIPVisionConfig.tiny(dtype=dtype, **cfg_kw)
    model = TC.CLIPVisionModel(tcfg, "cpu")
    model.load_state_dict(clip_vision_params_from_numpy(jax.tree.map(np.asarray, params), tcfg))
    return (jcfg, params), model


def _image(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("penultimate", [True, False])
@pytest.mark.parametrize("size", list(SIZES))
def test_vision_forward_matches_jax(size, penultimate):
    (jcfg, params), model = _towers(SIZES[size], seed=1)
    jcfg = dataclasses.replace(jcfg, use_penultimate=penultimate)
    model.cfg = dataclasses.replace(model.cfg, use_penultimate=penultimate)
    img = (_image((2, jcfg.image_size, jcfg.image_size, 3), 2) - 0.5) * 4
    want = np.asarray(JC.clip_vision_forward(params, jcfg, jnp.asarray(img)))
    got = TC.clip_vision_forward(model, torch.from_numpy(img))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, jcfg.tokens, jcfg.dim)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_penultimate_skips_the_last_block_and_the_post_norm():
    _, model = _towers({}, seed=3)
    img = torch.from_numpy(_image((1, 32, 32, 3), 4))
    pen = TC.clip_vision_forward(model, img)
    assert torch.equal(TC.clip_vision_forward(model, img), pen)     # deterministic
    # the post-norm's weights are unit: the full output is the last block's
    # states normed, which the penultimate output is not
    model.cfg = dataclasses.replace(model.cfg, use_penultimate=False)
    full = TC.clip_vision_forward(model, img)
    assert (full - pen).abs().max() > 1e-3
    torch.testing.assert_close(full.mean(-1), torch.zeros(full.shape[:2]), atol=1e-5, rtol=0)


def test_converter_layout_and_dtypes():
    cfg = TC.CLIPVisionConfig.tiny(dtype="bfloat16")
    params = JC.init_clip_vision_params(jax.random.PRNGKey(0), JC.CLIPVisionConfig.tiny())
    sd = clip_vision_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    want = TC.CLIPVisionModel(cfg, "cpu").state_dict()
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert sd[k].shape == v.shape and sd[k].dtype == v.dtype, k
    assert want["blocks.0.qkv.weight"].dtype == torch.bfloat16
    for k in ("cls", "pos", "pre_norm.weight", "blocks.1.norm2.bias", "post_norm.bias"):
        assert want[k].dtype == torch.float32, k
    # [d_in, d_out] -> nn.Linear's [d_out, d_in]
    np.testing.assert_array_equal(
        sd["blocks.1.mlp1.weight"].float().numpy(),
        np.asarray(params["blocks"]["mlp1"]["w"][1]).T.astype(jnp.bfloat16).astype(np.float32))
    m = TC.CLIPVisionModel(TC.CLIP_VIT_H, "meta")
    assert TC.CLIP_VIT_H.tokens == 257 and TC.CLIP_VIT_H.dim // TC.CLIP_VIT_H.heads == 80
    assert 0.6e9 < sum(p.numel() for p in m.parameters()) < 0.65e9     # ViT-H/14


def test_init_draws_the_jax_distributions():
    cfg = TC.CLIPVisionConfig.tiny(dim=64, image_size=64)
    m = TC.CLIPVisionModel(cfg, "cpu").init(torch.Generator().manual_seed(0)).requires_grad_(False)
    assert abs(float(m.pos.std()) - 0.02) < 3e-3
    assert abs(float(m.blocks[0].mlp1.weight.std()) - 64 ** -0.5) < 0.02
    assert float(m.blocks[0].qkv.bias.abs().max()) == 0.0
    assert torch.equal(m.blocks[1].norm1.weight, torch.ones(64))


@pytest.mark.parametrize("src,dst", [((300, 500), (224, 224)),     # down
                                     ((40, 52), (480, 832)),       # up
                                     ((64, 64), (32, 96))])        # down one axis, up the other
def test_resize_matches_jax_bicubic(src, dst):
    img = _image((2,) + src + (3,), 5)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2,) + dst + (3,), method="bicubic"))
    got = resize_bicubic(torch.from_numpy(img), dst)
    assert tuple(got.shape) == (2,) + dst + (3,)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_TOL, rtol=0)
    # PyTorch's default (a = -0.75, no antialiasing) is not that resize
    plain = torch.nn.functional.interpolate(torch.from_numpy(img).permute(0, 3, 1, 2), dst,
                                            mode="bicubic", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 10 * RESIZE_TOL


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_matches_jax(kind):
    img = _image((40, 52, 3), 6)
    if kind == "uint8":
        img = (img * 255).astype(np.uint8)
    for cfg_kw in SIZES.values():
        jcfg, tcfg = JC.CLIPVisionConfig.tiny(**cfg_kw), TC.CLIPVisionConfig.tiny(**cfg_kw)
        want = np.asarray(JC.preprocess_clip_image(img, jcfg))
        got = TC.preprocess_clip_image(img, tcfg)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_TOL / 0.26, rtol=0)
    np.testing.assert_array_equal(np.asarray(TC.CLIP_IMAGE_MEAN, np.float32), JC.CLIP_IMAGE_MEAN)
    np.testing.assert_array_equal(np.asarray(TC.CLIP_IMAGE_STD, np.float32), JC.CLIP_IMAGE_STD)
