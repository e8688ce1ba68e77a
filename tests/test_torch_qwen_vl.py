"""The port's Qwen2.5-VL conditioning stack against the JAX package on the
CPU: the host geometry bit for bit (rotary ids, the window partition with
its -100 padding, ``smart_resize``, the preprocessing, the patch order and
the M-RoPE ids on padded batches of two), the vision tower on a 12 x 8 grid
with window 8 (windowed and full-attention layers) and on two images, the
LM's vision splice and 3-axis M-RoPE, ``QwenVLTextEncoder`` on its image
and text-only paths, the Qwen templates, the reference's silent drop of the
vision tokens under the hash tokenizer (refused here) and the published
sizes.

Both sides get the same numpy weights: the JAX package's trees with their
unit gains and zero biases perturbed, converted by
``qwen_vl_vision_params_from_numpy`` and ``llama_params_from_numpy``. The
image path needs a tokenizer that writes the special ids; ``_VLTok`` below
splits as a byte-level BPE pre-tokenizer does, which gives the Qwen
templates' prefixes their published 34 and 64 tokens.
"""

import hashlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import llama as JL
from magcache_tpu.models import qwen_vl as JV
from magcache_tpu.models import text as JT
from magcache_tpu_torch.models import llama as TL
from magcache_tpu_torch.models import qwen_vl as TV
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models.convert import (llama_params_from_numpy,
                                               qwen_vl_vision_params_from_numpy)

# f32 on both sides: GEMM and reduction order only, held against the
# largest value
F32_TOL = 2e-5
IMAGE_ID = 150
SPECIAL = {"<|image_pad|>": IMAGE_ID, "<|vision_start|>": 148, "<|vision_end|>": 149,
           "<|im_start|>": 146, "<|im_end|>": 147}
PROMPTS = ["a red fox runs through fresh snow at dawn", "two cats on a stage"]


class _VLTok:
    """Special tokens to their ids; the other pieces (words with their
    leading space, "'s", punctuation runs, newlines) hash into [3, 140).
    Padded with 0 to ``max_length``, no EOS."""

    PIECES = re.compile(r"<\|[a-z_]+\|>| ?\w+|'s|[^\w\s]+\n?|\n")

    def __call__(self, texts, padding=None, truncation=None, max_length=64,
                 return_tensors=None):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [SPECIAL.get(p) or 3 + int.from_bytes(
                hashlib.sha256(p.encode()).digest()[:4], "little") % 137
                for p in self.PIECES.findall(t)][:max_length]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _perturbed(tree, rng):
    """The JAX init's unit gains and zero biases given values."""
    def f(path, a):
        a = np.array(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "norm" in name or "ln" in name or name.endswith("['b']"):
            return a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(f, tree)


def _tower(seed=0, **kw):
    cfg_kw = dict(kw)
    jcfg, tcfg = JV.QwenVLVisionConfig.tiny(**cfg_kw), TV.QwenVLVisionConfig.tiny(**cfg_kw)
    tree = _perturbed(JV.init_qwen_vl_vision_params(jax.random.PRNGKey(seed), jcfg),
                      np.random.default_rng(seed + 20))
    tower = TV.QwenVLVisionTower(tcfg, "cpu")
    tower.load_state_dict(qwen_vl_vision_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tower


def _lm(seed=0):
    kw = dict(vocab_size=160, hidden=24, layers=2, heads=4, kv_heads=2, intermediate=48,
              rope_theta=1e6, eps=1e-6, qkv_bias=True)
    jcfg, tcfg = JL.LlamaConfig(**kw), TL.LlamaConfig(**kw)
    tree = _perturbed(JL.init_llama_params(jax.random.PRNGKey(seed), jcfg),
                      np.random.default_rng(seed + 30))
    model = TL.LlamaModel(tcfg, "cpu")
    model.load_state_dict(llama_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), model


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("grids", [((1, 12, 8),), ((1, 4, 8), (1, 6, 4)), ((2, 8, 8),)])
def test_rotary_ids_and_window_partition_bit_equal(grids):
    cfg = TV.QwenVLVisionConfig.tiny()
    np.testing.assert_array_equal(TV.vision_rot_pos_ids(grids, 2),
                                  JV.vision_rot_pos_ids(grids, 2))
    got = TV.window_partition(grids, cfg)
    want = JV.window_partition(grids, JV.QwenVLVisionConfig.tiny())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # 12 x 8 patches: 6 x 4 merged units in windows of 2 x 2 units, no pad;
    # the published window (112 px = 4 units) pads a 9-unit side with -100
    pub = TV.window_partition(((1, 18, 32),), TV.QWEN25_VL_VISION)
    np.testing.assert_array_equal(
        pub[0], JV.window_partition(((1, 18, 32),), JV.QwenVLVisionConfig())[0])
    assert len(pub[0]) == 9 * 16 and sorted(pub[0]) == list(range(144))


@pytest.mark.parametrize("hw,budget", [((8, 8), (16, 256)), ((20, 36), (16, 400)),
                                       ((928, 1664), (3136, 125440)),
                                       ((30, 30), (3136, 1003520))])
def test_smart_resize_and_preprocess_bit_equal(hw, budget):
    for factor in (4, 28):
        assert TV.smart_resize(*hw, factor, *budget) == JV.smart_resize(*hw, factor, *budget)
    if hw[0] > 100:
        return
    cfg, jcfg = TV.QwenVLVisionConfig.tiny(), JV.QwenVLVisionConfig.tiny()
    rng = np.random.default_rng(1)
    for img in ((rng.random(hw + (3,)) * 255).astype(np.uint8),
                rng.random(hw + (3,)).astype(np.float32)):
        got, grid = TV.preprocess_qwen_vl_image(img, cfg, *budget)
        want, jgrid = JV.preprocess_qwen_vl_image(img, jcfg, *budget)
        assert grid == jgrid and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="aspect"):
        TV.smart_resize(1, 300)


def test_patchify_bit_equal():
    frames = np.random.default_rng(2).random((2, 3, 28, 56)).astype(np.float32)
    cfg = TV.QwenVLVisionConfig(patch_size=14)
    got, grid = TV.patchify_qwen_vl(frames, cfg)
    want, jgrid = JV.patchify_qwen_vl(frames, JV.QwenVLVisionConfig(patch_size=14))
    assert grid == jgrid == (1, 2, 4)
    np.testing.assert_array_equal(got, want)


def test_mrope_ids_bit_equal_on_padded_batches_of_two():
    # row 0: text, an image block, text, padding; row 1: another image (the
    # second grid: img_i runs across the rows), left text only, padding
    g0, g1 = (1, 4, 6), (1, 2, 4)
    r0 = [5, 6, 148] + [IMAGE_ID] * 6 + [149, 7, 8, 9, 0, 0]
    r1 = [5, 148] + [IMAGE_ID] * 2 + [149, 11] + [0] * 9
    r2 = [5, 148] + [IMAGE_ID] * 6 + [149, 11, 12, 0, 0, 0, 0]
    ids = np.array([r0, r1[:15]])
    mask = (ids != 0).astype(np.int64)
    for rows, grids in (((r0, r1[:15]), (g0, g1)), ((r0, r2), (g0, g0))):
        b = np.array(rows)
        for m in ((b != 0).astype(np.int64), None):
            np.testing.assert_array_equal(
                TV.mrope_position_ids(b, grids, 2, IMAGE_ID, m),
                JV.mrope_position_ids(b, grids, 2, IMAGE_ID, m))
    pos = TV.mrope_position_ids(ids, (g0, g1), 2, IMAGE_ID, mask)
    assert pos.shape == (3, 2, 15) and (pos[:, 0, -2:] == 1).all()
    # the image block's (t, h, w) grid after 3 text positions
    np.testing.assert_array_equal(pos[:, 0, 3:9], [[3] * 6, [3, 3, 3, 4, 4, 4],
                                                   [3, 4, 5, 3, 4, 5]])
    # text after it resumes past the running maximum
    np.testing.assert_array_equal(pos[:, 0, 9], [6, 6, 6])


# ---------------------------------------------------------------- the tower
def test_converter_carries_every_parameter():
    _, params, tower = _tower()
    cfg = tower.cfg
    sd = TV.QwenVLVisionTower(cfg, "cpu").state_dict()
    conv = qwen_vl_vision_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    assert sd.keys() == conv.keys()
    for k, v in sd.items():
        assert v.shape == conv[k].shape and v.dtype == conv[k].dtype, k
    np.testing.assert_array_equal(conv["blocks.3.down.weight"].numpy(),
                                  np.asarray(params["blocks"]["down"]["w"][3]).T)
    np.testing.assert_array_equal(conv["patch.weight"].numpy(), np.asarray(params["patch"]).T)
    assert "patch.bias" not in sd


@pytest.mark.parametrize("grids", [((1, 12, 8),), ((1, 4, 8), (1, 6, 4))])
def test_vision_tower_matches_jax(grids):
    """12 x 8 with window 8: windows of 2 x 2 merged units, the reorder and
    its undo, windowed layers 0 and 2, full layers 1 and 3; two images: per
    image windows and full attention that never crosses images."""
    jcfg, params, tower = _tower(seed=1)
    n = sum(t * h * w for t, h, w in grids)
    patches = np.random.default_rng(3).standard_normal((n, jcfg.patch_dim)).astype(np.float32)
    want = JV.qwen_vl_vision_forward(params, jcfg, jnp.asarray(patches), grids)
    got = tower(torch.from_numpy(patches), grids)
    assert got.dtype == torch.float32 and got.shape == (n // 4, jcfg.out_hidden)
    _close(got.numpy(), want)
    # the window mask matters: all-full attention gives other tokens
    full = TV.QwenVLVisionTower(TV.QwenVLVisionConfig.tiny(fullatt_indexes=(0, 1, 2, 3)), "cpu")
    full.load_state_dict(tower.state_dict())
    assert np.abs(full(patches, grids).numpy() - got.numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="patches"):
        tower(patches[:-4], grids)


# ---------------------------------------------------------------- the LM
def _splice_inputs():
    g = (1, 4, 6)
    ids = np.array([[5, 6, 148] + [IMAGE_ID] * 6 + [149, 7, 8, 9, 10],
                    [5, 148] + [IMAGE_ID] * 6 + [149, 12, 0, 0, 0, 0]])
    mask = (ids != 0).astype(np.int64)
    ov_mask = ids == IMAGE_ID
    ov = np.zeros(ids.shape + (24,), np.float32)
    ov[ov_mask] = np.random.default_rng(4).standard_normal((12, 24)).astype(np.float32)
    pos = JV.mrope_position_ids(ids, (g, g), 2, IMAGE_ID, mask)
    return ids, mask, ov, ov_mask, pos


@pytest.mark.parametrize("section", [(1, 1, 1), (2, 1, 0)])
def test_splice_and_mrope_hidden_states_match_jax(section):
    jcfg, params, model = _lm()
    ids, mask, ov, ov_mask, pos = _splice_inputs()
    kw = dict(final_norm=True)
    want = JL.llama_hidden_states(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                  embeds_override=jnp.asarray(ov),
                                  override_mask=jnp.asarray(ov_mask),
                                  position_ids=jnp.asarray(pos), mrope_section=section, **kw)
    got = TL.llama_hidden_states(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                 embeds_override=torch.from_numpy(ov),
                                 override_mask=torch.from_numpy(ov_mask), position_ids=pos,
                                 mrope_section=section, **kw)
    assert got.shape == (2, 14, 24)
    _close(got.numpy(), want)
    # the splice and the 3-axis ids each change the states
    plain = TL.llama_hidden_states(model, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    seq = TL.llama_hidden_states(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                 embeds_override=torch.from_numpy(ov),
                                 override_mask=torch.from_numpy(ov_mask), **kw)
    for other in (plain, seq):
        assert (other - got).abs().max() > 1e-3
    with pytest.raises(ValueError, match="mrope_section"):
        TL.llama_hidden_states(model, ids, mask, position_ids=pos, mrope_section=(1, 1))


def test_rope_takes_per_row_tables():
    x = torch.randn(2, 3, 2, 8)
    c, s = torch.randn(2, 3, 4), torch.randn(2, 3, 4)
    got = TL.rope_llama(x, c, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(JL._rope_llama(
        jnp.asarray(x.numpy()), jnp.asarray(c.numpy()), jnp.asarray(s.numpy()))), atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), TL.rope_llama(x[1:], c[1], s[1])[0].numpy())


# ---------------------------------------------------------------- the encoder
def _encoders(out_len=40, **kw):
    jcfg, params, model = _lm()
    vjcfg, vparams, tower = _tower(seed=2, out_hidden=24)
    common = dict(out_len=out_len, tokenizer=_VLTok(), mrope_section=(1, 1, 1),
                  image_token_id=IMAGE_ID, min_pixels=16, max_pixels=400, **kw)
    jenc = JT.QwenVLTextEncoder(jcfg, params=params, vision_params=vparams,
                                vision_cfg=vjcfg, **common)
    tenc = TT.QwenVLTextEncoder(model.cfg, model=model, vision_model=tower, **common)
    return jenc, tenc


@pytest.mark.parametrize("with_image", [True, False])
def test_qwen_vl_text_encoder_matches_jax(with_image):
    jenc, tenc = _encoders()
    img = np.random.default_rng(5).random((20, 36, 3)).astype(np.float32)
    for enc in (jenc, tenc):
        enc.set_image(img if with_image else None)
    want, got = jenc(PROMPTS), tenc(PROMPTS, device="cpu")
    assert got.shape == (2, 40, 24) and got.dtype == torch.float32
    _close(got.numpy(), want)
    if with_image:
        # 12 x 24 px: 6 x 12 patches, 18 merged tokens right after the crop
        # (the vision start token ends the 64-token prefix)
        assert got[:, 1:19].abs().sum() > 0
        assert not torch.equal(got, tenc.set_image(None)(PROMPTS))
    else:
        # the text-only stack is Qwen-Image's LlamaTextEncoder
        llama = TT.LlamaTextEncoder(tenc.cfg, out_len=40, skip_layers=0,
                                    template=TT.QWEN_IMAGE_PROMPT_TEMPLATE,
                                    crop_start=TT.QWEN_IMAGE_CROP_START,
                                    tokenizer=_VLTok(), model=tenc.model)
        np.testing.assert_array_equal(llama(PROMPTS).numpy(), got.numpy())


def test_templates_and_their_token_counts():
    assert TT.QWEN_IMAGE_PROMPT_TEMPLATE == JT.QWEN_IMAGE_PROMPT_TEMPLATE
    assert TT.QWEN_IMAGE_EDIT_PROMPT_TEMPLATE == JT.QWEN_IMAGE_EDIT_PROMPT_TEMPLATE
    assert (TT.QWEN_IMAGE_CROP_START, TT.QWEN_IMAGE_EDIT_CROP_START) == (
        JT.QWEN_IMAGE_CROP_START, JT.QWEN_IMAGE_EDIT_CROP_START) == (34, 64)
    for template, crop in ((TT.QWEN_IMAGE_PROMPT_TEMPLATE, 34),
                           (TT.QWEN_IMAGE_EDIT_PROMPT_TEMPLATE.split("<|vision_start|>")[0]
                            + "{}", 64)):
        assert len(_VLTok.PIECES.findall(template.split("{}")[0])) == crop


def test_encoder_refusals_match_jax():
    img = np.random.default_rng(6).random((20, 36, 3)).astype(np.float32)
    # a literal pad in the prompt is refused; so is an image cut by out_len
    for out_len, prompts, match in ((40, ["<|image_pad|> " * 3 + "a fox"], "reserved"),
                                    (4, PROMPTS, "fit in txt_len")):
        for enc in _encoders(out_len=out_len):
            with pytest.raises(ValueError, match=match):
                enc.set_image(img)(prompts)


def test_jax_drops_the_image_under_the_hash_tokenizer_the_port_refuses():
    """The hash tokenizer splits on whitespace: the expanded pads are glued
    into one word that never hashes to the image id, so the JAX encoder's
    splice mask is empty, its checks let a count of 0 pass and the vision
    tokens are dropped: two different images give the same states. The port
    raises ``ValueError`` instead."""
    jenc, tenc = _encoders()
    rng = np.random.default_rng(7)
    a, b = (rng.random((20, 36, 3)).astype(np.float32) for _ in "ab")
    jenc.tokenizer = JT.FallbackHashTokenizer(160)
    np.testing.assert_array_equal(np.asarray(jenc.set_image(a)(PROMPTS)),
                                  np.asarray(jenc.set_image(b)(PROMPTS)))
    tenc.tokenizer = TT.FallbackHashTokenizer(160)
    with pytest.raises(ValueError, match="no image token"):
        tenc.set_image(a)(PROMPTS)
    # the default tokenizer is the hash one: the text path runs, an image raises
    enc = TT.QwenVLTextEncoder(TL.LlamaConfig.tiny(qkv_bias=True), out_len=4,
                               mrope_section=(1, 1, 2), device="cpu")
    assert enc(["a fox"]).shape == (1, 4, 32)
    with pytest.raises(ValueError, match="no image token"):
        enc.set_image(a)(["a fox"])


def test_published_sizes():
    lm = TL.LlamaModel(TL.QWEN25_VL_7B, "meta")
    n = sum(p.numel() for p in lm.parameters())
    # Qwen2.5-VL-7B's text tower without its output head: 7.07 B, 28.3 GB f32
    assert 7.06e9 < n < 7.08e9
    assert lm.cfg.head_dim == 128 and lm.blocks[0].k.bias.shape == (512,)
    assert sum(TL.QWEN25_VL_MROPE_SECTION) == 64
    tower = TV.QwenVLVisionTower(TV.QWEN25_VL_VISION, "meta")
    n = sum(p.numel() for p in tower.parameters())
    assert 0.66e9 < n < 0.68e9
    assert TV.QWEN25_VL_VISION.patch_dim == 1176
    assert dict(vars(TV.QWEN25_VL_VISION)) == dict(vars(JV.QwenVLVisionConfig()))
