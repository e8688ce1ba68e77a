"""The port's Llama encoder (``models/llama.py``) and its wrapper
``LlamaTextEncoder`` against the JAX package on the CPU: the converter, the
hidden states at skip 0 (with and without the final norm) and 2, with key
padding, with and without q/k/v biases; the wrapper's template, crop, pad
and zeroing on prompts with the same weights and hash tokenizer; the random
init and the llava-llama-3-8b size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magcache_tpu.models import llama as J
from magcache_tpu.models import text as JT
from magcache_tpu_torch.models import llama as T
from magcache_tpu_torch.models import text as TT
from magcache_tpu_torch.models.convert import llama_params_from_numpy

# f32 on both sides: GEMM and reduction order only, held against the
# largest value
F32_TOL = 1e-5
PROMPTS = ["a red fox runs through fresh snow", "", "two cats fight on a stage at night"]


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _pair(qkv_bias=False, seed=0):
    jcfg, tcfg = J.LlamaConfig.tiny(qkv_bias=qkv_bias), T.LlamaConfig.tiny(qkv_bias=qkv_bias)
    tree = jax.tree.map(np.asarray, J.init_llama_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 7)
    # the JAX init has unit gains and zero biases: give them values
    for name in ("in_norm", "post_norm"):
        tree["blocks"][name] = 1.0 + 0.1 * rng.standard_normal(tree["blocks"][name].shape)
    for name in ("q", "k", "v"):
        if qkv_bias:
            b = tree["blocks"][name]["b"]
            tree["blocks"][name]["b"] = (0.1 * rng.standard_normal(b.shape)).astype(np.float32)
    tree["final_norm"] = 1.0 + 0.1 * rng.standard_normal(tree["final_norm"].shape)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    model = T.LlamaModel(tcfg, "cpu")
    model.load_state_dict(llama_params_from_numpy(tree, tcfg, "cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), model


def _ids():
    rng = np.random.default_rng(3)
    ids = rng.integers(2, 128, (2, 10))
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0                       # right padding
    ids[1, 6:] = 0
    return ids, mask


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_converter_carries_every_parameter(qkv_bias):
    jcfg, params, model = _pair(qkv_bias)
    sd = T.LlamaModel(model.cfg, "cpu").state_dict()
    conv = llama_params_from_numpy(jax.tree.map(np.asarray, params), model.cfg)
    assert sd.keys() == conv.keys()
    assert ("blocks.0.q.bias" in sd) == qkv_bias and "blocks.0.o.bias" not in sd
    for k, v in sd.items():
        assert v.shape == conv[k].shape and v.dtype == conv[k].dtype, k
    np.testing.assert_array_equal(conv["blocks.1.gate.weight"].numpy(),
                                  np.asarray(params["blocks"]["gate"]["w"][1]).T)


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("skip,final_norm", [(0, True), (0, False), (2, False), (1, False)])
@pytest.mark.parametrize("padded", [False, True])
def test_hidden_states_match_jax(skip, final_norm, qkv_bias, padded):
    jcfg, params, model = _pair(qkv_bias)
    ids, mask = _ids()
    m = mask if padded else None
    want = J.llama_hidden_states(params, jcfg, jnp.asarray(ids),
                                 None if m is None else jnp.asarray(m),
                                 skip_layers=skip, final_norm=final_norm)
    got = T.llama_hidden_states(model, torch.from_numpy(ids),
                                None if m is None else torch.from_numpy(m),
                                skip_layers=skip, final_norm=final_norm)
    assert got.dtype == torch.float32 and got.shape == (2, 10, 32)
    _close(got.numpy(), want)
    if skip == 2:          # every block skipped: the embedding itself
        np.testing.assert_array_equal(got.numpy(), np.asarray(params["embed"])[ids])


def test_rope_is_the_half_split():
    x = torch.arange(8.0).reshape(1, 1, 1, 8)
    cos, sin = torch.zeros(1, 4), torch.ones(1, 4)      # a quarter turn
    np.testing.assert_array_equal(T.rope_llama(x, cos, sin).numpy().ravel(),
                                  [-4, -5, -6, -7, 0, 1, 2, 3])
    xs = np.random.default_rng(1).standard_normal((2, 3, 2, 8)).astype(np.float32)
    c, s = (np.random.default_rng(2).standard_normal((3, 4)).astype(np.float32) for _ in "cs")
    np.testing.assert_allclose(
        T.rope_llama(torch.from_numpy(xs), torch.from_numpy(c), torch.from_numpy(s)).numpy(),
        np.asarray(J._rope_llama(jnp.asarray(xs), jnp.asarray(c), jnp.asarray(s))),
        atol=1e-6)


@pytest.mark.parametrize("skip", [2, 0])
def test_text_encoder_matches_jax(skip):
    """The template, the crop of its prefix, zeroed padding and the fixed
    output length, on the same weights and hash tokenizer ids."""
    jcfg, params, model = _pair()
    template, crop = "<|start|> describe the video: {} <|end|>", 4
    kw = dict(out_len=6, skip_layers=skip, template=template, crop_start=crop)
    jenc = JT.LlamaTextEncoder(jcfg, tokenizer=JT.FallbackHashTokenizer(128), params=params, **kw)
    tenc = TT.LlamaTextEncoder(model.cfg, model=model, **kw)
    got, want = tenc(PROMPTS), jenc(PROMPTS)
    assert got.shape == (3, 6, 32)
    _close(got.numpy(), want)
    # the empty prompt: template words and EOS, then zeroed padding
    assert not got[1, 2:].any() and got[1, :2].abs().sum() > 0
    assert tenc.final_norm == (skip == 0) and tenc.crop_start == crop
    # no template: no crop
    plain = TT.LlamaTextEncoder(model.cfg, model=model, out_len=6, template=None)
    assert plain.crop_start == 0
    _close(plain(PROMPTS).numpy(), JT.LlamaTextEncoder(
        jcfg, out_len=6, template=None, tokenizer=JT.FallbackHashTokenizer(128),
        params=params)(PROMPTS))


def test_hyvideo_template_and_defaults():
    assert TT.HYVIDEO_PROMPT_TEMPLATE == JT.HYVIDEO_PROMPT_TEMPLATE
    assert TT.HYVIDEO_CROP_START == JT.HYVIDEO_CROP_START == 95
    enc = TT.LlamaTextEncoder(T.LlamaConfig.tiny(), out_len=5, device="cpu")
    assert (enc.skip_layers, enc.crop_start, enc.final_norm) == (2, 95, False)
    out = enc(["a fox"], device="cpu")
    # the hash tokenizer's words of the template fall inside the crop
    assert out.shape == (1, 5, 32) and not out.any()


def test_random_init_and_published_size():
    m = T.LlamaModel(T.LlamaConfig.tiny(), "cpu").init(torch.Generator().manual_seed(0))
    assert abs(float(m.embed.detach().std()) - 0.02) < 0.004
    assert (m.blocks[0].in_norm == 1).all()
    std = float(m.blocks[1].down.weight.detach().std())
    assert abs(std - 64 ** -0.5) < 0.15 * 64 ** -0.5
    big = T.LlamaModel(T.LLAVA_LLAMA3_8B, "meta")
    n = sum(p.numel() for p in big.parameters())
    # llava-llama-3-8b's LM is 8.03 B with its output head, which an
    # encoder does not have: 7.5 B, 30.0 GB in f32
    assert 7.50e9 < n < 7.51e9
    assert big.cfg.head_dim == 128 and big.blocks[0].k.weight.shape == (1024, 4096)
